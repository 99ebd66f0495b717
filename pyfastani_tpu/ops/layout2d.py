"""Flattened-1D primitives expressed on a ``(rows, 128)`` layout.

Everything that streams over genome-length axes uses a 2-D
``(R, LANES)`` array whose row-major flattening is the logical sequence,
so scans and shifts vectorize across rows and only short row-carry
passes stay 1-D.

These helpers implement logical-1D operations on that layout:

* `shift_up` / `shift_down`: ``out.flat[i] = a.flat[i +/- d]`` with a fill
  value past the boundary -- two static slices + concats per axis, which
  XLA fuses into the surrounding elementwise work;
* `prefix_scan`: inclusive Hillis-Steele scan over the flattened order for
  any associative elementwise combiner (log2(N) shift+combine rounds).

All functions take the array namespace ``xp`` (``numpy`` or ``jax.numpy``)
so the host engine and unit tests can run them eagerly.
"""

from __future__ import annotations

__all__ = ["LANES", "shift_up", "shift_down", "prefix_scan", "pad_to_lanes"]

LANES = 128


def pad_to_lanes(n: int, lanes: int = LANES) -> int:
    """Round ``n`` up to a multiple of ``lanes``."""
    return -(-n // lanes) * lanes


def shift_up(xp, a, d: int, fill):
    """Flattened left shift: ``out.flat[i] = a.flat[i + d]`` (``fill`` past end)."""
    if d == 0:
        return a
    R, C = a.shape
    rs, cs = divmod(d, C)
    if rs:
        if rs >= R:
            return xp.full((R, C), fill, a.dtype)
        a = xp.concatenate([a[rs:], xp.full((rs, C), fill, a.dtype)], axis=0)
    if cs:
        nxt = xp.concatenate([a[1:], xp.full((1, C), fill, a.dtype)], axis=0)
        a = xp.concatenate([a[:, cs:], nxt[:, :cs]], axis=1)
    return a


def shift_down(xp, a, d: int, fill):
    """Flattened right shift: ``out.flat[i] = a.flat[i - d]`` (``fill`` before 0)."""
    if d == 0:
        return a
    R, C = a.shape
    rs, cs = divmod(d, C)
    if rs:
        if rs >= R:
            return xp.full((R, C), fill, a.dtype)
        a = xp.concatenate([xp.full((rs, C), fill, a.dtype), a[:-rs]], axis=0)
    if cs:
        prv = xp.concatenate([xp.full((1, C), fill, a.dtype), a[:-1]], axis=0)
        a = xp.concatenate([prv[:, C - cs :], a[:, : C - cs]], axis=1)
    return a


def _shift_cols(xp, a, t: int, fill):
    """Within-row right shift (no cross-row wrap)."""
    R, C = a.shape
    if t >= C:
        return xp.full((R, C), fill, a.dtype)
    return xp.concatenate(
        [xp.full((R, t), fill, a.dtype), a[:, : C - t]], axis=1
    )


def prefix_scan(xp, combine, arrays, identities):
    """Inclusive prefix scan over the flattened order.

    Hierarchical: an in-row Hillis-Steele scan (log2(C) shifted passes over
    the full array), a tiny scan over the R row aggregates (as a (1, R) row
    vector), and one broadcast combine -- ~3x less memory traffic than
    scanning the flattened order directly.

    Args:
        combine: ``combine(earlier, current) -> tuple`` -- an associative
            elementwise combiner over tuples of arrays (must support
            broadcasting), where ``earlier`` aggregates strictly preceding
            elements.
        arrays: tuple of same-shape ``(R, C)`` arrays (the scan state).
        identities: per-array identity value used past the array start.

    Returns:
        Tuple of arrays: ``out.flat[i] = arrays.flat[0] ⊕ ... ⊕ arrays.flat[i]``.
    """
    R, C = arrays[0].shape

    # 1. inclusive scan within each row
    t = 1
    while t < C:
        shifted = tuple(
            _shift_cols(xp, a, t, idv) for a, idv in zip(arrays, identities)
        )
        arrays = combine(shifted, arrays)
        t *= 2

    if R == 1:
        return arrays

    # 2. exclusive scan over the R row aggregates, refolded to (R2/128, 128)
    # tiles (a (1, R) row vector would be a long 1-D pass) -- flat
    # log-doubling there is cheap
    R2 = pad_to_lanes(R)
    rows2 = R2 // LANES

    def refold(a, idv):
        s = a[:, -1]
        if R2 != R:
            s = xp.concatenate([s, xp.full((R2 - R,), idv, a.dtype)])
        return s.reshape(rows2, LANES)

    summ = tuple(refold(a, idv) for a, idv in zip(arrays, identities))
    t = 1
    while t < R2:
        shifted = tuple(
            shift_down(xp, s, t, idv) for s, idv in zip(summ, identities)
        )
        summ = combine(shifted, summ)
        t *= 2
    prefix = tuple(
        shift_down(xp, s, 1, idv).reshape(R2)[:R].reshape(R, 1)
        for s, idv in zip(summ, identities)
    )

    # 3. fold each row's exclusive prefix into its in-row scan
    return combine(prefix, arrays)
