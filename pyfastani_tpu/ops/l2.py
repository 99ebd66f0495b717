"""Batched L2 stage: sliding union-sketch intersection as an event scan.

The reference evaluates, for each L1 candidate region, the shared-sketch
count at every window offset with an ordered-map sliding intersection
([reconstructed] ``slidingMap.hpp`` / ``computeL2MappedRegions``, declared
at ``include/fastani/map/compute_map.pxd:30-51``); the effective count is
``|Sq ∩ window|`` (containment -- see the note in
``_engine_np._l2_shared_curve``, forced by the exact-100.0 self-query
goldens).  Pointer-chasing over a ``std::map`` has no array analogue.

Formulation here: *presence intervals evaluated at record anchors*.  A
ref minimizer occurrence ``p`` whose hash is in the query sketch makes
that hash present in every window offset ``c ∈ [p - cmw + 1, p]``.
Distinctness (a hash occurring several times in one window counts once)
is handled by clipping each occurrence's interval at the previous
same-hash occurrence:

    start_j = max(p_j - cmw + 1, p_{j-1, same hash} + 1)

which makes per-hash intervals disjoint while preserving their union.
The reference slides one ``searchIndex`` iterator at a time, so the only
window offsets that matter are the *record positions* themselves -- and
the shared count at anchor ``a`` is a pure interval-stabbing count:

    shared(a) = #{j : start_j <= a} - #{j : p_j < a}

two vectorized binary searches over the sorted starts / sorted ends of a
chunk's presence intervals.  O(R log R) per chunk, no scatter, no
(B, cmax) difference-array buffer: the anchor count (~2·span/(w+1)) is
far below the offset count (span).  This is the portable path and the
reference of the GPU kernel (`ops.l2_pallas`), which drops the sort by
precomputing each record's previous same-hash occurrence.

Outputs are integers only -- identity and gate math happen on the host in
one shared float32 code path, so host and device engines agree bitwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconfig import configure as _configure_jax

_configure_jax()

__all__ = ["l2_chunk_scan", "l2_event_curve"]

# numpy scalars: plain constants in every trace (a module-level jnp array
# would be a device buffer created at import)
_UMAX = np.uint32(0xFFFFFFFF)
_BIG = np.int32(2**30)
_SLAB = 64  # chunks processed per inner step to bound memory


def _row_searchsorted(sorted_rows, keys, side: str):
    """Per-row vectorized binary search: ``sorted_rows`` (B, N) ascending,
    ``keys`` (B, K) -> (B, K) insertion points (``side`` as in numpy)."""
    B, N = sorted_rows.shape
    lo = jnp.zeros(keys.shape, jnp.int32)
    hi = jnp.full(keys.shape, N, jnp.int32)
    for _ in range(max(1, N.bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        v = jnp.take_along_axis(sorted_rows, jnp.clip(mid, 0, N - 1), axis=1)
        go_right = (v <= keys) if side == "right" else (v < keys)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def l2_event_curve(q, s, rh, rp, valid_j, c0, clen, cmax: int, cmw: int):
    """Shared-sketch curve extrema for a slab of interval chunks.

    Args:
        q: (B, S) u32 per-chunk query sketches (ascending, UMAX pad).
        s: (B,) i32 sketch sizes.
        rh/rp: (B, R) u32/i32 ref minimizer hashes / window positions for
            each chunk's range, position-ordered; ``valid_j`` masks real
            entries.
        c0: (B,) i32 first window offset of the chunk.
        clen: (B,) i32 number of offsets (<= cmax); 0 disables the chunk.
        cmax: static offset budget (bounds ``clen`` only -- the compute
            cost is governed by R, not cmax, since the curve is evaluated
            at record anchors directly).
        cmw: window width in k-mer positions.

    Returns:
        (best, first, last): (B,) i32 -- the max of
        ``shared(c) = |Sq ∩ {hashes of ref minis with rp in [c, c+cmw)}|``
        over *record-anchored* offsets ``c`` (offsets in ``[c0, c0+clen)``
        where a valid reference minimizer record sits, mirroring the
        reference's ``searchIndex`` iterator slide) and the absolute
        first/last anchors attaining it.  ``best`` is -1 where the chunk
        has no anchors.
    """
    B, R = rh.shape
    S = q.shape[1]

    # sort each chunk's minis by (hash, pos) so the previous same-hash
    # occurrence is the left neighbor; invalid entries sort to the end
    rp_s = jnp.where(valid_j, rp, _BIG)
    rh_k, rp_k, valid_k = jax.lax.sort(
        (rh, rp_s, valid_j.astype(jnp.int32)), num_keys=2
    )
    prev_h = jnp.concatenate([jnp.full((B, 1), _UMAX, rh_k.dtype), rh_k[:, :-1]], 1)
    prev_p = jnp.concatenate([jnp.full((B, 1), -_BIG, rp_k.dtype), rp_k[:, :-1]], 1)
    same = (prev_h == rh_k) & (prev_p < _BIG)
    start = jnp.maximum(rp_k - (cmw - 1), jnp.where(same, prev_p + 1, -_BIG))

    # hash membership in the query sketch: the sketch rows are sorted
    # ascending (UMAX padded), so membership is a vectorized binary search
    # -- ~log2(S) gather steps instead of the dense (B, R, S) compare,
    # which lets the caller run much wider slabs per sequential step
    # clamp the search range to the materialized sketch axis: in the
    # sharded path q is truncated to S columns while s can exceed S (the
    # overflow is flagged and escalated, but the search must stay
    # well-defined regardless)
    s_eff = jnp.minimum(s[:, None], S).astype(jnp.int32)
    lo_q = jnp.zeros((B, R), jnp.int32)
    hi_q = jnp.broadcast_to(s_eff, (B, R))
    for _ in range(max(1, S.bit_length())):
        active = lo_q < hi_q
        mid = (lo_q + hi_q) // 2
        qm = jnp.take_along_axis(q, jnp.clip(mid, 0, S - 1), axis=1)
        go_right = qm < rh_k
        lo_q = jnp.where(active & go_right, mid + 1, lo_q)
        hi_q = jnp.where(active & ~go_right, mid, hi_q)
    qa = jnp.take_along_axis(q, jnp.clip(lo_q, 0, S - 1), axis=1)
    in_q = (lo_q < s_eff) & (qa == rh_k)

    # presence intervals [start_j, p_j] of the in-sketch occurrences;
    # non-contributing slots park at +BIG so they never stab an anchor
    cond = in_q & (valid_k > 0)
    starts_s = jnp.sort(jnp.where(cond, start, _BIG), axis=1)
    ends_s = jnp.sort(jnp.where(cond, rp_k, _BIG), axis=1)

    # evaluate shared() at the record anchors (every valid record position
    # inside [c0, c0+clen)) with two interval-stabbing binary searches
    anchor_ok = (
        (valid_k > 0) & (rp_k >= c0[:, None]) & (rp_k < (c0 + clen)[:, None])
    )
    n_started = _row_searchsorted(starts_s, rp_k, "right")
    n_ended = _row_searchsorted(ends_s, rp_k, "left")
    shared = jnp.where(anchor_ok, n_started - n_ended, jnp.int32(-1))

    best = jnp.max(shared, axis=1)
    is_best = shared == best[:, None]
    first = jnp.min(jnp.where(is_best, rp_k, _BIG), axis=1)
    last = jnp.max(jnp.where(is_best, rp_k, -_BIG), axis=1)
    # keep the no-anchor convention of the offset-scan formulation:
    # best == -1 with first/last anchored at c0 (callers gate on best > 0)
    none = best < 0
    first = jnp.where(none, c0, first)
    last = jnp.where(none, c0, last)
    return best, first, last


@functools.partial(jax.jit, static_argnames=("cmax", "rmax", "cmw"))
def _l2_chunks_impl(
    q_sorted,  # (F, S) u32 per-fragment sketch hashes, ascending, UMAX pad
    s_sizes,  # (F,) i32
    mini_hash,  # (M,) u32 position-ordered reference minimizers
    mini_wpos,  # (M,) i32
    chunk_frag,  # (N,) i32 fragment id per chunk
    chunk_c0,  # (N,) i32 first window offset of the chunk
    chunk_clen,  # (N,) i32 number of offsets (<= cmax)
    chunk_lo,  # (N,) i32 first ref-minimizer index for the chunk
    chunk_rlen,  # (N,) i32 number of ref minimizers (<= rmax)
    cmax: int,
    rmax: int,
    cmw: int,
):
    M = mini_hash.shape[0]

    def slab(args):
        frag, c0, clen, lo, rlen = args
        j_idx = jnp.arange(rmax, dtype=jnp.int32)[None, :]
        valid_j = j_idx < rlen[:, None]
        gidx = jnp.clip(lo[:, None] + j_idx, 0, max(M - 1, 0))
        rh = jnp.where(valid_j, mini_hash[gidx], _UMAX)
        rp = jnp.where(valid_j, mini_wpos[gidx], _BIG)
        return l2_event_curve(
            q_sorted[frag], s_sizes[frag], rh, rp, valid_j, c0, clen, cmax, cmw
        )

    N = chunk_frag.shape[0]
    n_slabs = N // _SLAB
    args = tuple(
        a.reshape(n_slabs, _SLAB)
        for a in (chunk_frag, chunk_c0, chunk_clen, chunk_lo, chunk_rlen)
    )
    best, first, last = jax.lax.map(slab, args)
    return best.reshape(N), first.reshape(N), last.reshape(N)


def _bucket(n: int, lo: int = 16) -> int:
    return max(lo, 1 << int(n - 1).bit_length())


def l2_chunk_scan(
    q_sorted: np.ndarray,
    s_sizes: np.ndarray,
    mini_hash,
    mini_wpos,
    chunks: np.ndarray,
    cmw: int,
    cmax: int = 3072,
):
    """Evaluate shared-sketch curves for interval chunks on device.

    Args:
        q_sorted: (F, S) uint32 per-fragment sketches (ascending, UMAX pad).
        s_sizes: (F,) int32.
        mini_hash/mini_wpos: device (or numpy) reference minimizer arrays.
        chunks: (N, 5) int32 [frag, c0, clen, lo, rlen] with clen <= cmax.
        cmw: countMinimizerWindows.
        cmax: static chunk width.

    Returns:
        (best, first, last) int32 numpy arrays of length N; `first`/`last`
        are absolute window offsets of the first/last maximal position
        within the chunk.
    """
    N = chunks.shape[0]
    if N == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    rmax = _bucket(int(chunks[:, 4].max(initial=1)))
    n_pad = -N % _SLAB
    if n_pad:
        pad = np.zeros((n_pad, 5), dtype=np.int32)
        chunks = np.concatenate([chunks, pad], axis=0)
    best, first, last = _l2_chunks_impl(
        jnp.asarray(q_sorted),
        jnp.asarray(s_sizes),
        jnp.asarray(mini_hash),
        jnp.asarray(np.asarray(mini_wpos, dtype=np.int32)),
        jnp.asarray(chunks[:, 0]),
        jnp.asarray(chunks[:, 1]),
        jnp.asarray(chunks[:, 2]),
        jnp.asarray(chunks[:, 3]),
        jnp.asarray(chunks[:, 4]),
        cmax,
        rmax,
        cmw,
    )
    return (
        np.asarray(best)[:N],
        np.asarray(first)[:N],
        np.asarray(last)[:N],
    )
