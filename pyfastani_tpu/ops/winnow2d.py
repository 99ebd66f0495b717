"""Long-sequence minimizer winnowing in the ``(rows, 128)`` layout.

Semantics are identical (bitwise) to `pyfastani_tpu.ops.winnow` /
`models._engine_np.winnow_sequence`, i.e. to the reference deque loop
(``/root/reference/src/pyfastani/_fastani.pyx:156-309``): palindromic
k-mer skipping, canonical ``min(fwd, rc)`` hashing, tie-to-latest window
minima, consecutive-occurrence dedup, and the window-0 suppression quirk.
See `ops.winnow` for the derivation of each rule.

What differs is the *data layout*: the sequence axis is folded into a
``(R, 128)`` array (see `ops.layout2d` for why), byte accesses become
flattened shifts, the sliding-window minimum is log-doubling over shifts,
and the dedup/suppression recurrences become Hillis-Steele prefix scans.
The reverse-complement hash is computed *directly* (the rc k-mer's bytes
are the complemented sequence read at offsets ``k-1-t``), removing the
global sequence reversal + mirror gather of the 1-D formulation.

Chunking: arbitrarily long sequences are processed ``B`` windows at a
time with a carried boundary state, so a single compiled shape serves
every genome length (the reference streams through a fixed ring buffer
for the same reason, ``_fastani.pyx:179-196``).
"""

from __future__ import annotations

import numpy as np

from .codec import complement_table
from .layout2d import LANES, pad_to_lanes, prefix_scan, shift_down, shift_up

__all__ = ["kmer_hashes2d", "winnow_chunk2d", "CARRY_INIT"]

_SENT = 0xFFFFFFFF

#: initial carry for the first chunk of a contig:
#: (has_prev, prev_pos(global), phantom, h0)
CARRY_INIT = (False, np.int32(0), False, np.uint32(0))


def _rotl32(xp, x, r: int):
    return (x << xp.uint32(r & 31)) | (x >> xp.uint32(32 - (r & 31)))


def kmer_hashes2d(xp, u8, k: int, seed: int = 42, rc: bool = False):
    """Murmur3_x86_32 of the k-mer starting at every flat position.

    Args:
        u8: ``(R, C)`` uint32 array of byte values; flat index ``i`` holds
            sequence byte ``i`` (zero padding past the end is fine --
            callers mask invalid positions).
        k: k-mer length (static).
        rc: when `True`, hash the *reversed* k-mer instead -- byte ``t`` of
            the hashed string is ``u8.flat[i + k - 1 - t]``.  Feeding the
            complemented sequence yields the reverse-complement hash with
            no global reversal.

    Returns:
        ``(R, C)`` uint32 hashes (position ``i`` -> hash of bytes
        ``[i, i+k)``; positions whose k-mer reads past the data are garbage
        and must be masked by the caller).
    """

    def byte_at(t: int):
        return shift_up(xp, u8, (k - 1 - t) if rc else t, 0)

    h1 = xp.full(u8.shape, seed, dtype=xp.uint32)
    nblocks = k // 4
    for j in range(nblocks):
        k1 = (
            byte_at(4 * j)
            | (byte_at(4 * j + 1) << xp.uint32(8))
            | (byte_at(4 * j + 2) << xp.uint32(16))
            | (byte_at(4 * j + 3) << xp.uint32(24))
        )
        k1 = k1 * xp.uint32(0xCC9E2D51)
        k1 = _rotl32(xp, k1, 15)
        k1 = k1 * xp.uint32(0x1B873593)
        h1 = h1 ^ k1
        h1 = _rotl32(xp, h1, 13)
        h1 = h1 * xp.uint32(5) + xp.uint32(0xE6546B64)

    tail = k & 3
    if tail:
        base = 4 * nblocks
        k1 = xp.zeros(u8.shape, dtype=xp.uint32)
        if tail >= 3:
            k1 = k1 ^ (byte_at(base + 2) << xp.uint32(16))
        if tail >= 2:
            k1 = k1 ^ (byte_at(base + 1) << xp.uint32(8))
        k1 = k1 ^ byte_at(base)
        k1 = k1 * xp.uint32(0xCC9E2D51)
        k1 = _rotl32(xp, k1, 15)
        k1 = k1 * xp.uint32(0x1B873593)
        h1 = h1 ^ k1

    h1 = h1 ^ xp.uint32(k)
    h1 = h1 ^ (h1 >> xp.uint32(16))
    h1 = h1 * xp.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> xp.uint32(13))
    h1 = h1 * xp.uint32(0xC2B2AE35)
    h1 = h1 ^ (h1 >> xp.uint32(16))
    return h1


def _pair_min(xp, h_a, p_a, h_b, p_b):
    """(hash, pos) window minimum: smaller hash, ties to larger position."""
    take_b = (h_b < h_a) | ((h_b == h_a) & (p_b > p_a))
    return xp.where(take_b, h_b, h_a), xp.where(take_b, p_b, p_a)


def winnow_chunk2d(
    xp,
    slice2d,
    q_hi,
    base,
    carry,
    *,
    k: int,
    w: int,
    B: int,
    protein: bool,
    first_chunk: bool,
):
    """Winnow one chunk of ``B`` windows in the ``(R, 128)`` layout.

    Args:
        slice2d: ``(R, 128)`` uint8 -- bytes ``data[base : base + R*128]``
            of the contig, zero-padded past the end.  ``R*128`` must cover
            ``B + w + k - 2`` bytes (the last emitted window's last k-mer).
        q_hi: traced int32 -- number of valid k-mer positions in this
            slice (``n - k + 1 - base``); flat positions past it are
            masked invalid.
        base: traced int32 -- global position of flat index 0 (window and
            k-mer coordinates coincide).
        carry: ``(has_prev, prev_pos, phantom, h0)`` boundary state from
            the previous chunk (`CARRY_INIT` for the first); ``prev_pos``
            is the previous evaluated window's chosen k-mer position in
            *global* coordinates, matching the un-chunked host engine.
        k, w, B: static ints; ``first_chunk`` static (the window-0
            suppression quirk anchors at global window 0).

    Returns:
        ``(record, win_hash, new_carry)`` -- ``(R, 128)`` bool/uint32 whose
        flat prefix ``[0, B)`` describes this chunk's windows: window
        ``base + p`` appends ``(win_hash.flat[p], wpos=base+p)`` iff
        ``record.flat[p]``.
    """
    has_prev, prev_pos, phantom, h0 = carry
    R, C = slice2d.shape
    u8 = slice2d.astype(xp.uint32)

    iota = xp.arange(R * C, dtype=xp.int32).reshape(R, C)
    pos_ok = iota < q_hi

    fwd = kmer_hashes2d(xp, u8, k)
    if protein:
        canon, valid = fwd, pos_ok
    else:
        # np.array copy: see the capture-caching note in ops/winnow.py
        lut = xp.asarray(np.array(complement_table()), dtype=xp.uint8)
        cu8 = xp.take(lut, slice2d.astype(xp.int32)).astype(xp.uint32)
        bwd = kmer_hashes2d(xp, cu8, k, rc=True)
        valid = pos_ok & (fwd != bwd)
        canon = xp.minimum(fwd, bwd)

    sent = xp.uint32(_SENT)
    gpos = (iota + base).astype(xp.uint32)
    g_h = xp.where(valid, canon, sent)
    g_p = xp.where(valid, gpos, xp.uint32(0))

    # log-doubling sliding minimum over windows of w k-mers
    size = 1
    while size * 2 <= w:
        sh = shift_up(xp, g_h, size, _SENT)
        sp = shift_up(xp, g_p, size, 0)
        g_h, g_p = _pair_min(xp, g_h, g_p, sh, sp)
        size *= 2
    rem = w - size
    sh = shift_up(xp, g_h, rem, _SENT)
    sp = shift_up(xp, g_p, rem, 0)
    win_h, win_p = _pair_min(xp, g_h, g_p, sh, sp)

    # window p is evaluated iff its last k-mer (p + w - 1) is valid;
    # windows at flat >= B belong to the next chunk
    emit = iota < B
    evaluated = shift_up(xp, valid, w - 1, False) & emit

    # previous evaluated window's chosen position: "last where evaluated"
    # exclusive scan, then the cross-chunk carry for the first elements
    def last_eval(earlier, current):
        e1, v1 = earlier
        e2, v2 = current
        return (e1 | e2, xp.where(e2, v2, v1))

    e_inc, v_inc = prefix_scan(
        xp, last_eval, (evaluated, win_p), (False, 0)
    )
    prev_e = shift_down(xp, e_inc, 1, False)
    prev_v = shift_down(xp, v_inc, 1, 0)

    have_prev_eff = prev_e | has_prev
    prev_pos_eff = xp.where(prev_e, prev_v, xp.uint32(prev_pos))
    is_new = evaluated & ((~have_prev_eff) | (win_p != prev_pos_eff))

    # window-0 suppression quirk, carried across chunks: active while every
    # evaluated window since contig window 0 carried hash h0
    if first_chunk:
        phantom_eff = evaluated[0, 0]
        h0_eff = win_h[0, 0]
    else:
        phantom_eff = phantom
        h0_eff = xp.uint32(h0)
    same_h0 = (~evaluated) | (win_h == h0_eff)
    (prefix_ok,) = prefix_scan(
        xp, lambda a, b: (a[0] & b[0],), (same_h0,), (True,)
    )
    suppress = phantom_eff & prefix_ok
    if first_chunk:
        suppress = suppress & (iota > 0)  # window 0 itself records
    record = is_new & ~suppress

    # carry for the next chunk
    any_eval = e_inc[-1, -1]
    new_prev_pos = xp.where(any_eval, v_inc[-1, -1].astype(xp.int32), prev_pos)
    new_carry = (
        has_prev | any_eval,
        new_prev_pos,
        phantom_eff & prefix_ok[-1, -1],
        h0_eff,
    )
    return record, win_h, new_carry


def chunk_slice_rows(B: int, w: int, k: int) -> int:
    """Rows of the ``(R, 128)`` byte slice needed for ``B`` windows."""
    return pad_to_lanes(B + w + k - 2) // LANES
