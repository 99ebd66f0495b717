"""Vectorized minimizer winnowing (``skch::CommonFunc::addMinimizers``).

The reference winnows with a monotone deque, one k-mer at a time
(``/root/reference/src/pyfastani/_fastani.pyx:156-309``).  Its exact
observable semantics, reproduced here as data-parallel array ops:

* k-mers whose forward Murmur hash equals the reverse-complement hash
  ("palindromic") are skipped entirely -- they enter neither the queue nor
  the window accounting, and *no window is evaluated at a step whose
  current k-mer is palindromic* (the whole loop body is inside the
  ``hash_bwd != hash_fwd`` branch, ``_fastani.pyx:202-222``);
* the canonical hash is ``min(fwd, bwd)`` (``:206``);
* for an evaluated window ``p`` (i.e. k-mer ``i = p + w - 1`` is valid and
  ``p >= 0``), the minimizer is the valid k-mer in ``[p, p + w)`` with the
  smallest hash, ties resolved to the *latest* position (inserting pops
  ``>=`` from the back, ``:211``);
* a record ``(hash, seqId, wpos=p)`` is appended when the chosen
  *occurrence* differs from the previously evaluated window's choice
  (``:219-222``), with one bug-compatible quirk: the dedup compares
  against the queue element's mutable ``wpos`` field (0 until recorded),
  so when the first record of a contig lands at window 0, subsequent
  *equal-hash* occurrence changes are suppressed until a different hash is
  recorded (both sides of the comparison read ``(hash, seqId, 0)``).

The sliding window minimum uses the log-doubling trick (O(log w) shifted
elementwise min steps); dedup and the suppression quirk are prefix scans.
Everything is shape-static given (padded length, k, w), so the same code
traces under ``jax.jit`` and runs eagerly under NumPy.
"""

from __future__ import annotations

import numpy as np

from .codec import complement_table
from .murmur3 import kmer_hashes

__all__ = ["nucl_canonical", "prot_hashes", "winnow"]

_HASH_SENTINEL = 0xFFFFFFFF


def _is_numpy(xp) -> bool:
    return xp is np


def _cummax(xp, x):
    if _is_numpy(xp):
        return np.maximum.accumulate(x)
    import jax.lax

    return jax.lax.cummax(x)


def _cumall(xp, x_bool):
    if _is_numpy(xp):
        return np.minimum.accumulate(x_bool.astype(np.int32)).astype(bool)
    import jax.lax

    return jax.lax.cummin(x_bool.astype("int32")).astype(bool)


def _complement_bytes(xp, data):
    """Elementwise complement without a table GATHER.

    The table has only ~26 non-identity entries (12 IUPAC letters x 2
    cases + 2 control bytes), so a chain of vector selects replaces the
    256-entry LUT gather, bitwise identical.  (Whether the select chain
    still beats the gather on the GPU is not measured.)
    """
    if _is_numpy(xp):
        return complement_table()[data]
    tab = complement_table()
    out = data
    for v in np.flatnonzero(tab != np.arange(tab.shape[0])):
        out = xp.where(data == np.uint8(v), np.uint8(tab[v]), out)
    return out


def nucl_canonical(xp, data, n: int, k: int, n_positions: int):
    """Canonical nucleotide k-mer hashes and validity for every position.

    Args:
        xp: numpy or jax.numpy.
        data: uppercased uint8 sequence, padded to static length ``L_pad``
            (``L_pad >= n_positions + k - 1 + 4``).
        n: actual sequence length (python int or traced scalar).
        k: k-mer size (static).
        n_positions: static number of k-mer positions to emit
            (>= n - k + 1 for full coverage).

    Returns:
        (canon, valid): uint32 hashes and bool mask, length ``n_positions``.
        Positions past ``n - k`` are invalid.

    The reverse-complement hash needs NO data-dependent indexing: with
    ``comp`` the elementwise complement and ``crev = comp[::-1]`` (a
    STATIC reverse over the padded buffer), the revcomp k-mer at
    position ``i`` is ``crev[L_pad - k - i : L_pad - i]``, so
    ``bwd[i] = kmer_hashes(crev)[L_pad - k - i]`` -- i.e. the hash
    array statically reversed.  The previous formulation (roll by the
    traced length + a mirror-index gather) cost ~85 ms per dispatch at
    bench shapes; this one is pure slices and bitwise identical on
    every position that can be valid.
    """
    L_pad = data.shape[0]
    comp = _complement_bytes(xp, data)
    crev = comp[::-1]

    fwd = kmer_hashes(xp, data, k, out_len=n_positions)
    rc_len = L_pad - k + 1
    rr = kmer_hashes(xp, crev, k, out_len=rc_len)
    # rr[L_pad - k - i] == murmur(comp[i + k - 1], ..., comp[i])
    bwd = rr[::-1][:n_positions]

    idx = xp.arange(n_positions, dtype=xp.int32)
    pos_ok = idx <= xp.int32(n) - xp.int32(k)
    # invalid positions previously carried bwd == 0; their (canon, valid)
    # are masked by pos_ok everywhere downstream, so the padded-garbage
    # bwd here is unobservable
    valid = pos_ok & (fwd != bwd)
    canon = xp.minimum(fwd, bwd)
    return canon, valid


def prot_hashes(xp, data, n: int, k: int, n_positions: int):
    """Forward-only hashes + validity (protein path, ``_fastani.pyx:252-309``)."""
    fwd = kmer_hashes(xp, data, k, out_len=n_positions)
    idx = xp.arange(n_positions, dtype=xp.int32)
    valid = idx <= xp.int32(n) - xp.int32(k)
    return fwd, valid


def _shift_left(xp, arr, d: int, fill):
    if d == 0:
        return arr
    pad = xp.full((d,), fill, dtype=arr.dtype)
    return xp.concatenate([arr[d:], pad])


def _pair_min(xp, h_a, p_a, h_b, p_b):
    """(hash, pos) min: smaller hash wins; equal hash -> larger pos wins."""
    take_b = (h_b < h_a) | ((h_b == h_a) & (p_b > p_a))
    return xp.where(take_b, h_b, h_a), xp.where(take_b, p_b, p_a)


def winnow(xp, canon, valid, w: int):
    """Evaluate every window and flag which records a minimizer.

    Args:
        canon: uint32 canonical hashes, length ``N`` (padded ok).
        valid: bool mask, same length.
        w: window size (static python int, >= 1).

    Returns:
        (record, win_hash) of length ``P = N - w + 1``:
        ``record[p]`` -- this window appends ``(win_hash[p], wpos=p)``.
    """
    N = canon.shape[0]
    P = N - w + 1
    if P <= 0:
        z = xp.zeros((0,), dtype=bool)
        return z, xp.zeros((0,), dtype=xp.uint32)

    pos = xp.arange(N, dtype=xp.uint32)
    g_h = xp.where(valid, canon, xp.uint32(_HASH_SENTINEL))
    # invalid entries carry pos 0 so a (real) sentinel-valued hash beats them
    g_p = xp.where(valid, pos, xp.uint32(0))

    # log-doubling sliding minimum: g covers windows of size `size`
    size = 1
    while size * 2 <= w:
        sh = _shift_left(xp, g_h, size, _HASH_SENTINEL)
        sp = _shift_left(xp, g_p, size, 0)
        g_h, g_p = _pair_min(xp, g_h, g_p, sh, sp)
        size *= 2
    rem = w - size
    sh = _shift_left(xp, g_h, rem, _HASH_SENTINEL)
    sp = _shift_left(xp, g_p, rem, 0)
    win_h, win_p = _pair_min(xp, g_h, g_p, sh, sp)
    win_h = win_h[:P]
    win_p = win_p[:P]

    # window p is evaluated iff its last k-mer (p + w - 1) is valid
    evaluated = valid[w - 1 : w - 1 + P]

    # previous evaluated window's chosen position.  For fragment-sized
    # inputs (N < 2^15) the (window idx, chosen pos) pair packs into one
    # int32, so the lookup is a single exclusive cummax -- the gather
    # formulation cost ~85 ms per dispatch at bench shapes (round-5
    # device trace).  Long-sequence (host NumPy) callers keep the gather.
    idx = xp.arange(P, dtype=xp.int32)
    if N * N <= 2**31 - 1:
        packed = xp.where(
            evaluated,
            idx * xp.int32(N) + win_p.astype(xp.int32),
            xp.int32(-1),
        )
        prev_packed = xp.concatenate(
            [xp.full((1,), -1, dtype=xp.int32), _cummax(xp, packed)[:-1]]
        )
        first_eval = prev_packed < 0
        prev_pos = (prev_packed % xp.int32(N)).astype(win_p.dtype)
    else:
        marked = xp.where(evaluated, idx, xp.int32(-1))
        prev = xp.concatenate(
            [xp.full((1,), -1, dtype=xp.int32), _cummax(xp, marked)[:-1]]
        )
        prev_c = xp.clip(prev, 0, P - 1)
        prev_pos = win_p[prev_c]
        first_eval = prev < 0

    is_new = evaluated & (first_eval | (win_p != prev_pos))

    # window-0 suppression quirk: if the contig's first evaluated window is
    # p == 0, equal-hash occurrence changes are swallowed while every
    # evaluated window so far carried the same hash h0.
    first_is_zero = evaluated[0]
    h0 = win_h[0]
    same_h0 = (~evaluated) | (win_h == h0)
    prefix_ok = _cumall(xp, same_h0)
    suppress = first_is_zero & (idx > 0) & prefix_ok

    record = is_new & ~suppress
    return record, win_h


def winnow_chunk(xp, canon, valid, w: int, carry, first_chunk: bool = False):
    """Chunked variant of `winnow`: evaluate windows of one chunk given the
    carried boundary state, so arbitrarily long sequences reuse one
    compiled shape.

    Args:
        canon/valid: k-mer hashes/validity for positions
            ``[base - (w-1), base + CHUNK + (w-1))`` of the contig (the
            leading ``w-1`` halo lets every window of the chunk see its
            full k-mer range; for the first chunk the halo is invalid
            padding).
        carry: tuple of traced scalars
            ``(has_prev, prev_pos_local, phantom, h0)`` where
            ``prev_pos_local`` is the previous evaluated window's chosen
            k-mer position in THIS chunk's local coordinates (i.e. global
            pos - base + (w-1); negative values reach into the halo).

    Returns:
        (record, win_hash) for the CHUNK windows (length ``CHUNK``) and
        the updated carry (with ``prev_pos_local`` relative to the NEXT
        chunk's coordinates, assuming the next chunk starts CHUNK later).
    """
    has_prev, prev_pos, phantom, h0 = carry
    N = canon.shape[0]
    halo = w - 1
    P_all = N - w + 1  # windows starting at local positions [0, P_all)
    CHUNK = P_all - halo  # windows of this chunk start at local pos halo

    pos = xp.arange(N, dtype=xp.uint32)
    g_h = xp.where(valid, canon, xp.uint32(_HASH_SENTINEL))
    g_p = xp.where(valid, pos, xp.uint32(0))

    size = 1
    while size * 2 <= w:
        sh = _shift_left(xp, g_h, size, _HASH_SENTINEL)
        sp = _shift_left(xp, g_p, size, 0)
        g_h, g_p = _pair_min(xp, g_h, g_p, sh, sp)
        size *= 2
    rem = w - size
    sh = _shift_left(xp, g_h, rem, _HASH_SENTINEL)
    sp = _shift_left(xp, g_p, rem, 0)
    win_h_all, win_p_all = _pair_min(xp, g_h, g_p, sh, sp)

    # restrict to this chunk's windows
    win_h = win_h_all[halo : halo + CHUNK]
    win_p = win_p_all[halo : halo + CHUNK].astype(xp.int32)
    evaluated = valid[halo + w - 1 : halo + w - 1 + CHUNK]

    idx = xp.arange(CHUNK, dtype=xp.int32)
    marked = xp.where(evaluated, idx, xp.int32(-1))
    prev_in = xp.concatenate(
        [xp.full((1,), -1, dtype=xp.int32), _cummax(xp, marked)[:-1]]
    )
    prev_c = xp.clip(prev_in, 0, CHUNK - 1)
    prev_pos_in = win_p[prev_c]
    first_eval = prev_in < 0

    # previous chosen position: in-chunk, or carried across the boundary
    prev_pos_eff = xp.where(first_eval, xp.int32(prev_pos), prev_pos_in)
    have_prev_eff = (~first_eval) | has_prev
    is_new = evaluated & ((~have_prev_eff) | (win_p != prev_pos_eff))

    # phantom suppression carried across chunks: active while every
    # evaluated window since contig window 0 carried hash h0
    if first_chunk:
        phantom_eff = evaluated[0]
        h0_eff = win_h[0]
    else:
        phantom_eff = phantom
        h0_eff = xp.uint32(h0)
    same_h0 = (~evaluated) | (win_h == h0_eff)
    prefix_ok = _cumall(xp, same_h0)
    suppress = phantom_eff & prefix_ok
    if first_chunk:
        suppress = suppress & (idx > 0)  # window 0 itself records
    record = is_new & ~suppress

    # update the carry
    any_eval = evaluated.any()
    last_eval = _cummax(xp, marked)[-1]
    last_c = xp.clip(last_eval, 0, CHUNK - 1)
    new_prev_pos = xp.where(any_eval, win_p[last_c], xp.int32(prev_pos))
    new_has_prev = has_prev | any_eval
    new_phantom = phantom_eff & prefix_ok[-1]
    # local coords shift by CHUNK for the next chunk
    new_carry = (new_has_prev, new_prev_pos - xp.int32(CHUNK), new_phantom, h0_eff)
    return record, win_h, new_carry
