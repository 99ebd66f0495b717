"""Pallas L2 chunk-sweep kernel for NVIDIA GPUs (Triton route).

Evaluates the same per-chunk extrema as the XLA event scan
(`ops.l2.l2_event_curve`): for every chunk -- one L1 candidate interval
cut to at most ``cmax`` window offsets -- the maximum over record anchors
of the shared-sketch count, and the first and last anchors that attain
it.  Reference semantics: ``slidingMap.hpp`` / ``computeL2MappedRegions``
declared at ``include/fastani/map/compute_map.pxd:30-51``.

The event scan sorts each chunk by (hash, position) to find every
record's previous same-hash occurrence.  That occurrence is a pure
function of the reference index, so it is precomputed once at index
build (``mini_prev``, `compute_mini_prev`).  Using the global previous
occurrence is exact inside a chunk: an occurrence before the chunk's
range satisfies ``prev < c0 <= anchor``, so the interval clip at
``prev + 1`` never excludes an in-range anchor.  With it no sort is
left, and the shared count at anchor ``a`` is

    shared(a) = #{j : hash_j in sketch, start_j <= p_a <= p_j},
    start_j = max(p_j - cmw + 1, prev_j + 1)

an integer compare-and-count.  Positions ascend strictly inside a range
(ranges are contig-pure), so only entries ``j >= a`` with
``p_j < p_a + cmw`` can count: a band that the kernel walks with a
dynamic bound, so no statistic of the index is needed.

One program per chunk.  Each loads its own range with clamped gathers
at a dynamic offset, walks it in blocks of ``_BA`` anchors, and for each
anchor block walks the band in blocks of ``_BJ`` entries.  Sketch
membership is a vectorised binary search over the fragment's sorted
sketch row.  Empty chunks (``rlen == 0`` or ``clen == 0``) run no loop
and write the event scan's no-anchor defaults ``(-1, c0, c0)``.  All
arithmetic is int32 compares and adds: there is no float and no matrix
product, so results are exact at any window position below
``2**31 - cmw``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconfig import configure as _configure_jax

_configure_jax()

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["l2_chunks_pallas", "compute_mini_prev", "mini_prev_from_index"]

_BIG = np.int32(2**30)  # `compute_mini_prev`'s "no previous" is -_BIG
_IMAX = np.int32(np.iinfo(np.int32).max)
_IMIN = np.int32(np.iinfo(np.int32).min)
_BA = 64  # anchors per block
_BJ = 64  # band entries per inner step


def compute_mini_prev(
    mini_hash: np.ndarray, mini_seqid: np.ndarray, mini_wpos: np.ndarray
) -> np.ndarray:
    """Per-minimizer previous same-hash occurrence (same contig), as a
    contig-local window position; -2**30 where none exists.

    This is the precomputation that lets the L2 kernel clip presence
    intervals without sorting the chunk by hash (see module docstring).
    """
    m = mini_hash.shape[0]
    if m == 0:
        return np.zeros(0, np.int32)
    order = np.lexsort((mini_wpos, mini_seqid, mini_hash))
    h = mini_hash[order]
    s = mini_seqid[order]
    p = mini_wpos[order]
    prev = np.full(m, -_BIG, np.int32)
    same = (h[1:] == h[:-1]) & (s[1:] == s[:-1])
    prev[1:][same] = p[:-1][same]
    out = np.empty(m, np.int32)
    out[order] = prev
    return out


def mini_prev_from_index(sub) -> np.ndarray:
    """`compute_mini_prev` without the lexsort, from a `PostingIndex`
    whose CSR sort permutation was retained (``sub.order``).

    The posting arrays are the minimizer store in (hash, seqid, wpos)
    order (a stable hash sort of a position-ordered stream), so the
    previous same-hash-same-contig occurrence is just the preceding
    posting entry when no CSR row boundary or contig change intervenes.
    Falls back to `compute_mini_prev` when the permutation is absent
    (e.g. an index rebuilt through live posting edits).
    """
    m = int(sub.mini_hash.shape[0])
    if m == 0:
        return np.zeros(0, np.int32)
    order = getattr(sub, "order", None)
    if order is None or order.shape[0] != m or sub.post_seqid.shape[0] != m:
        return compute_mini_prev(sub.mini_hash, sub.mini_seqid, sub.mini_wpos)
    newrow = np.zeros(m, bool)
    newrow[np.asarray(sub.row_start, dtype=np.int64)] = True
    same = ~newrow[1:] & (sub.post_seqid[1:] == sub.post_seqid[:-1])
    prev = np.full(m, -_BIG, np.int32)
    prev[1:][same] = sub.post_wpos[:-1][same]
    out = np.empty(m, np.int32)
    out[order] = prev
    return out


def _kernel(
    lo_ref,  # (N,) i32 first reference entry of the chunk's range
    rlen_ref,  # (N,) i32 entries in the range (contig-pure)
    frag_ref,  # (N,) i32 fragment (sketch row) of the chunk
    c0_ref,  # (N,) i32 first window offset
    clen_ref,  # (N,) i32 number of window offsets (0 disables the chunk)
    hash_ref,  # (M,) u32 position-ordered reference minimizer hashes
    wpos_ref,  # (M,) i32 contig-local window positions
    prev_ref,  # (M,) i32 previous same-hash occurrence (`compute_mini_prev`)
    q_ref,  # (F * S,) u32 sorted sketch rows, flattened, UMAX pad
    s_ref,  # (F,) i32 sketch sizes
    best_ref,  # (N,) i32 out
    first_ref,  # (N,) i32 out
    last_ref,  # (N,) i32 out
    *,
    S: int,
    cmw: int,
):
    i = pl.program_id(0)
    lo = lo_ref[i]
    rlen = rlen_ref[i]
    c0 = c0_ref[i]
    clen = clen_ref[i]
    frag = frag_ref[i]
    rlen = jnp.where(clen > 0, rlen, 0)
    s = jnp.minimum(s_ref[frag], S)
    qbase = frag * S
    last_e = jnp.maximum(lo + rlen - 1, 0)

    def gather(ref, j):
        # clamped gather of range entries j (masked by the callers)
        return ref[jnp.clip(lo + j, 0, last_e)]

    def in_sketch(h):
        # vectorised lower-bound search of h in the sorted sketch row
        lo_q = jnp.zeros(h.shape, jnp.int32)
        hi_q = jnp.full(h.shape, s, jnp.int32)
        for _ in range(max(1, S.bit_length())):
            mid = (lo_q + hi_q) >> 1
            v = q_ref[qbase + jnp.minimum(mid, S - 1)]
            go = (lo_q < hi_q) & (v < h)
            stay = (lo_q < hi_q) & ~(v < h)
            lo_q = jnp.where(go, mid + 1, lo_q)
            hi_q = jnp.where(stay, mid, hi_q)
        qa = q_ref[qbase + jnp.minimum(lo_q, S - 1)]
        return (lo_q < s) & (qa == h)

    a_lane = jax.lax.broadcasted_iota(jnp.int32, (_BA,), 0)
    j_lane = jax.lax.broadcasted_iota(jnp.int32, (_BJ,), 0)

    def anchor_block(b, carry):
        best, first, last = carry
        a0 = b * _BA
        a_idx = a0 + a_lane
        a_ok = a_idx < rlen
        pa = gather(wpos_ref, a_idx)
        anchor = a_ok & (pa >= c0) & (pa < c0 + clen)
        # entries past the last in-range position + cmw - 1 stab nothing
        # in this block: the band ends at the first such entry
        limit = gather(wpos_ref, jnp.minimum(a0 + _BA, rlen) - 1) + (cmw - 1)

        def band_live(c):
            j0, _ = c
            return (j0 < rlen) & (gather(wpos_ref, j0) <= limit)

        def band_step(c):
            j0, cnt = c
            j_idx = j0 + j_lane
            j_ok = j_idx < rlen
            p = gather(wpos_ref, j_idx)
            st = jnp.maximum(p - (cmw - 1), gather(prev_ref, j_idx) + 1)
            cd = j_ok & in_sketch(gather(hash_ref, j_idx))
            stab = (
                cd[None, :]
                & (st[None, :] <= pa[:, None])
                & (pa[:, None] <= p[None, :])
            )
            return j0 + _BJ, cnt + jnp.sum(stab.astype(jnp.int32), axis=1)

        _, cnt = jax.lax.while_loop(
            band_live, band_step, (a0, jnp.zeros((_BA,), jnp.int32))
        )
        shared = jnp.where(anchor, cnt, -1)
        bb = jnp.max(shared)
        hit = shared == bb
        bf = jnp.min(jnp.where(hit, pa, _IMAX))
        bl = jnp.max(jnp.where(hit, pa, _IMIN))
        better = bb > best
        tie = bb == best
        return (
            jnp.maximum(best, bb),
            jnp.where(better, bf, jnp.where(tie, jnp.minimum(first, bf), first)),
            jnp.where(better, bl, jnp.where(tie, jnp.maximum(last, bl), last)),
        )

    n_blk = (rlen + (_BA - 1)) // _BA
    best, first, last = jax.lax.fori_loop(
        0, n_blk, anchor_block, (jnp.int32(-1), _IMAX, _IMIN)
    )
    none = best < 0
    best_ref[i] = best
    first_ref[i] = jnp.where(none, c0, first)
    last_ref[i] = jnp.where(none, c0, last)


@functools.partial(jax.jit, static_argnames=("cmw", "interpret"))
def l2_chunks_pallas(
    q_sorted,  # (F, S) u32 sorted sketches, UMAX pad
    s_sizes,  # (F,) i32
    mini_hash,  # (M,) u32 position-ordered
    mini_wpos,  # (M,) i32
    mini_prev,  # (M,) i32 previous same-hash occurrence
    chunk_frag,  # (N,) i32
    chunk_c0,  # (N,) i32
    chunk_clen,  # (N,) i32
    chunk_lo,  # (N,) i32 first ref-minimizer element index of the range
    chunk_rlen,  # (N,) i32 range length
    cmw: int,
    interpret: bool = False,
):
    """Evaluate chunk curves; returns (best, first, last) (N,) i32.

    Every range ``[lo, lo + rlen)`` must lie within ONE contig's
    minimizer block, whose positions ascend strictly (the sharded caller
    clamps ranges against the contig offsets).  ``interpret=True`` runs
    the kernel through the Pallas interpreter (tests on the CPU).
    """
    S = q_sorted.shape[1]
    N = int(chunk_frag.shape[0])
    kern = functools.partial(_kernel, S=S, cmw=cmw)
    args = (
        chunk_lo, chunk_rlen, chunk_frag, chunk_c0, chunk_clen,
        mini_hash, mini_wpos, mini_prev, q_sorted.reshape(-1), s_sizes,
    )
    out = jax.ShapeDtypeStruct((N,), jnp.int32)
    return pl.pallas_call(
        kern,
        grid=(N,),
        out_shape=(out, out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="l2_chunk_sweep",
    )(*args)
