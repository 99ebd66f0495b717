"""Device L1 stage: posting probes, seed gathering, candidate intervals.

The host engines run this stage in NumPy (it is tiny per genome); the
multi-chip pipeline needs it on device so the whole query step is one
jitted program.  All stages are static-shape with explicit budgets:

* ``hmax``: seed hits per fragment **on average** -- the hit buffer is a
  single flat axis of ``F * hmax`` slots shared by the whole fragment
  batch, so one fragment pulling a long posting row borrows capacity
  from the others instead of forcing every row to the worst case.
  Overflow of the *total* is reported, never silent;
* ``ivmax``: merged candidate intervals per fragment.

Formulation choices (not yet timed against their plain forms on the
GPU): every multi-array lookup gathers ONE packed row; scans run 2-level
over a (rows, 512) reshape; the interval reductions pack into a single
``segment_max``.

Round-5 redesign -- three structural cuts to the T-sized gather count:

* hits carry ONE coordinate, the **global position** (``post_gpos``,
  per-shard cumulative contig offsets).  Contigs are laid out with
  >= l + 8 of dead space between them (`build_sharded_index`), so
  "same contig and within l" collapses to a single gpos difference and
  the (seqId, wpos) pair -- one sort key and one gather plane -- drops
  out of the whole stage.  Contig ids are recovered per merged interval
  (a few hundred per fragment at most) by the caller, not per hit;
* the per-fragment minimum-hit count ``m`` rides the packed per-probe
  gather (delta, m) instead of costing its own T-sized gather.  The
  (fragment, gpos) sort is stable with fragment as primary key and each
  fragment's slot range is fixed by the probe prefix sums, so the
  pre-sort ``m_t`` is elementwise identical to the post-sort one;
* the m-consecutive-hit window check needs ``hits[t + m_t - 1]``.  The
  reachable values of ``m`` are the distinct entries of the min-hits
  table below the sketch budget -- a STATIC set, {1..4} at default
  parameters -- so the data-dependent gather becomes a select over
  ``len(m_values)`` shifted slices (contiguous reads, ~1000x cheaper
  than a T-sized random gather).

Semantics mirror ``Mapper._do_l1_mappings`` + [reconstructed]
``computeL1CandidateRegions`` (``_fastani.pyx:885-954``,
``compute_map.pxd:41-44``): probe the CSR index per unique sketch hash,
skip rows at/above the frequency threshold, sort seed hits by
(fragment, seqId, wpos) == (fragment, gpos), find windows of ``m``
consecutive hits spanning < l, and merge overlapping candidates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconfig import configure as _configure_jax

_configure_jax()

__all__ = ["l1_candidates_device"]

# numpy scalars: plain constants in every trace (a module-level jnp array
# would be a device buffer created at import)
_BIG = np.int32(2**30)
# padding sentinel for global-position values (> any real gpos; real
# per-shard spans are capped ~1 Gbp below it at index build)
_GBIG = np.int32(2**31 - 2**20)

_SCAN_COLS = 512  # 2-level scan row width


def _scan2(op, x):
    """Flat inclusive scan via a (rows, 512) decomposition.

    Scanning the minor axis of a 2-D reshape vectorizes across rows and
    only the tiny row-carry scan stays 1-D.  Falls back to the flat scan
    when the length doesn't divide.
    """
    n = x.shape[0]
    if n % _SCAN_COLS or n <= _SCAN_COLS:
        return op(x)
    r = n // _SCAN_COLS
    x2 = x.reshape(r, _SCAN_COLS)
    rows = op(x2, axis=1)
    carry = op(rows[:, -1])
    if op is jax.lax.cumsum:
        full = rows + jnp.concatenate(
            [jnp.zeros((1,), x.dtype), carry[:-1]]
        )[:, None]
    else:
        lowest = jnp.iinfo(x.dtype).min
        full = jnp.maximum(
            rows,
            jnp.concatenate([jnp.full((1,), lowest, x.dtype), carry[:-1]])[
                :, None
            ],
        )
    return full.reshape(n)


@functools.partial(
    jax.jit,
    static_argnames=("hmax", "ivmax", "l", "bucket_steps", "m_values"),
)
def l1_candidates_device(
    q_sorted,  # (F, S) u32 ascending sketch hashes, UMAX padded
    s_sizes,  # (F,) i32
    uniq_hash,  # (U,) u32
    row_start,  # (U,) i32
    row_len,  # (U,) i32
    post_gpos,  # (M,) i32 global positions of hash-sorted postings
    freq_threshold,  # scalar i32
    min_hits_table,  # (T,) i32, indexed by sketch size (clipped)
    hash_bucket,  # (2^bits, 2) i32 (row_lo, row_hi) per hash prefix
    hmax: int,
    ivmax: int,
    l: int,
    bucket_steps: int = 21,
    m_values: tuple = (1, 2, 3, 4),
):
    """Returns (iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv): (F, ivmax) x2
    GLOBAL-coordinate candidate intervals, (F, ivmax) bool, and two
    scalar bools flagging which static budget (hmax / ivmax) overflowed.
    ``iv_g0`` is unclamped at contig starts -- the caller clamps against
    the owning contig's base offset.  ``m_values`` must cover every
    reachable min-hits value for sketch sizes 0..S (see module docstring).
    """
    F, S = q_sorted.shape
    M = post_gpos.shape[0]
    U = uniq_hash.shape[0]
    T = F * hmax  # flat hit capacity shared across the fragment batch

    # --- probe the CSR index ------------------------------------------------
    # bucketed binary search: the adaptive hash-prefix table narrows each
    # probe to its bucket, so only ~log2(max bucket) gather steps remain
    bits = int(hash_bucket.shape[0]).bit_length() - 1
    b = (q_sorted >> jnp.uint32(32 - bits)).astype(jnp.int32)
    # ONE packed (lo, hi) row per probe instead of two table gathers (a
    # multi-word row costs the same DMA descriptor as one word)
    bp = hash_bucket[b]  # (F, S, 2)
    lo = bp[:, :, 0]
    hi = bp[:, :, 1]
    for _ in range(bucket_steps):
        active = lo < hi
        mid = (lo + hi) // 2
        mid_c = jnp.clip(mid, 0, max(U - 1, 0))
        go_right = uniq_hash[mid_c] < q_sorted
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    rows = lo  # (F, S) insertion points
    rows_c = jnp.clip(rows, 0, max(U - 1, 0))
    # one packed row lookup for (hash, row_len, row_start)
    q_i = jax.lax.bitcast_convert_type(q_sorted, jnp.int32)
    utab = jnp.stack(
        [
            jax.lax.bitcast_convert_type(uniq_hash, jnp.int32),
            row_len,
            row_start,
        ],
        axis=1,
    )  # (U, 3)
    at_row = utab[rows_c]  # (F, S, 3)
    i_idx = jnp.arange(S, dtype=jnp.int32)[None, :]
    found = (rows < U) & (at_row[:, :, 0] == q_i) & (i_idx < s_sizes[:, None])
    lens = jnp.where(
        found & (at_row[:, :, 1] < freq_threshold), at_row[:, :, 1], 0
    ).astype(jnp.int32)  # (F, S)

    # --- gather posting rows into ONE flat hit buffer -----------------------
    lens_flat = lens.reshape(-1)  # (F*S,) probe order == fragment order
    off_end = _scan2(jax.lax.cumsum, lens_flat)
    total = off_end[-1]
    ovf_hits = total > T
    off_begin = off_end - lens_flat

    # per-fragment minimum hit count, packed with the gather delta so it
    # costs no extra T-sized lookup
    m_frag = jnp.maximum(
        min_hits_table[
            jnp.clip(s_sizes, 0, min(S, min_hits_table.shape[0] - 1))
        ],
        1,
    )  # (F,)
    delta = at_row[:, :, 2].reshape(-1) - off_begin  # (F*S,)
    probe_pack = jnp.stack(
        [delta, jnp.broadcast_to(m_frag[:, None], (F, S)).reshape(-1)],
        axis=1,
    )  # (F*S, 2)

    # probe owning output slot t: scatter each non-empty probe's id at its
    # begin offset and cummax-fill forward (instead of a binary search per
    # output slot).
    probe_ids = jnp.arange(F * S, dtype=jnp.int32)
    scat = jnp.where(lens_flat > 0, jnp.minimum(off_begin, T), T)
    seg = jnp.zeros((T + 1,), jnp.int32).at[scat].max(probe_ids)
    seg = _scan2(jax.lax.cummax, seg[:T])  # (T,)
    t_idx = jnp.arange(T, dtype=jnp.int32)
    at_probe = probe_pack[seg]  # (T, 2) one gather
    src = at_probe[:, 0] + t_idx
    valid_t = t_idx < jnp.minimum(total, T)
    src_c = jnp.clip(src, 0, max(M - 1, 0))
    hit_frag = jnp.where(valid_t, seg // S, F)
    m_t = jnp.where(valid_t, at_probe[:, 1], 1)
    hit_gpos = jnp.where(valid_t, post_gpos[src_c], _GBIG)  # (T,) one gather

    # --- sort hits by (fragment, gpos) --------------------------------------
    # gpos is (seqId, wpos)-lexicographic by construction, so this is the
    # reference's (fragment, seqId, wpos) order with one key fewer.  The
    # sort permutes only within each fragment's fixed slot range (frag is
    # the primary key and slot ranges come from the prefix sums), so the
    # per-slot m_t computed above is already in sorted order.
    hit_frag, hit_gpos = jax.lax.sort((hit_frag, hit_gpos), num_keys=2)

    # --- m-consecutive-hit candidate windows --------------------------------
    # hits[t + m_t - 1] via a select over statically-shifted slices: the
    # runtime values of m_t are confined to the static ``m_values`` set
    hits2 = jnp.stack([hit_frag, hit_gpos], axis=1)  # (T, 2)
    mmax = max(m_values)
    padded = jnp.concatenate(
        [hits2, jnp.full((mmax, 2), _GBIG, jnp.int32)], axis=0
    )
    v0 = m_values[0]
    at_j2 = jax.lax.dynamic_slice_in_dim(padded, v0 - 1, T, axis=0)
    for v in m_values[1:]:
        at_j2 = jnp.where(
            (m_t == v)[:, None],
            jax.lax.dynamic_slice_in_dim(padded, v - 1, T, axis=0),
            at_j2,
        )
    frag_j2 = at_j2[:, 0]
    gpos_j2 = at_j2[:, 1]
    cand_ok = (
        (hit_frag < F)
        & (hit_gpos < _GBIG)
        & (t_idx + m_t - 1 < T)
        & (frag_j2 == hit_frag)
        & (gpos_j2 - hit_gpos < l)  # same contig implied: gaps >= l + 8
    )
    cand_gstart = gpos_j2 - l + 1  # unclamped; see docstring
    cand_gend = hit_gpos

    # --- merge overlapping candidates (in place) ----------------------------
    # candidates are in (frag, gpos) order; the previous *valid*
    # candidate is one exclusive cummax of marked indices + one gather.
    # Cross-contig pairs can never merge (cand_gstart lands in the dead
    # gap past the previous contig's last minimizer), so no seqId check.
    cand_idx = jnp.where(cand_ok, t_idx, -1)
    prev_idx = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), _scan2(jax.lax.cummax, cand_idx)[:-1]]
    )
    p_c = jnp.clip(prev_idx, 0, T - 1)
    at_prev = hits2[p_c]
    boundary = cand_ok & (
        (prev_idx < 0)
        | (at_prev[:, 0] != hit_frag)
        | (cand_gstart > at_prev[:, 1])
    )
    b_cum = _scan2(jax.lax.cumsum, boundary.astype(jnp.int32))
    b_excl = b_cum - boundary
    # boundaries before slot t live in b_excl; extend by the grand total
    # so per-fragment interval counts come from two gathers, not a scatter
    b_ext = jnp.concatenate([b_excl, b_cum[-1:]])  # (T + 1,)
    frag_start = off_begin.reshape(F, S)[:, 0]
    frag_next = jnp.concatenate(
        [frag_start[1:], jnp.minimum(total, T)[None]]
    )
    base = b_ext[jnp.clip(frag_start, 0, T)]  # (F,)
    n_iv = b_ext[jnp.clip(frag_next, 0, T)] - base
    ovf_iv = jnp.any(n_iv > ivmax)

    # Interval aggregates WITHOUT a T-sized scatter (the packed
    # segment_max was the single largest XLA op of the all-vs-all
    # dispatch).  Global interval j occupies the slot range
    # [pos_b[j], pos_b[j+1]) where pos_b[j] = first t with b_cum >= j+1
    # (a searchsorted over the monotone boundary prefix sum, NI keys);
    # its first member IS the boundary slot (iv_g0 = cand_gstart there,
    # the minimum -- gstart is nondecreasing within an interval), and
    # its last member is the last candidate at-or-before the next
    # boundary (an exclusive cummax of candidate slot indices + one NI
    # gather; iv_g1 = that slot's cand_gend, the maximum).
    NI = F * ivmax
    targets = jnp.arange(1, NI + 2, dtype=jnp.int32)
    pos_b = jnp.searchsorted(b_cum, targets, side="left").astype(jnp.int32)
    lastc = _scan2(jax.lax.cummax, jnp.where(cand_ok, t_idx, -1))
    e = jnp.clip(pos_b[1:] - 1, 0, T - 1)  # (NI,) end slot of interval j
    last_slot = jnp.clip(lastc[e], 0, T - 1)
    g0_flat = cand_gstart[jnp.clip(pos_b[:NI], 0, T - 1)]
    g1_flat = cand_gend[last_slot]
    take = jnp.clip(
        base[:, None] + jnp.arange(ivmax, dtype=jnp.int32)[None, :],
        0,
        NI - 1,
    )
    iv_g0 = g0_flat[take]
    iv_g1 = g1_flat[take]
    iv_valid = (
        jnp.arange(ivmax, dtype=jnp.int32)[None, :]
        < jnp.minimum(n_iv, ivmax)[:, None]
    )
    return iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv
