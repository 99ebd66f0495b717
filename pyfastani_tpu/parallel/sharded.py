"""Multi-device ANI: reference-genome-sharded index + data-parallel queries.

Scaling design (this is where the reference's single-host thread pool
becomes one device program -- see SURVEY.md §2a):

* the reference index is partitioned by **genome** across the ``shard``
  mesh axis (the EP-style axis): each device owns a self-contained
  sub-index (CSR posting lists + position-ordered minimizers) for a
  disjoint set of reference genomes, padded to a common size;
* query fragments are replicated across ``shard`` and partitioned across
  the ``data`` axis (DP);
* one ``shard_map`` program runs the full per-block pipeline -- device L1
  (`ops.l1`), the L2 sliding-intersection sweep over offset chunks
  (a GPU kernel on GPUs, the XLA event scan elsewhere), the identity
  gate via precomputed integer tables, and a
  dense per-bin CGI reduction merged across ``data`` with ``pmax`` -- so
  reciprocal-best filtering is exact across fragment blocks.

Positions use a 32-bit *global* coordinate (per-shard cumulative contig
offsets) so index probes need no 64-bit keys on device.

Integer outputs (matches/fragments) equal the host engine when the static
budgets suffice; overflow is detected and reported.  Identities
accumulate as exact fixed-point integers (`_engine_np.mean_identity`),
so the per-genome float32 means are bitwise-identical to the host
engine regardless of reduction order or mesh shape.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconfig import configure as _configure_jax

_configure_jax()
from jax.sharding import Mesh, PartitionSpec as P

from .. import stats
from ..ops.l1 import l1_candidates_device
from ..ops.l2 import l2_event_curve
from ..ops.l2_pallas import mini_prev_from_index

__all__ = ["ShardedIndex", "ShardedSession", "build_sharded_index", "sharded_query"]

_BIG = 2**30
# padding sentinel for GLOBAL-position arrays: per-shard global
# coordinates legitimately exceed 2**30 once a shard holds > ~1 Gbp of
# reference (the 512-genome bench does), so gpos pads use a sentinel
# near the int32 ceiling.  Real gpos + the comparison window (l) must
# stay below it -- enforced at build time.
_GBIG = 2**31 - 2**20


@dataclasses.dataclass
class ShardedIndex:
    """Stacked per-shard reference index arrays (leading axis = shard)."""

    uniq_hash: np.ndarray  # (n, U) u32, UMAX pad
    row_start: np.ndarray  # (n, U) i32
    row_len: np.ndarray  # (n, U) i32
    post_seqid: np.ndarray  # (n, M) i32
    post_wpos: np.ndarray  # (n, M) i32
    mini_hash: np.ndarray  # (n, M) u32 position-ordered
    mini_wpos: np.ndarray  # (n, M) i32
    mini_seqid: np.ndarray  # (n, M) i32
    mini_gpos: np.ndarray  # (n, M) i32 global coords, strictly increasing
    mini_prev: np.ndarray  # (n, M) i32 previous same-hash occurrence (wpos)
    contig_offset: np.ndarray  # (n, C+1) i32 cumulative global offsets
    seq_to_genome: np.ndarray  # (n, C) i32 contig -> local genome id
    freq_threshold: np.ndarray  # (n,) i32
    hash_bucket: np.ndarray  # (n, 2^bits+1) i32 hash-prefix table per shard
    bucket_steps: int  # max binary-search depth across shards
    genome_names: list  # list per shard of genome names
    genome_lengths: np.ndarray  # (n, G) i64
    n_shards: int
    # Parameters state the index was built under (``Parameters.to_state``);
    # carried through checkpoints so a restore can validate/recover the
    # sketch parameters like the reference pickle does (_fastani.pyx
    # __getstate__ keeps params with the sketch state)
    params_state: dict | None = None
    # prefix-bucket table over mini_gpos (global positions) so the L2
    # range searches run ~4 gather rounds instead of log2(M) (~26 at a
    # 56M-minimizer index); rebuilt lazily for checkpoints that predate it
    gpos_bucket: np.ndarray | None = None  # (n, 2^B + 1) i32
    gpos_shift: int = 0
    gpos_steps: int = 0
    # global positions of the hash-sorted postings (the device L1's only
    # per-hit coordinate; see ops/l1.py).  Rebuilt lazily for checkpoints
    # that predate it.
    post_gpos: np.ndarray | None = None  # (n, M) i32, _BIG pad

    @property
    def n_contig_slots(self) -> int:
        return int(self.seq_to_genome.shape[1])

    def save(self, path: str) -> None:
        """Checkpoint the sharded index to ``path`` (one ``.npz`` file).

        The multi-host recovery story (SURVEY.md §5): a restored index
        plus the frozen `Parameters` is everything `ShardedSession`
        needs, so an all-vs-all run can resume without re-sketching or
        re-partitioning the reference set.  Mirrors the reference's
        design of pickling flat arrays (``_fastani.pyx:842-865``) --
        except the sharded layout (partition, padding, global
        coordinates, prev-occurrence) is already built, so load is pure
        I/O with no index rebuild.
        """
        import json

        arrays = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        meta = {
            "bucket_steps": self.bucket_steps,
            "n_shards": self.n_shards,
            "genome_names": self.genome_names,
            "params_state": self.params_state,
            "gpos_shift": self.gpos_shift,
            "gpos_steps": self.gpos_steps,
        }
        if not path.endswith(".npz"):
            path += ".npz"  # savez appends it; keep load() symmetric
        np.savez_compressed(
            path,
            __meta__=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            ),
            **arrays,
        )

    @classmethod
    def load(cls, path: str) -> "ShardedIndex":
        """Restore a `save`d sharded index (see `save`)."""
        import json

        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
        return cls(**arrays, **meta)


def _build_gpos_bucket(mini_gpos: np.ndarray):
    """Per-shard prefix-bucket tables over the (sorted, _BIG-padded)
    global-position arrays: returns (bucket (n, 2^B+1) i32, shift, steps).

    Positions are near-uniform (unlike the winnowed hashes), so B is
    simply sized to ~16 entries per bucket, capped at 2^22 (16 MB)."""
    n, M = mini_gpos.shape
    m_real = [
        int(np.searchsorted(mini_gpos[sh], np.int32(_GBIG - 1)))
        for sh in range(n)
    ]
    max_gpos = 1
    for sh in range(n):
        if m_real[sh]:
            max_gpos = max(max_gpos, int(mini_gpos[sh, m_real[sh] - 1]))
    B = min(22, max(16, (max(m_real, default=16) // 16).bit_length()))
    shift = max(0, int(max_gpos).bit_length() - B)
    edges = (np.arange((1 << B) + 1, dtype=np.int64) << shift).clip(
        max=np.int64(2**31 - 1)
    )
    out = np.empty((n, (1 << B) + 1), np.int32)
    steps = 1
    for sh in range(n):
        g = mini_gpos[sh, : m_real[sh]].astype(np.int64)
        out[sh] = np.searchsorted(g, edges).astype(np.int32)
        mb = int(np.diff(out[sh]).max(initial=0))
        steps = max(steps, max(1, int(np.ceil(np.log2(mb + 1)))) if mb else 1)
    return out, shift, steps


def build_sharded_index(mapper, n_shards: int) -> ShardedIndex:
    """Partition a Mapper's reference set by genome into ``n_shards``
    balanced sub-indexes (greedy bin packing by minimizer count)."""
    from ..models import _engine_np as np_engine

    idx = mapper._index
    sbf = np.asarray(mapper._sequences_by_file, dtype=np.int64)
    n_genomes = len(mapper._names)
    contig_lo = np.concatenate([[0], sbf[:-1]])
    if n_shards > 1:  # the 1-shard fast path never partitions by genome
        genome_of_mini = np.searchsorted(sbf, idx.mini_seqid, side="right")
        counts = np.bincount(genome_of_mini, minlength=n_genomes)

        shard_of = np.zeros(n_genomes, dtype=np.int64)
        loads = np.zeros(n_shards, dtype=np.int64)
        for g in np.argsort(-counts, kind="stable"):
            tgt = int(np.argmin(loads))
            shard_of[g] = tgt
            loads[tgt] += counts[g]

    shards = []
    if n_shards == 1:
        # fast path: the whole Mapper index IS the single shard (contig ids
        # are already dense and position order is preserved) -- skip the
        # per-genome re-partition + re-sort
        n_ctg_total = int(sbf[-1]) if n_genomes else 0
        seq_to_genome = np.searchsorted(sbf, np.arange(n_ctg_total), side="right")
        shards.append(
            (
                idx,
                [int(g) for g in seq_to_genome],
                list(mapper._names),
                [int(x) for x in mapper._lengths],
            )
        )
    for sh in range(n_shards if n_shards > 1 else 0):
        genomes = np.flatnonzero(shard_of == sh)
        mh, ms, mw = [], [], []
        seq_to_genome = []
        names, lengths = [], []
        new_seq = 0
        for li, g in enumerate(genomes):
            sel = genome_of_mini == g
            n_ctg = int(sbf[g] - contig_lo[g])
            local_seq = idx.mini_seqid[sel] - contig_lo[g] + new_seq
            mh.append(idx.mini_hash[sel])
            ms.append(local_seq.astype(np.int32))
            mw.append(idx.mini_wpos[sel])
            seq_to_genome.extend([li] * n_ctg)
            new_seq += n_ctg
            names.append(mapper._names[g])
            lengths.append(int(mapper._lengths[g]))
        if mh:
            sub = np_engine.build_index(
                np.concatenate(mh), np.concatenate(ms), np.concatenate(mw)
            )
        else:
            sub = np_engine.build_index(
                np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int32)
            )
        shards.append((sub, seq_to_genome, names, lengths))

    def pad2(arrs, fill, dtype, min_width=1):
        width = max(max((a.shape[0] for a in arrs), default=1), min_width)
        if (
            n_shards == 1
            and len(arrs) == 1
            and arrs[0].shape[0] == width
            and arrs[0].dtype == np.dtype(dtype)
        ):
            # bench-scale indexes are hundreds of MB per array: return a
            # (1, width) view instead of an allocate+copy pass
            return np.ascontiguousarray(arrs[0])[None]
        out = np.empty((n_shards, width), dtype=dtype)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
            out[i, a.shape[0] :] = fill
        return out

    subs = [s[0] for s in shards]
    # per-shard global coordinates: offset each contig past the previous one
    offsets, gpos = [], []
    n_ctg_max = max(max((len(s[1]) for s in shards), default=1), 1)
    for sub, s2g, _, _ in shards:
        C = len(s2g)
        max_wpos = np.zeros(C, dtype=np.int64)
        if sub.mini_seqid.shape[0]:
            np.maximum.at(max_wpos, sub.mini_seqid, sub.mini_wpos.astype(np.int64))
        spans = max_wpos + mapper._param.min_read_length + 8
        off = np.zeros(n_ctg_max + 1, dtype=np.int64)
        off[1 : C + 1] = np.cumsum(spans)
        off[C + 1 :] = off[C]
        if int(off[C]) > _GBIG - 2 * mapper._param.min_read_length:
            raise ValueError(
                f"shard reference span {int(off[C])} bp exceeds the 32-bit "
                f"global-coordinate budget (~{_GBIG/1e9:.1f} Gbp per "
                "shard); partition across more shards"
            )
        offsets.append(off.astype(np.int32))
        gpos.append(
            (off[sub.mini_seqid] + sub.mini_wpos).astype(np.int32)
            if sub.mini_seqid.shape[0]
            else np.zeros(0, np.int32)
        )

    prev = [mini_prev_from_index(s) for s in subs]

    # global positions of the hash-sorted postings (device L1 coordinate):
    # the CSR sort permutation maps the position-ordered gpos straight
    # into posting order; fall back to offset arithmetic for edited subs
    from .. import _native

    post_gpos = []
    for (sub, _, _, _), gp, off in zip(shards, gpos, offsets):
        m = int(sub.post_seqid.shape[0])
        order = getattr(sub, "order", None)
        if order is not None and order.shape[0] == m == gp.shape[0]:
            post_gpos.append(_native.take_4byte(gp, order))
        else:
            post_gpos.append(
                (
                    off[sub.post_seqid].astype(np.int64) + sub.post_wpos
                ).astype(np.int32)
                if m
                else np.zeros(0, np.int32)
            )

    # bucket tables must share a width across shards (they stack into one
    # (n, 2^bits+1) array); rebuild every shard's at the widest choice
    bits_all = [
        int(s.hash_bucket.shape[0] - 1).bit_length() - 1 for s in subs
    ]
    common_bits = max(bits_all)
    bucket_tabs, bucket_steps_all = [], []
    for s in subs:
        tab, steps = np_engine.build_hash_bucket(s.uniq_hash, common_bits)
        bucket_tabs.append(tab)
        bucket_steps_all.append(steps)

    gpos2d = pad2(gpos, _GBIG, np.int32)
    gpos_bucket, gpos_shift, gpos_steps = _build_gpos_bucket(gpos2d)

    return ShardedIndex(
        uniq_hash=pad2([s.uniq_hash for s in subs], 0xFFFFFFFF, np.uint32),
        row_start=pad2([s.row_start.astype(np.int32) for s in subs], 0, np.int32),
        row_len=pad2([s.row_len for s in subs], 0, np.int32),
        post_seqid=pad2([s.post_seqid for s in subs], _BIG, np.int32),
        post_wpos=pad2([s.post_wpos for s in subs], _BIG, np.int32),
        mini_hash=pad2([s.mini_hash for s in subs], 0xFFFFFFFF, np.uint32),
        mini_wpos=pad2([s.mini_wpos for s in subs], _BIG, np.int32),
        mini_seqid=pad2([s.mini_seqid for s in subs], _BIG, np.int32),
        mini_gpos=gpos2d,
        mini_prev=pad2(prev, -_BIG, np.int32),
        contig_offset=np.stack(offsets),
        seq_to_genome=pad2(
            [np.asarray(s[1], np.int32) for s in shards], 0, np.int32,
            min_width=n_ctg_max,
        ),
        freq_threshold=np.asarray([s.freq_threshold for s in subs], np.int32),
        hash_bucket=np.stack(bucket_tabs).astype(np.int32),
        bucket_steps=max(bucket_steps_all),
        genome_names=[s[2] for s in shards],
        genome_lengths=pad2(
            [np.asarray(s[3], np.int64) for s in shards], 0, np.int64
        ),
        n_shards=n_shards,
        params_state=mapper._param.to_state(),
        gpos_bucket=gpos_bucket,
        gpos_shift=gpos_shift,
        gpos_steps=gpos_steps,
        post_gpos=pad2(post_gpos, _GBIG, np.int32),
    )


_CH_SLAB = 256  # chunk work items per inner step (wide slabs cut the
# sequential lax.map step count; per-slab memory is dominated by the
# (B, cmax+1) difference-array event buffer in ops.l2.l2_event_curve
# (~3.1 MB at B=256, cmax=3072) plus the (B, rmax) ref-minimizer gathers,
# which is what bounds further slab growth)


def _bucketed_gpos_search(mini_gpos, keys, bucket, shift: int, steps: int):
    """`searchsorted(mini_gpos, keys, 'left')` through the prefix-bucket
    table: ~`steps` gather rounds instead of log2(M) (26 at 56M minis)."""
    b = jnp.clip(
        (keys >> np.int32(shift)).astype(jnp.int32), 0, bucket.shape[0] - 2
    )
    lo = bucket[b]
    hi = bucket[b + 1]
    M = mini_gpos.shape[0]
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        v = mini_gpos[jnp.clip(mid, 0, max(M - 1, 0))]
        go_right = v < keys
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def _l2_interval_scan(
    q_sorted, s_sizes, frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid,
    mini_hash, mini_wpos, mini_gpos, mini_prev, contig_offset,
    cmw: int, cmax: int, rmax: int | None, ch_max: int, l2_kernel: str,
    gpos_aux=None,
):
    """(best, first, last, ovf_chunks, ovf_r) per interval; ``ovf_r`` is
    None on the kernel paths, which have no ``rmax`` budget.

    Work is compacted on device into per-chunk items (interval x offset
    chunk); invalid interval slots produce no work.  Each chunk's
    reference range is clamped to its contig's minimizer block, so
    ranges are contig-pure and no per-minimizer seqid plane is needed.
    ``l2_kernel`` picks the chunk evaluator (bit-identical outputs, see
    tests/test_l2_pallas.py):

    * ``"xla"``: a ``lax.map`` over chunk slabs running the event scan
      (`ops.l2.l2_event_curve`) on ``rmax``-wide gathers -- the CPU path;
    * ``"triton"``: the GPU kernel (`ops.l2_pallas`), one program per
      chunk, any range length;
    * ``"interpret"``: the same kernel through the Pallas interpreter
      (tests only).

    Per-interval results merge back with segment reductions either way.
    """
    from ..ops.l1 import _scan2

    NI = iv_seq.shape[0]
    span = jnp.where(iv_valid, iv_c1 - iv_c0 + 1, 0)
    n_ch = (span + cmax - 1) // cmax
    ends = _scan2(jax.lax.cumsum, n_ch)
    total = ends[-1]
    starts = ends - n_ch

    j = jnp.arange(ch_max, dtype=jnp.int32)
    # owning interval per chunk slot: scatter each non-empty interval's
    # id at its first slot + cummax fill
    scat0 = jnp.where(n_ch > 0, jnp.minimum(starts, ch_max), ch_max)
    iv_of = jnp.zeros((ch_max + 1,), jnp.int32).at[scat0].max(
        jnp.arange(NI, dtype=jnp.int32)
    )
    iv_of = _scan2(jax.lax.cummax, iv_of[:ch_max])
    iv_of_c = jnp.clip(iv_of, 0, NI - 1)
    t = j - starts[iv_of_c]
    ch_c0 = iv_c0[iv_of_c] + t * cmax
    ch_len = jnp.clip(iv_c1[iv_of_c] - ch_c0 + 1, 0, cmax)
    ch_valid = j < total
    overflow = total > ch_max

    ch_frag = frag_of_iv[iv_of_c]
    ch_seq = iv_seq[iv_of_c]
    seq_c = jnp.clip(ch_seq, 0, contig_offset.shape[0] - 2)
    ch_base = contig_offset[seq_c]

    # reference range of each chunk: the minimizers whose global
    # position lies in [c0, c0 + clen - 1 + cmw), clamped to the chunk's
    # contig (a window ending at a contig's tail can spill a few
    # entries into the next contig's coordinates)
    key_lo = ch_base + ch_c0
    key_hi = ch_base + jnp.minimum(ch_c0 + ch_len - 1 + cmw, _BIG)
    if gpos_aux is not None:
        gb, gshift, gsteps = gpos_aux
        lo = _bucketed_gpos_search(mini_gpos, key_lo, gb, gshift, gsteps)
        hi = _bucketed_gpos_search(mini_gpos, key_hi, gb, gshift, gsteps)
    else:
        lo = jnp.searchsorted(mini_gpos, key_lo).astype(jnp.int32)
        hi = jnp.searchsorted(mini_gpos, key_hi).astype(jnp.int32)
    cof_idx = jnp.searchsorted(mini_gpos, contig_offset).astype(jnp.int32)
    lo = jnp.maximum(lo, cof_idx[seq_c])
    hi = jnp.minimum(hi, cof_idx[seq_c + 1])
    rlen = jnp.where(ch_valid, jnp.maximum(hi - lo, 0), 0)
    clen_eff = jnp.where(ch_valid, ch_len, 0)

    if l2_kernel == "xla":
        M = mini_hash.shape[0]
        rovf = jnp.any(rlen > rmax)

        def slab_fn(args):
            frag, lo_s, rlen_s, c0, clen = args
            j_idx = jnp.arange(rmax, dtype=jnp.int32)[None, :]
            gidx = jnp.clip(lo_s[:, None] + j_idx, 0, max(M - 1, 0))
            valid_j = j_idx < rlen_s[:, None]
            rh = jnp.where(valid_j, mini_hash[gidx], jnp.uint32(0xFFFFFFFF))
            rp = jnp.where(valid_j, mini_wpos[gidx], _BIG)
            return l2_event_curve(
                q_sorted[frag], s_sizes[frag], rh, rp, valid_j, c0, clen,
                cmax, cmw,
            )

        n_slabs = ch_max // _CH_SLAB
        args = tuple(
            a.reshape(n_slabs, _CH_SLAB)
            for a in (ch_frag, lo, rlen, ch_c0, clen_eff)
        )
        cbest, cfirst, clast = jax.lax.map(slab_fn, args)
        cbest = cbest.reshape(-1)
        cfirst = cfirst.reshape(-1)
        clast = clast.reshape(-1)
    else:
        from ..ops.l2_pallas import l2_chunks_pallas

        # the kernel takes any range length: no rmax budget to overflow
        rovf = None
        cbest, cfirst, clast = l2_chunks_pallas.__wrapped__(
            q_sorted, s_sizes, mini_hash, mini_wpos, mini_prev,
            ch_frag, ch_c0, clen_eff, lo, rlen,
            cmw=cmw, interpret=l2_kernel == "interpret",
        )

    # merge chunk results per interval (max + first/last argmax)
    seg = jnp.where(ch_valid, iv_of_c, NI)
    best = jax.ops.segment_max(cbest, seg, num_segments=NI + 1)[:NI]
    is_best = ch_valid & (cbest == best[iv_of_c])
    first = jax.ops.segment_min(
        jnp.where(is_best, cfirst, _BIG), seg, num_segments=NI + 1
    )[:NI]
    last = jax.ops.segment_max(
        jnp.where(is_best, clast, -_BIG), seg, num_segments=NI + 1
    )[:NI]
    best = jnp.where(iv_valid & (n_ch > 0), best, -1)
    return best, first, last, overflow, rovf


def _query_block_impl(
    frags,
    frag_qg,
    uniq_hash, row_start, row_len, post_gpos,
    mini_hash, mini_wpos, mini_gpos, mini_prev, contig_offset,
    seq_to_genome, freq_threshold, hash_bucket,
    min_hits_table, gate_table, ident_table,
    k: int, w: int, length: int, protein: bool, l: int,
    hmax: int, ivmax: int, cmax: int, rmax: int | None, t_chunks: int,
    g_max: int, bin_max: int, smax: int = 512, q_count: int = 1,
    bucket_steps: int = 21, l2_kernel: str = "xla",
    gpos_aux=None, m_values: tuple = (1, 2, 3, 4),
):
    """Device-only query step for one fragment block vs one index shard.

    ``frag_qg`` assigns each fragment row to one of ``q_count`` query
    genomes, so a whole batch of query genomes maps in a single dispatch
    (the fragment axis is shared; every reduction is keyed by genome).

    Returns (best_bin (q_count*C*bin_max,) f32 -- per-(query genome, ref
    bin) best identity with fragment-level reciprocal filtering applied,
    merged across "data" by the caller -- and overflow flag)."""
    from ..ops.fragments import _winnow_fragments_impl

    F = frags.shape[0]
    cmw = l - (k - 1)

    # call the unjitted bodies: nested jit caches leak tracers in shard_map
    kc = min(smax + 128, length)
    rec_ovf, _, q_sorted, s_sizes = _winnow_fragments_impl.__wrapped__(
        frags, k, w, length, protein, kc
    )
    # bound the sketch axis: sketches are ~2*l/w hashes; overflow is flagged
    s_overflow = jnp.any(s_sizes > smax) | rec_ovf
    q_sorted = q_sorted[:, : min(smax, q_sorted.shape[1])]

    iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv = (
        l1_candidates_device.__wrapped__(
            q_sorted, s_sizes, uniq_hash, row_start, row_len,
            post_gpos, freq_threshold, min_hits_table,
            hash_bucket, hmax, ivmax, l, bucket_steps, m_values,
        )
    )
    # recover contig ids + contig-local coordinates per merged interval
    # (a per-interval searchsorted over the tiny contig table -- L1 itself
    # never touches seqIds).  iv_g1 is a real minimizer's gpos, so it
    # always lands inside its contig's range; iv_g0 may precede the
    # contig base (window-start clamp) and is clamped here.
    C1 = contig_offset.shape[0]
    g0f = iv_g0.reshape(-1)
    g1f = iv_g1.reshape(-1)
    iv_seq = jnp.clip(
        jnp.searchsorted(contig_offset, g1f, side="right").astype(jnp.int32)
        - 1,
        0,
        C1 - 2,
    )
    iv_base = contig_offset[iv_seq]
    iv_c0 = jnp.maximum(g0f, iv_base) - iv_base
    iv_c1 = g1f - iv_base

    frag_of_iv = jnp.repeat(jnp.arange(F, dtype=jnp.int32), ivmax)
    # chunk budget: ~t_chunks chunks per fragment on average
    ch_max = -(-(F * t_chunks) // _CH_SLAB) * _CH_SLAB
    best, first, last, ovf_ch, ovf_r = _l2_interval_scan(
        q_sorted, s_sizes,
        frag_of_iv, iv_seq, iv_c0, iv_c1,
        iv_valid.reshape(-1), mini_hash, mini_wpos, mini_gpos,
        mini_prev, contig_offset, cmw, cmax, rmax, ch_max, l2_kernel,
        gpos_aux,
    )
    # per-budget overflow flags: [smax, hmax, ivmax, t_chunks] (+ rmax on
    # the XLA path)
    flags = [s_overflow, ovf_hits, ovf_iv, ovf_ch]
    if ovf_r is not None:
        flags.append(ovf_r)
    ovf_vec = jnp.stack([f.astype(jnp.int32) for f in flags])

    s_iv = s_sizes[frag_of_iv]
    gate = gate_table[jnp.clip(s_iv, 0, gate_table.shape[0] - 1)]
    mapped = iv_valid.reshape(-1) & (best > 0) & (best >= gate)

    # plateau midpoint of best record anchors, reported at window end
    # (see the position note in _engine_np._map_fragment)
    mean_pos = (first + last) // 2 + (cmw - 1)
    rbin = jnp.clip(mean_pos // l, 0, bin_max - 1)
    C = seq_to_genome.shape[0]
    seq_c = jnp.clip(iv_seq, 0, C - 1)
    gid = seq_to_genome[seq_c]

    # identity via the host-exact float32 table (bit-identical to the host
    # engine, including distinct shared counts that round to the same f32)
    smax_tab = ident_table.shape[0] - 1
    ident = ident_table[
        jnp.clip(s_iv, 0, smax_tab), jnp.clip(best, 0, smax_tab)
    ]

    # CGI step 1: a SINGLE best mapping per (genome, fragment), max float32
    # identity with ties to the first candidate interval in (seqId, pos)
    # order -- the same rule as the host compute_cgi.  Two reductions:
    # group max identity, then the smallest interval index attaining it.
    NIV = int(best.shape[0])
    iv_arange = jnp.arange(NIV, dtype=jnp.int32)
    n_seg = F * (g_max + 1) + g_max + 1
    fg = frag_of_iv * (g_max + 1) + jnp.where(mapped, gid, g_max)
    best_fg = jax.ops.segment_max(
        jnp.where(mapped, ident, jnp.float32(-1.0)), fg, num_segments=n_seg
    )
    tied = mapped & (ident == best_fg[fg])
    first_iv = jax.ops.segment_min(
        jnp.where(tied, iv_arange, jnp.int32(NIV)), fg, num_segments=n_seg
    )
    keep1 = tied & (iv_arange == first_iv[fg])

    # CGI step 2: dense per-(query genome, contig, bin) best identity
    qg_of_iv = frag_qg[frag_of_iv]
    cbin = jnp.where(
        keep1,
        qg_of_iv * (C * bin_max) + seq_c * bin_max + rbin,
        q_count * C * bin_max,
    )
    best_bin = jax.ops.segment_max(
        jnp.where(keep1, ident, -1.0),
        cbin,
        num_segments=q_count * C * bin_max + 1,
    )[: q_count * C * bin_max]
    return best_bin, ovf_vec


# jitted entry for single-block use (the sharded path calls the impl inside
# shard_map, where a nested jit cache would leak tracers across meshes)
_query_block = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "w", "length", "protein", "l", "hmax", "ivmax", "cmax", "rmax",
        "t_chunks", "g_max", "bin_max", "smax", "q_count", "bucket_steps",
        "l2_kernel", "m_values",
    ),
)(_query_block_impl)


def _put(arr, sharding):
    """Place a host array on the mesh.

    Single-process: plain `device_put`.  Multi-process (a mesh spanning
    hosts after `jax.distributed.initialize`): every process holds the
    full host array (the sharded index build and query staging are
    deterministic, SPMD-style), so each process materializes only its
    addressable shards via `make_array_from_callback`.
    """
    import jax

    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def _l2_kernel_for(platform: str, interpret: bool = False) -> str:
    """The L2 chunk evaluator for a device platform: the GPU kernel on
    ``"gpu"``, the XLA event scan elsewhere.  ``interpret`` runs the
    kernel through the Pallas interpreter on any platform (tests)."""
    if interpret:
        return "interpret"
    return "triton" if platform == "gpu" else "xla"


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def _presize_rmax(sidx: "ShardedIndex", cmax: int, cmw: int) -> int:
    """Reference minimizers per L2 chunk range, the XLA event scan's
    gather width: *exactly* the densest ``cmax + cmw`` global-position
    window of any shard's minimizer store (then padded), so the rmax
    escalation path never triggers."""
    from .. import _native

    worst = 1
    for sh in range(sidx.n_shards):
        gpos = sidx.mini_gpos[sh]
        m_real = int(np.searchsorted(gpos, np.int32(_GBIG - 1)))
        if m_real:
            # one two-pointer C pass
            worst = max(worst, _native.densest_window(gpos[:m_real], cmax + cmw))
    return min(_round_up(worst + 8, 128), 8192)


def _presize_budgets(
    sidx: "ShardedIndex", params, overrides: dict, l2_kernel: str = "xla"
) -> dict:
    """Derive the static device budgets from index statistics so typical
    workloads run with zero overflow escalations (VERDICT: budgets must be
    estimated from posting-row stats before first compile).

    * ``smax``: sketch hashes per fragment -- bounded by the minimizer
      density ~2/(w+1) with a 1.5x margin;
    * ``rmax`` (``l2_kernel == "xla"`` only; the kernel takes any range
      length): see `_presize_rmax`;
    * ``hmax``: seed hits per fragment **on average** (the device L1 hit
      buffer is a flat ``F * hmax`` axis shared by the batch, so only the
      batch mean matters, not the worst fragment) -- the typical sketch
      size ~2l/(w+1) times the mean posting-row length with a 3x margin;
    * ``t_chunks``: L2 offset chunks per fragment on average -- one chunk
      covers one candidate interval (interval spans are ~l <= cmax), and
      the expected number of intervals per fragment tracks how many
      genomes share a fragment's minimizers, which the index exposes as
      the mean posting-row length (each similar genome contributes ~1
      occurrence per row).
    """
    l = params.min_read_length
    k, w = params.kmer_size, params.window_size
    cmw = l - (k - 1)

    cmax = overrides.get("cmax") or 3072
    # fragment sketch sizes concentrate hard around 2(l-k+1)/(w+1)
    # (mean 238, std 7.6, max 266 over 3000 random 3 kb fragments at
    # w=24, host engine); the budget is 1.5x that, 128-granular
    smax = overrides.get("smax") or max(
        128,
        min(
            _round_up(3 * l // (w + 1), 128),
            _round_up(l - k + 1, 128),
        ),
    )

    n_post = sum(
        int(np.searchsorted(sidx.mini_gpos[sh], np.int32(_GBIG - 1)))
        for sh in range(sidx.n_shards)
    )
    n_uniq = int((sidx.uniq_hash != np.uint32(0xFFFFFFFF)).sum())
    mean_row = (n_post / n_uniq) if n_uniq else 1.0
    # the expected seed hits per QUERY hash are SIZE-BIASED: a hash shared
    # by k reference genomes appears in ~k genomes' sketches, so a hash
    # drawn from a genome-like query lands on a row with probability
    # proportional to the row's length -- E[r^2]/E[r], not E[r].  (The
    # r04 formula used E[r] and under-provisioned hmax by ~1.5x on
    # family-structured panels, escalating mid-run.)
    rl64 = sidx.row_len.astype(np.float64)
    sum_r = float(rl64.sum())
    biased_row = float((rl64 * rl64).sum() / sum_r) if sum_r else 1.0
    biased_row = max(biased_row, mean_row, 1.0)

    hmax = overrides.get("hmax")
    if not hmax:
        # average hits/fragment = typical sketch size x mean row length;
        # 1.5x margin absorbs batch-to-batch variance (the budget bounds
        # the batch TOTAL, so per-fragment variance averages out by CLT;
        # a self-query batch -- every sketch hash found -- sits at ~1.0x,
        # and a whole-batch distribution shift escalates once per
        # session).  Every T-sized L1 pass scales with this, so margin
        # is device time.
        s_hat = max(2 * l // (w + 1), 16)
        # 1.2x margin: the budget bounds the batch TOTAL (per-fragment
        # variance averages out by CLT over thousands of fragments), and
        # the size-biased estimator measured within 0.2% of the real
        # batch mean on the 512-genome panel; every T-sized L1 pass
        # scales with this margin, and escalation (one recompile per
        # session) covers genuine distribution shifts
        hmax = _round_up(max(1.2 * s_hat * biased_row, 384), 128)
        hmax = min(hmax, 16384)

    # bin_max: reference-position bins per contig.  Bins index
    # mean_pos // l with mean_pos < contig span; spans are recorded in
    # contig_offset (max wpos + l + 8), so the exact per-shard maximum is
    # known at build time.  Under-provisioning would silently merge tail
    # bins, so derive with margin rather than flag-and-escalate.
    bin_max = overrides.get("bin_max")
    if not bin_max:
        max_span = 1
        for sh in range(sidx.n_shards):
            d = np.diff(sidx.contig_offset[sh].astype(np.int64))
            if d.size:
                max_span = max(max_span, int(d.max()))
        bin_max = min(max(_round_up(max_span // l + 2, 64), 64), 4096)

    # ivmax: merged L1 candidate intervals per fragment.  Candidates are
    # l-windows holding >= m seed hits; after merging, a fragment sees a
    # few per *similar* genome -- and cross-genome similarity is what the
    # mean posting-row length measures (each similar genome contributes
    # ~1 occurrence per row).  Sizing from the genome count (the old
    # rule) made the interval axis scale with the reference set: at 256
    # genomes/shard every NIV-sized reduction carried 64x dead slots.
    # 8x margin + escalation-on-overflow keeps it honest.
    ivmax = overrides.get("ivmax")
    if not ivmax:
        # every NIV = F*ivmax-sized CGI reduction scales with this;
        # real interval counts are ~1 per similar genome, so floor 16
        # with escalation instead of the old floor 48
        ivmax = min(max(_round_up(int(6 * biased_row) + 10, 8), 16), 256)

    # t_chunks: average L2 chunks per fragment.  Expected candidate
    # intervals per fragment ~= genomes sharing its minimizers ~= the mean
    # posting-row length; each interval spans ~l <= cmax so needs one
    # chunk.  2x margin, floor 8 (the r03 bench escalated the hardcoded 4).
    # (a 2x-mean_row rule under-provisioned a family-structured index --
    # mean_row 2.0 escalated 6 -> 12 mid-warmup; similar genomes
    # contribute ~2 chunks per matching locus once intervals merge
    # across l-sized windows, so budget 4 chunks per row-mate + slack)
    t_chunks = overrides.get("t_chunks")
    if not t_chunks:
        # chunks per fragment are driven by WEAKLY similar genomes (one
        # interval each from just m shared hashes), which no row
        # statistic predicts tightly -- the 512-genome cross-family
        # bench measured ~15-25 real chunks/fragment where the row mean
        # suggested ~9.  Empty chunk slots cost little on either L2
        # path, so budget generously
        t_chunks = max(12, int(np.ceil(8.0 * biased_row)) + 8)

    out = dict(
        hmax=int(hmax),
        ivmax=int(ivmax),
        cmax=int(cmax),
        t_chunks=int(t_chunks),
        bin_max=int(bin_max),
        smax=int(smax),
    )
    if l2_kernel == "xla":
        out["rmax"] = int(overrides.get("rmax") or _presize_rmax(sidx, cmax, cmw))
    return out


class ShardedSession:
    """Reusable multi-chip query session: the sharded index lives on the
    devices and ONE shard_map program (fixed fragment/genome capacities)
    is compiled per mesh, so successive queries of any batch shape pay
    only dispatch + data transfer for the query fragments."""

    def __init__(
        self,
        mapper,
        mesh: Mesh,
        hmax: int | None = None,
        ivmax: int | None = None,
        cmax: int | None = None,
        rmax: int | None = None,
        t_chunks: int | None = None,
        bin_max: int | None = None,
        smax: int | None = None,
        q_capacity: int = 16,
        frag_capacity: int = 4096,
        index: "ShardedIndex | None" = None,
        params=None,
        interpret_kernels: bool = False,
    ):
        from jax import shard_map

        self.mapper = mapper
        self.mesh = mesh
        self.params = params if params is not None else mapper._param
        params = self.params
        l = params.min_read_length
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        self.q_capacity = max(1, int(q_capacity))
        self.frag_capacity = _round_up(max(int(frag_capacity), self.n_data), self.n_data)
        if index is not None:
            if index.n_shards != self.n_shard:
                raise ValueError(
                    f"restored index has {index.n_shards} shards, "
                    f"mesh has {self.n_shard}"
                )
            sidx = index
        else:
            sidx = build_sharded_index(mapper, self.n_shard)
        if sidx.gpos_bucket is None:
            # checkpoint predating the gpos prefix table: rebuild it
            (
                sidx.gpos_bucket,
                sidx.gpos_shift,
                sidx.gpos_steps,
            ) = _build_gpos_bucket(sidx.mini_gpos)
        if sidx.post_gpos is None:
            # checkpoint predating the posting-gpos plane: rebuild it from
            # the posting coordinates + contig offsets
            pg = np.full_like(sidx.post_wpos, _GBIG)
            for sh in range(sidx.n_shards):
                ps = sidx.post_seqid[sh]
                real = ps < sidx.contig_offset.shape[1] - 1
                off = sidx.contig_offset[sh].astype(np.int64)
                pg[sh, real] = (
                    off[ps[real]] + sidx.post_wpos[sh, real]
                ).astype(np.int32)
            sidx.post_gpos = pg
        self.sidx = sidx
        self._l2_kernel = _l2_kernel_for(
            mesh.devices.flat[0].platform, interpret_kernels
        )
        self.budgets = _presize_budgets(
            sidx, params,
            dict(hmax=hmax, ivmax=ivmax, cmax=cmax, rmax=rmax,
                 t_chunks=t_chunks, bin_max=bin_max, smax=smax),
            self._l2_kernel,
        )

        tab_hi = max(l, 1)
        mh_tab = stats.min_hits_relaxed_table(
            tab_hi, params.kmer_size, params.percentage_identity
        )
        gate_tab = stats.l2_gate_table(
            tab_hi, params.kmer_size, params.percentage_identity
        )
        self._ident_tab = None  # (smax+1)^2 f32, rebuilt on smax escalation
        g_max = int(sidx.genome_lengths.shape[1])
        self._g_max = g_max

        self._fn = None  # THE compiled shard_map program (one per mesh)
        # park the index on the devices once, already laid out for the
        # shard_map program (avoids a reshard on every query dispatch)
        from jax.sharding import NamedSharding

        sh2 = NamedSharding(mesh, P("shard", None))
        sh1 = NamedSharding(mesh, P("shard"))
        rep = NamedSharding(mesh, P())
        self._index_args = (
            _put(sidx.uniq_hash, sh2),
            _put(sidx.row_start, sh2),
            _put(sidx.row_len, sh2),
            _put(sidx.post_gpos, sh2),
            _put(sidx.mini_hash, sh2),
            _put(sidx.mini_wpos, sh2),
            _put(sidx.mini_gpos, sh2),
            _put(sidx.mini_prev, sh2),
            _put(sidx.contig_offset, sh2),
            _put(sidx.seq_to_genome, sh2),
            _put(sidx.freq_threshold, sh1),
            # (lo, hi) bucket-row pairs: one probe gather instead of two
            _put(
                np.stack(
                    [sidx.hash_bucket[:, :-1], sidx.hash_bucket[:, 1:]],
                    axis=-1,
                ),
                NamedSharding(mesh, P("shard", None, None)),
            ),
            _put(np.asarray(mh_tab), rep),
            _put(np.asarray(gate_tab), rep),
        )
        self._mh_tab = np.asarray(mh_tab)
        self._gpos_bucket_dev = _put(sidx.gpos_bucket, sh2)
        # reentrancy: the reference documents query_* as safe to call
        # concurrently from Python threads (_fastani.pyx:1157-1162); this
        # session recycles staging buffers and mutates budget/program
        # state per call, so concurrent queries serialize on one lock
        # (the chip is a serial resource anyway -- use `query_many` to
        # batch for throughput).
        import threading

        self._lock = threading.Lock()
        # observability (SURVEY.md §5 metrics gap): cumulative session
        # counters, exposed as a plain dict
        self.stats = {
            "dispatches": 0,
            "genomes_queried": 0,
            "fragments_dispatched": 0,
            "fragments_padded": 0,
            "budget_escalations": 0,
            "capacity_growths": 0,
            "compiled_variants": 0,
        }

    @classmethod
    def from_index(cls, index: ShardedIndex, params=None, mesh: Mesh = None, **kwargs):
        """Build a session from a restored `ShardedIndex` checkpoint.

        ``params`` is the frozen `Parameters` the index was built under
        (`Mapper.parameters` equivalent); pass `None` to restore them
        from the checkpoint itself (indexes built by `build_sharded_index`
        carry them).  A mismatch between an explicit ``params`` and the
        checkpointed ones raises -- restoring an index under different
        k/w/l would silently produce wrong ANI.  This is the multi-host
        resume path: every process loads the checkpoint and constructs
        the session against its (possibly process-spanning) mesh without
        a `Mapper` or a re-partition.
        """
        from ..models._params import Parameters

        saved = (
            Parameters.from_state(index.params_state)
            if index.params_state
            else None
        )
        if params is None:
            if saved is None:
                raise ValueError(
                    "checkpoint carries no Parameters; pass params= explicitly"
                )
            params = saved
        elif saved is not None and params != saved:
            raise ValueError(
                f"params mismatch: index was built under {saved}, "
                f"got {params}"
            )
        return cls(None, mesh, index=index, params=params, **kwargs)

    def _fragments(self, contigs):
        """Per-contig fragment blocks: list of (n_i, l) uint8 views (no
        per-fragment Python objects), plus fragment/length totals."""
        import warnings

        from ..ops import codec

        params = self.params
        l = params.min_read_length
        blocks = []
        total_fragments = 0
        total_length = 0
        for contig in contigs:
            data = codec.to_bytes(contig)
            slen = int(data.shape[0])
            if slen < min(params.window_size, params.kmer_size, l):
                # parity with Mapper._query_draft (ref _fastani.pyx:1062-1070)
                warnings.warn(
                    (
                        "Mapper received a short sequence relative to "
                        "parameters, mapping will not be computed."
                    ),
                    UserWarning,
                    stacklevel=3,
                )
                continue
            n_frag = slen // l
            if n_frag:
                blocks.append(
                    np.asarray(data[: n_frag * l]).reshape(n_frag, l)
                )
            total_fragments += n_frag
            total_length += slen
        return blocks, total_fragments, total_length

    def _frag_bucket(self, need: int) -> int:
        """Dispatch capacity for a group of ``need`` fragments.

        Power-of-two buckets up to 1024 then 1024-granular, clamped to
        ``frag_capacity``: full groups of an all-vs-all batch dispatch at
        the top capacity while a small batch compiles (and persistently
        caches) one proportionate program instead of paying the top
        bucket's padding (the r02 regression: a 2668-fragment batch
        padded to a monolithic 4096 x 16 program cost +54% device work
        on every dispatch)."""
        if need <= 1024:
            b = max(256, 1 << (max(need, 1) - 1).bit_length())
        else:
            b = _round_up(need, 1024)
        return max(1, min(_round_up(b, self.n_data), self.frag_capacity))

    def _get_fn(self):
        """Build (once) the jitted shard_map program wrapper.

        The fragment axis is *not* baked in: each distinct padded batch
        shape traces and compiles its own executable under this one jit
        (bucketed by `_frag_bucket` to bound the variant count, and
        persisted across processes by the compilation cache)."""
        if self._fn is not None:
            return self._fn
        self.stats["compiled_variants"] += 1
        from jax import shard_map

        params = self.params
        l = params.min_read_length
        b = self.budgets
        g_max = self._g_max
        bin_max = b["bin_max"]
        q_count = self.q_capacity

        bucket_steps = self.sidx.bucket_steps

        # the reachable min-hits values (static: drives the L1 window
        # check's shift-select, ops/l1.py)
        m_values = tuple(
            sorted(
                {
                    int(max(int(v), 1))
                    for v in self._mh_tab[: min(b["smax"], l) + 1]
                }
            )
        )
        gpos_shift = self.sidx.gpos_shift
        gpos_steps = self.sidx.gpos_steps

        def block_fn(frags_b, qg_b, uniq, rstart, rlen, pgpos,
                     mhash, mwpos, mgpos, mprev, coff, s2g, thr,
                     hb, mht, gt, it2d, gb2):
            best_bin, ovf_vec = _query_block_impl(
                frags_b, qg_b, uniq[0], rstart[0], rlen[0], pgpos[0],
                mhash[0], mwpos[0], mgpos[0], mprev[0], coff[0],
                s2g[0], thr[0], hb[0], mht, gt, it2d,
                params.kmer_size, params.window_size, l,
                params.alphabet_size != 4, l,
                b["hmax"], b["ivmax"], b["cmax"], b.get("rmax"), b["t_chunks"],
                g_max, bin_max, b["smax"], q_count, bucket_steps,
                self._l2_kernel,
                (gb2[0], gpos_shift, gpos_steps) if gpos_steps else None,
                m_values,
            )
            best_bin = jax.lax.pmax(best_bin, "data")
            ovf_vec = jax.lax.pmax(ovf_vec, "data")  # 0/1 flags: pmax == OR
            C = s2g.shape[1]
            # bins are contiguous per (query genome, contig): reduce the
            # bin axis with a vectorized sum first (a segment_sum keyed
            # over the full q*C*bin_max axis is a serialized scatter),
            # then fold the tiny (q, C) per-contig totals into genomes.
            # Identities accumulate as EXACT fixed-point integers (the
            # 2^17 grid of `_engine_np.mean_identity`) split into 12-bit
            # limbs, so the reduction order cannot perturb the mean and
            # the engines stay bitwise-equal by construction.
            bb3 = best_bin.reshape(q_count, C, bin_max)
            occ = bb3 > 0.0
            q17 = jnp.round(bb3 * jnp.float32(131072.0)).astype(jnp.int32)
            q17 = jnp.where(occ, q17, 0)
            counts_qc = occ.sum(axis=2).astype(jnp.int32)  # (q, C)
            hi_qc = (q17 >> 12).sum(axis=2).astype(jnp.int32)
            lo_qc = (q17 & 0xFFF).sum(axis=2).astype(jnp.int32)
            key = (
                jnp.arange(q_count, dtype=jnp.int32)[:, None] * g_max + s2g[0]
            ).reshape(-1)

            def fold(x_qc):
                return jax.ops.segment_sum(
                    x_qc.reshape(-1), key, num_segments=q_count * g_max
                ).reshape(q_count, g_max)

            counts = fold(counts_qc)
            isum_hi = fold(hi_qc)
            isum_lo = fold(lo_qc)
            return counts[None], isum_hi[None], isum_lo[None], ovf_vec[None]

        si = P("shard", None)
        fn = jax.jit(shard_map(
            block_fn,
            mesh=self.mesh,
            in_specs=(
                P("data", None), P("data"),
                si, si, si, si, si, si, si, si, si, si, P("shard"),
                P("shard", None, None), P(None), P(None), P(None, None), si,
            ),
            out_specs=(
                P("shard", None, None), P("shard", None, None),
                P("shard", None, None), P("shard", None),
            ),
            # the L2 kernel's pallas_call outputs carry no varying-mesh-axes
            # metadata (nor does its interpreter track any); the out_specs
            # above are authoritative
            check_vma=False,
        ))
        self._fn = fn
        return fn

    def _prepare_tables(self):
        """(Re)build the budget-derived identity table when ``smax``
        changed."""
        from jax.sharding import NamedSharding

        smax = self.budgets["smax"]
        if self._ident_tab is None or self._ident_tab.shape[0] != smax + 1:
            self._ident_tab = _put(
                stats.identity_table(smax, self.params.kmer_size),
                NamedSharding(self.mesh, P()),
            )

    def _submit_group(self, per_genome, group, slot, force_bucket=None):
        """Stage one <= q_capacity-genome group into staging-buffer
        ``slot`` and dispatch it WITHOUT blocking.

        jax dispatch is asynchronous: returning the device handles lets
        the caller stage and upload the next group while this one
        computes, hiding host staging and the h2d transfer behind device
        time.  Two staging buffers alternate; the caller must wait on the
        previous occupant's input array before reusing a slot.
        """
        from jax.sharding import NamedSharding

        params = self.params
        l = params.min_read_length
        need = sum(per_genome[gi][1] for gi in group)
        Fcap = force_bucket or self._frag_bucket(need)

        # reuse staging buffers across calls: a full fragment block is
        # tens of MB, so recycling it saves a fresh allocation (and its
        # page faults) on every query
        bufs = getattr(self, "_frag_bufs", None)
        if bufs is None:
            self._frag_bufs = bufs = {}
        buf = bufs.get(slot)
        if buf is None or buf[0].shape[0] < Fcap:
            bufs[slot] = buf = (
                np.zeros((Fcap, l + 4), dtype=np.uint8),
                np.zeros(Fcap, dtype=np.int32),
            )
        frags = buf[0][:Fcap]
        frag_qg = buf[1][:Fcap]
        row = 0
        for qslot, gi in enumerate(group):
            for block in per_genome[gi][0]:  # one copy per contig
                n = block.shape[0]
                frags[row : row + n, :l] = block
                frag_qg[row : row + n] = qslot
                row += n
        frags[row:] = 0
        frag_qg[row:] = 0

        fn = self._get_fn()
        self.stats["dispatches"] += 1
        d_frags = _put(frags, NamedSharding(self.mesh, P("data", None)))
        d_qg = _put(frag_qg, NamedSharding(self.mesh, P("data")))
        handles = fn(
            d_frags,
            d_qg,
            *self._index_args,
            self._ident_tab,
            self._gpos_bucket_dev,
        )
        return (d_frags, d_qg), handles, row, Fcap

    def _run_groups(self, per_genome, groups):
        """Pipeline every dispatch group through the device; on a static
        budget overflow, escalate and re-run the whole batch (rare --
        budgets are pre-sized from index statistics).  Returns
        ``[(group, counts, isum)]`` with numpy arrays of shape
        (n_shard, q_capacity, g_max)."""
        # the order of `_query_block_impl`'s overflow flags
        budget_names = ["smax", "hmax", "ivmax", "t_chunks"]
        if "rmax" in self.budgets:
            budget_names.append("rmax")
        for attempt in range(6):
            self._prepare_tables()
            pending = []
            prev_in = {}
            # multi-group batches dispatch at ONE uniform bucket (the full
            # capacity): a smaller tail group would otherwise compile its
            # own program variant in the middle of a measured/production
            # run
            force_bucket = self.frag_capacity if len(groups) > 1 else None
            for g_i, group in enumerate(groups):
                slot = g_i % 2
                if slot in prev_in:
                    # the h2d of BOTH staged arrays (fragments and their
                    # query-genome assignment) must land before the slot's
                    # host buffers are overwritten
                    for d in prev_in[slot]:
                        d.block_until_ready()
                d_in, handles, row, Fcap = self._submit_group(
                    per_genome, group, slot, force_bucket
                )
                prev_in[slot] = d_in
                pending.append((group, handles, row, Fcap))

            out = []
            ovf_acc = np.zeros(len(budget_names), np.int64)
            for group, handles, row, Fcap in pending:
                counts, isum_hi, isum_lo, ovf = handles
                if jax.process_count() > 1:
                    # multi-process mesh: shard-axis outputs are only
                    # partially addressable per process; gather them so
                    # every process sees the full result (SPMD symmetry
                    # keeps the control flow identical across processes)
                    from jax.experimental import multihost_utils

                    counts, isum_hi, isum_lo, ovf = (
                        multihost_utils.process_allgather(x, tiled=True)
                        for x in (counts, isum_hi, isum_lo, ovf)
                    )
                ovf_acc = np.maximum(
                    ovf_acc, np.asarray(ovf).max(axis=0)
                )  # per budget, over shards
                # exact fixed-point identity total (see block_fn)
                counts = np.asarray(counts)
                isum_q17 = np.asarray(isum_hi).astype(np.int64) * 4096 + (
                    np.asarray(isum_lo)
                )
                # the on-device genome fold accumulates 12-bit identity
                # limbs in int32: the hi limb is <= 32 per occupied bin,
                # so the fold is exact while a genome holds < 2^31/32
                # occupied bins (~200 Gbp of matched sequence at l=3000).
                # `counts` (bins per genome) cannot itself overflow at
                # that scale, so it is a sound host-side guard.
                if counts.size and int(counts.max()) > 60_000_000:
                    raise RuntimeError(
                        "per-genome mapped-fragment count exceeds the "
                        "int32-exact range of the device identity fold"
                    )
                out.append((group, counts, isum_q17, row, Fcap))
            if not ovf_acc.any():
                for group, _, _, row, Fcap in out:
                    # per-logical-query fragment counters (dispatches
                    # counts each retry attempt; fragments count once)
                    self.stats["fragments_dispatched"] += row
                    self.stats["fragments_padded"] += Fcap - row
                return [(g, c, i) for g, c, i, _, _ in out]
            blown = [budget_names[i] for i in np.flatnonzero(ovf_acc)]
            if attempt == 5:
                raise RuntimeError(
                    f"sharded query budget overflow persists for {blown}"
                )
            import warnings

            old = {name: self.budgets[name] for name in blown}
            for name in blown:
                self.budgets[name] *= 2
            self.stats["budget_escalations"] += 1
            warnings.warn(
                "ShardedSession budget overflow; escalating "
                + ", ".join(f"{n} {old[n]} -> {self.budgets[n]}" for n in blown)
                + " (recompile)",
                UserWarning,
                stacklevel=3,
            )
            self._fn = None

    def warmup(self, frag_counts=None, q_counts=None):
        """Compile the dispatch program(s) ahead of time (VERDICT r04 #4).

        Args:
            frag_counts: iterable of fragment counts; each is rounded to
                its dispatch capacity bucket (`_frag_bucket`) and one
                zero-filled dispatch is run per distinct bucket.  Default:
                the session's full fragment capacity (the bucket every
                full all-vs-all dispatch group uses).
            q_counts: ignored (the genome axis is baked into the program
                as ``q_capacity``); kept for forward compatibility.

        Returns:
            dict mapping bucket size -> seconds spent compiling+running
            its first dispatch.  Calling this once makes subsequent
            queries of any covered bucket pay only dispatch + transfer.
        """
        import time as _time

        from jax.sharding import NamedSharding

        l = self.params.min_read_length
        out = {}
        with self._lock:
            self._prepare_tables()
            fn = self._get_fn()
            for need in frag_counts or [self.frag_capacity]:
                Fcap = self._frag_bucket(int(need))
                if Fcap in out:
                    continue
                t0 = _time.time()
                # representative random bases, not zeros: a zero-filled
                # batch has no valid k-mers, so its dispatch would skip the
                # L1 and L2 work that real queries run
                rng = np.random.default_rng(0)
                frags = rng.choice(
                    np.frombuffer(b"ACGT", np.uint8), size=(Fcap, l + 4)
                )
                frag_qg = np.zeros(Fcap, dtype=np.int32)
                handles = fn(
                    _put(frags, NamedSharding(self.mesh, P("data", None))),
                    _put(frag_qg, NamedSharding(self.mesh, P("data"))),
                    *self._index_args,
                    self._ident_tab,
                    self._gpos_bucket_dev,
                )
                jax.block_until_ready(handles)
                out[Fcap] = round(_time.time() - t0, 2)
        return out

    def query_many(self, genomes, frag_bucket: int | None = None):
        """Query a batch of genomes through the fixed-capacity program.

        Args:
            genomes: iterable of genomes, each an iterable of contigs
                (`str`/`bytes`/buffer).  The batch is packed into as few
                fixed-shape device dispatches as the fragment/genome
                capacities allow, so per-dispatch costs amortize across
                genomes -- use this for all-vs-all workloads.
            frag_bucket: optional minimum fragment capacity (grows the
                session's fixed capacity once; kept for compatibility).

        Returns:
            `list` of `list` of `Hit`: one hit list per query genome, each
            sorted by descending identity (same contract as
            `Mapper.query_draft`).
        """
        from ..models._types import Hit

        params = self.params
        l = params.min_read_length
        per_genome = [self._fragments(contigs) for contigs in genomes]
        if not per_genome:
            return []
        with self._lock:
            return self._query_many_locked(per_genome, frag_bucket)

    def _query_many_locked(self, per_genome, frag_bucket):
        from ..models._types import Hit

        params = self.params
        l = params.min_read_length
        self.stats["genomes_queried"] += len(per_genome)
        # grow the fixed capacity (once, sticky) if a genome demands it
        need = max(p[1] for p in per_genome)
        if frag_bucket:
            need = max(need, int(frag_bucket))
        if need > self.frag_capacity:
            import warnings

            new_cap = _round_up(need, self.n_data)
            warnings.warn(
                f"ShardedSession fragment capacity grown "
                f"{self.frag_capacity} -> {new_cap} (one-time recompile)",
                UserWarning,
                stacklevel=2,
            )
            self.frag_capacity = new_cap
            self.stats["capacity_growths"] += 1

        # balanced packing (LPT): spread genomes across the minimum number
        # of dispatch groups so group sizes -- and therefore the padded
        # capacity buckets they compile for -- stay uniform (a greedy
        # fill would leave a small tail group that compiles its own
        # program variant)
        total_f = sum(p[1] for p in per_genome)
        n_groups = max(
            1,
            -(-total_f // self.frag_capacity),
            -(-len(per_genome) // self.q_capacity),
        )
        order = sorted(range(len(per_genome)), key=lambda gi: -per_genome[gi][1])
        while True:
            bins = [[] for _ in range(n_groups)]
            loads = [0] * n_groups
            ok = True
            for gi in order:
                nf = per_genome[gi][1]
                cands = [
                    b for b in range(n_groups) if len(bins[b]) < self.q_capacity
                ]
                if not cands:
                    ok = False
                    break
                b = min(cands, key=lambda b: loads[b])
                if loads[b] + nf > self.frag_capacity:
                    ok = False
                    break
                bins[b].append(gi)
                loads[b] += nf
            if ok:
                break
            n_groups += 1  # LPT overflowed a bin; add one and repack
        groups = [b for b in bins if b]

        sidx = self.sidx
        results = [[] for _ in per_genome]
        groups = [g for g in groups if any(per_genome[gi][1] for gi in g)]
        for group, counts, isum_q17 in self._run_groups(per_genome, groups):
            for slot, gi in enumerate(group):
                _, total_fragments, total_length = per_genome[gi]
                hits = []
                for sh in range(sidx.n_shards):
                    for gj, name in enumerate(sidx.genome_names[sh]):
                        c = int(counts[sh, slot, gj])
                        if c == 0:
                            continue
                        # same exact arithmetic as _engine_np.mean_identity
                        identity = float(
                            np.float32(
                                int(isum_q17[sh, slot, gj]) / (131072.0 * c)
                            )
                        )
                        min_length = min(
                            total_length, int(sidx.genome_lengths[sh, gj])
                        )
                        if np.float32(c * l) >= np.float32(
                            min_length
                        ) * np.float32(params.min_fraction):
                            hits.append(Hit(name, identity, c, total_fragments))
                hits.sort(key=lambda h: h.identity, reverse=True)
                results[gi] = hits
        return results

    def query(self, contigs, frag_bucket: int | None = None):
        """Query one genome; returns `Hit`s like `Mapper.query_draft`."""
        return self.query_many([contigs], frag_bucket=frag_bucket)[0]


def sharded_query(mapper, contigs, mesh: Mesh, **budgets):
    """One-shot convenience wrapper around `ShardedSession`."""
    return ShardedSession(mapper, mesh, **budgets).query(contigs)
