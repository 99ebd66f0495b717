"""Time the device pipeline stage by stage (winnow / L1 / L2 / CGI)."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_REFS = int(os.environ.get("BENCH_REFS", "10"))
REF_LEN = int(os.environ.get("BENCH_REF_LEN", "2000000"))
N_QUERIES = int(os.environ.get("BENCH_QUERIES", "4"))


def main():
    import jax
    import jax.numpy as jnp

    from pyfastani_tpu import Sketch, stats
    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import (
        ShardedSession, _query_block_impl,
    )
    from pyfastani_tpu.ops.fragments import _winnow_fragments_impl
    from pyfastani_tpu.ops.l1 import l1_candidates_device

    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(alphabet, size=REF_LEN).tobytes() for _ in range(N_REFS)]
    queries = []
    for i in range(N_QUERIES):
        base = np.frombuffer(refs[i % N_REFS], dtype=np.uint8).copy()
        idx = rng.random(base.shape[0]) < 0.03
        base[idx] = rng.choice(alphabet, size=int(idx.sum()))
        queries.append(base.tobytes())

    sketch = Sketch()
    for i, r in enumerate(refs):
        sketch.add_genome(f"ref{i}", r)
    mapper = sketch.index()

    mesh = make_mesh(1, 1)
    session = ShardedSession(mapper, mesh)
    params = session.params
    l = params.min_read_length
    b = session.budgets
    sidx = session.sidx

    per_genome = [session._fragments([q]) for q in queries]
    F = sum(p[1] for p in per_genome)
    Fb = max(-(-F // 128) * 128, 128)
    frags = np.zeros((Fb, l + 4), dtype=np.uint8)
    frag_qg = np.zeros(Fb, dtype=np.int32)
    row = 0
    for qg, (blocks, _, _) in enumerate(per_genome):
        for block in blocks:  # one (n, l) array per contig
            n = block.shape[0]
            frags[row : row + n, :l] = block
            frag_qg[row : row + n] = qg
            row += n

    k, w = params.kmer_size, params.window_size
    smax = b["smax"]
    kc = min(smax + 128, l)

    dfrags = jax.device_put(jnp.asarray(frags))
    jax.block_until_ready(dfrags)

    # stage 1: winnow + sketch
    win = jax.jit(lambda fr: _winnow_fragments_impl.__wrapped__(fr, k, w, l, False, kc))
    out1 = win(dfrags); jax.block_until_ready(out1)
    t0 = time.time()
    for _ in range(3):
        out1 = win(dfrags); jax.block_until_ready(out1)
    t_win = (time.time() - t0) / 3
    _, _, q_sorted, s_sizes = out1
    q_sorted = q_sorted[:, : min(smax, q_sorted.shape[1])]
    jax.block_until_ready((q_sorted, s_sizes))

    # stage 2: L1
    tab = stats.min_hits_relaxed_table(l, k, params.percentage_identity)
    idx_args = [jnp.asarray(a[0]) for a in (
        sidx.uniq_hash, sidx.row_start, sidx.row_len, sidx.post_seqid,
        sidx.post_wpos)]
    thr = jnp.asarray(sidx.freq_threshold[0])
    hb = jnp.asarray(np.stack(
        [sidx.hash_bucket[0][:-1], sidx.hash_bucket[0][1:]], axis=-1
    ))
    l1fn = jax.jit(lambda qs, ss: l1_candidates_device.__wrapped__(
        qs, ss, *idx_args, thr, jnp.asarray(tab), hb,
        b["hmax"], b["ivmax"], l, sidx.bucket_steps))
    out2 = l1fn(q_sorted, s_sizes); jax.block_until_ready(out2)
    t0 = time.time()
    for _ in range(3):
        out2 = l1fn(q_sorted, s_sizes); jax.block_until_ready(out2)
    t_l1 = (time.time() - t0) / 3

    # full block for total
    g_max = int(sidx.genome_lengths.shape[1])
    gate = stats.l2_gate_table(l, k, params.percentage_identity)
    full_args = [jnp.asarray(a[0]) for a in (
        sidx.uniq_hash, sidx.row_start, sidx.row_len, sidx.post_gpos,
        sidx.mini_hash, sidx.mini_wpos,
        sidx.mini_gpos, sidx.mini_prev, sidx.contig_offset,
        sidx.seq_to_genome)]
    static = dict(k=k, w=w, length=l, protein=False, l=l,
                  hmax=b["hmax"], ivmax=b["ivmax"], cmax=b["cmax"],
                  rmax=b.get("rmax"), t_chunks=b["t_chunks"], g_max=g_max,
                  bin_max=b["bin_max"], smax=smax, q_count=4,
                  bucket_steps=sidx.bucket_steps,
                  l2_kernel=session._l2_kernel,
                  m_values=tuple(sorted({int(max(int(v), 1))
                                         for v in tab[: b["smax"] + 1]})))
    ident2d = stats.identity_table(smax, k)
    fullfn = jax.jit(lambda fr, qg: _query_block_impl(
        fr, qg, *full_args, thr, hb, jnp.asarray(tab), jnp.asarray(gate),
        jnp.asarray(ident2d), **static))
    dqg = jax.device_put(jnp.asarray(frag_qg))
    out3 = fullfn(dfrags, dqg); jax.block_until_ready(out3)
    t0 = time.time()
    for _ in range(3):
        out3 = fullfn(dfrags, dqg); jax.block_until_ready(out3)
    t_full = (time.time() - t0) / 3

    total_bp = sum(len(q) for q in queries)
    print(f"F={F} fragments, {total_bp/1e6:.1f} Mbp")
    print(f"winnow+sketch: {t_win*1e3:8.1f} ms")
    print(f"L1:            {t_l1*1e3:8.1f} ms")
    print(f"L2+CGI (rest): {(t_full-t_win-t_l1)*1e3:8.1f} ms")
    print(f"full block:    {t_full*1e3:8.1f} ms  ({total_bp/1e6/t_full:.1f} Mbp/s)")


if __name__ == "__main__":
    main()
