"""Benchmark: query throughput of the ANI engine on one GPU, synthetic genomes.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}; its
``detail`` names the device (platform, device kind, count, and the
card's name and power limit from ``nvidia-smi``).  Exits non-zero when
JAX finds no GPU: a timing of another device is not this benchmark.

Two phases, both through `ShardedSession.query_many`:

* **small batch** (4 queries x 10 refs, the r01/r02 workload -- kept for
  round-over-round comparability, reported in ``detail``);
* **all-vs-all** (the headline): N genomes in mutation families, every
  genome queried against the full N-genome index, packed into
  fixed-capacity multi-genome dispatches.  This is the genome-pairs/s
  workload the >=10x target is defined on (BASELINE.md:4-7).

Baseline: reference pyfastani v0.6.0 CPU benchmark -- mean single-genome
query wall time 1.45 s at 12 threads over 50 proGenomes bacterial genomes
of mean 6.25 Mbp (``/root/reference/benches/mapping/v0.6.0.json``,
hardware ``README.md:148-152``), i.e. ~4.3 Mbp/s of query sequence.
``vs_baseline`` is this engine's all-vs-all query Mbp/s divided by 4.3
(per-pair CPU cost is per-queried-Mbp, so Mbp/s is the
workload-size-independent form of pairs/s).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MBP_S = 4.3

N_REFS = int(os.environ.get("BENCH_REFS", "10"))
REF_LEN = int(os.environ.get("BENCH_REF_LEN", "2000000"))
N_QUERIES = int(os.environ.get("BENCH_QUERIES", "4"))
# 512 genomes = BASELINE.json config 4 scale (a ~500-genome panel)
AVA_GENOMES = int(os.environ.get("BENCH_AVA_GENOMES", "512"))
# per-family genome length cycles through a 1-5 Mbp mix (BASELINE.json
# config 4 names a ~500-genome bacterial panel; sizes are heterogeneous)
AVA_LENGTHS = tuple(
    int(x) for x in os.environ.get(
        "BENCH_AVA_LENGTHS", "1000000,2000000,3000000,5000000"
    ).split(",")
)
AVA_FAMILY = 4  # genomes per mutation family
MUT_RATE = 0.03
# every second family descends from the previous family's ancestor at
# this rate, planting CROSS-family pairs near the 80%-identity /
# minFraction gates (VERDICT r04 #5: CGI filtering must be non-trivial
# at scale, not just 4-cliques)
CROSS_RATE = 0.09
AVA_CROSS = os.environ.get("BENCH_AVA_CROSS", "1") != "0"


def _mutate(rng, base, rate):
    arr = base.copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=int(idx.sum()))
    return arr


def _genomes():
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(alphabet, size=REF_LEN).tobytes() for _ in range(N_REFS)]
    queries = []
    for i in range(N_QUERIES):
        base = np.frombuffer(refs[i % N_REFS], dtype=np.uint8)
        queries.append(_mutate(rng, base, MUT_RATE).tobytes())
    return refs, queries


def _ava_genomes():
    """N genomes in families of AVA_FAMILY mutants of a shared ancestor,
    with family sizes cycling through the 1-5 Mbp mix.  Odd families
    descend from the previous family's ancestor at CROSS_RATE, so
    cross-family pairs sit near the identity/minFraction gates."""
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    prev_base = None
    for fam in range(-(-AVA_GENOMES // AVA_FAMILY)):
        if AVA_CROSS and fam % 2 == 1 and prev_base is not None:
            base = _mutate(rng, prev_base, CROSS_RATE)
        else:
            fi = (fam // 2) if AVA_CROSS else fam
            base = rng.choice(
                alphabet, size=AVA_LENGTHS[fi % len(AVA_LENGTHS)]
            )
        prev_base = base
        for _ in range(min(AVA_FAMILY, AVA_GENOMES - len(out))):
            out.append(_mutate(rng, base, MUT_RATE).tobytes())
    return out


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    from pyfastani_tpu import Sketch
    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import ShardedSession

    devices = jax.devices()
    _log(f"devices: {devices}")
    if devices[0].platform != "gpu":
        _log("no GPU found; this benchmark runs on a GPU only")
        sys.exit(1)
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    n_dev = len(devices)
    mesh = make_mesh(1, n_dev)
    detail = {
        "devices": n_dev,
        "backend": jax.default_backend(),
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "card": card,
    }

    # ---- phase 1: small batch (r01/r02-comparable) -------------------------
    refs, queries = _genomes()
    _log(f"generated {N_REFS} refs x {REF_LEN} bp, {N_QUERIES} queries")

    t0 = time.time()
    sketch = Sketch()
    for i, r in enumerate(refs):
        sketch.add_genome(f"ref{i}", r)
    mapper = sketch.index()
    t_index = time.time() - t0
    _log(f"indexed in {t_index:.1f}s ({mapper._index.n_minimizers} minimizers)")

    t0 = time.time()
    session = ShardedSession(mapper, mesh)
    t_park = time.time() - t0
    _log(f"session init (index park h2d): {t_park:.1f}s")
    _log("warmup (compiles the batched sharded step)...")
    t0 = time.time()
    nfrag = sum(len(q) // 3000 for q in queries)
    warm_report = session.warmup([nfrag])
    session.query_many([[q] for q in queries])  # untimed steady-state pass
    t_warm = time.time() - t0
    _log(f"warmup done in {t_warm:.1f}s {warm_report}")

    t0 = time.time()
    results = session.query_many([[q] for q in queries])
    small_elapsed = time.time() - t0
    small_bp = sum(len(q) for q in queries)
    for qi, hits in enumerate(results):
        assert hits, f"benchmark query {qi} produced no hits"
    _log(
        f"small batch: {small_bp/1e6:.0f} Mbp in {small_elapsed:.2f}s "
        f"({small_bp/1e6/small_elapsed:.2f} Mbp/s)"
    )
    detail.update(
        n_refs=N_REFS, ref_len=REF_LEN, n_queries=N_QUERIES,
        index_s=round(t_index, 2), park_s=round(t_park, 2),
        warmup_s=round(t_warm, 2),
        query_s_per_genome=round(small_elapsed / N_QUERIES, 3),
        small_mbp_s=round(small_bp / 1e6 / small_elapsed, 3),
    )

    # ---- winnowing throughput (the second BASELINE.json metric) ------------
    from pyfastani_tpu import _native

    win_buf = refs[0] + refs[1]  # 4 Mbp warm + measured
    genomes_small_buf = refs[0] + refs[1] + refs[2] + refs[3] + refs[4]
    _native.winnow(win_buf, 16, 24)
    best = 0.0
    for _ in range(6):  # best-of: the host's cores are shared
        t0 = time.time()
        _native.winnow(win_buf, 16, 24)
        best = max(best, len(win_buf) / 1e6 / (time.time() - t0))
    winnow_mbp_s = best
    _log(f"host ingest winnow: {winnow_mbp_s:.0f} Mbp/s (C, AVX2 + 2 threads)")
    detail["winnow_mbp_s"] = round(winnow_mbp_s, 1)

    # device chunked winnow (ops/winnow2d).  Two figures: end-to-end
    # ingest (h2d + winnow + compaction + d2h each chunk) and
    # compute-only (device-resident outputs), which is the number for
    # pipelines whose sequences live on device.
    import jax as _jax
    import jax.numpy as _jnp

    from pyfastani_tpu.ops import winnow2d as _w2d
    from pyfastani_tpu.ops.fragments import (
        _CHUNK_WINDOWS, _winnow_chunk2d_jit, winnow_long_sequence,
    )

    wdata = np.frombuffer(win_buf, np.uint8)
    winnow_long_sequence(wdata[:100_000], 16, 24, False)  # compile small
    t0 = time.time()
    winnow_long_sequence(wdata, 16, 24, False)
    winnow_dev = len(win_buf) / 1e6 / (time.time() - t0)
    _log(f"device chunked winnow (e2e, with transfers): {winnow_dev:.0f} Mbp/s")
    detail["winnow_device_mbp_s"] = round(winnow_dev, 1)

    B = _CHUNK_WINDOWS
    R = _w2d.chunk_slice_rows(B, 24, 16)
    sl = np.zeros(R * 128, np.uint8)
    sl[: min(wdata.shape[0], R * 128)] = wdata[: R * 128]
    sl_dev = _jax.device_put(_jnp.asarray(sl.reshape(R, 128)))
    carry = (
        _jnp.asarray(False), _jnp.asarray(0, _jnp.int32),
        _jnp.asarray(False), _jnp.asarray(0, _jnp.uint32),
    )
    cap = max(1024, (-(-4 * B // 25) // 128) * 128)
    args = (np.int32(R * 128 - 15), np.int32(0), np.int32(B), carry,
            16, 24, B, False, True, cap)
    out = _winnow_chunk2d_jit(sl_dev, *args)
    _jax.block_until_ready(out)
    t0 = time.time()
    reps = 8
    for _ in range(reps):
        out = _winnow_chunk2d_jit(sl_dev, *args)
    _jax.block_until_ready(out)
    winnow_dev_c = reps * B / 1e6 / (time.time() - t0)
    _log(f"device winnow compute-only: {winnow_dev_c:.0f} Mbp/s")
    detail["winnow_device_compute_mbp_s"] = round(winnow_dev_c, 1)

    # in-program fragment winnow (the device winnow path every query
    # runs): batched winnow+sketch of one full dispatch of fragments
    from pyfastani_tpu.ops.fragments import _winnow_fragments_impl

    F_w = 2688
    l_w = 3000
    frw = np.frombuffer(genomes_small_buf[: F_w * l_w], np.uint8).reshape(
        F_w, l_w
    )
    frw_pad = np.zeros((F_w, l_w + 4), np.uint8)
    frw_pad[:, :l_w] = frw
    win_fn = _jax.jit(
        lambda fr: _winnow_fragments_impl.__wrapped__(
            fr, 16, 24, l_w, False, 512
        )[2:]
    )
    d_frw = _jax.device_put(_jnp.asarray(frw_pad))
    d_frw2 = _jax.device_put(_jnp.asarray(frw_pad[::-1].copy()))
    _jax.block_until_ready(win_fn(d_frw))
    _jax.block_until_ready(win_fn(d_frw2))
    t0 = time.time()
    outs = [win_fn(d_frw if r % 2 else d_frw2) for r in range(8)]
    _jax.block_until_ready(outs)
    win_prog_gbps = 8 * F_w * l_w / 1e9 / (time.time() - t0)
    # outputs verified bitwise against the host engine (benches notes);
    # alternating inputs + retained handles defeat any dispatch elision
    _log(f"device fragment winnow (batched program): {win_prog_gbps:.2f} Gbp/s")
    detail["winnow_gbps"] = round(win_prog_gbps, 3)

    # ---- self-measured CPU denominator (BASELINE.md:5-7) -------------------
    # the repo's own spec engine (numpy backend) on THIS host, same
    # workload shape as the small batch -- an honest current-hardware
    # denominator alongside the published 2018-laptop figure
    import pickle

    cpu_mapper = pickle.loads(pickle.dumps(mapper))
    cpu_mapper._backend = "numpy"
    t0 = time.time()
    cpu_hits = cpu_mapper.query_genome(queries[0])
    cpu_elapsed = time.time() - t0
    assert cpu_hits
    cpu_mbp_s = len(queries[0]) / 1e6 / cpu_elapsed
    _log(f"CPU denominator (numpy engine, this host): {cpu_mbp_s:.2f} Mbp/s")
    detail["cpu_mbp_s"] = round(cpu_mbp_s, 3)

    # ---- phase 2: all-vs-all (headline) ------------------------------------
    genomes = _ava_genomes()
    _log(
        f"all-vs-all: {len(genomes)} genomes, "
        f"{sum(len(g) for g in genomes)/1e6:.0f} Mbp total (1-5 Mbp mix)"
    )
    t0 = time.time()
    sketch = Sketch()
    for i, g in enumerate(genomes):
        sketch.add_genome(f"g{i}", g)
    mapper = sketch.index()
    t_ava_index = time.time() - t0
    _log(f"ava index in {t_ava_index:.1f}s ({mapper._index.n_minimizers} minimizers)")

    t0 = time.time()
    session = ShardedSession(mapper, mesh)
    t_ava_park = time.time() - t0
    _log(f"ava session init (index park h2d): {t_ava_park:.1f}s")
    t0 = time.time()
    warm_report = session.warmup()  # the full-capacity dispatch bucket
    t_ava_compile = time.time() - t0
    session.query_many([[g] for g in genomes])  # untimed steady-state pass
    t_ava_warm = time.time() - t0
    _log(
        f"ava warmup {t_ava_warm:.1f}s (compile {t_ava_compile:.1f}s "
        f"{warm_report}; variants: {session.stats['compiled_variants']})"
    )

    t0 = time.time()
    results = session.query_many([[g] for g in genomes])
    ava_elapsed = time.time() - t0
    n_pairs = len(genomes) * len(genomes)
    ava_bp = sum(len(g) for g in genomes)
    hits_total = sum(len(h) for h in results)
    assert all(results[i] for i in range(len(genomes))), "ava query with no hits"
    mbp_s = ava_bp / 1e6 / ava_elapsed
    _log(
        f"all-vs-all: {n_pairs} pairs, {ava_bp/1e6:.0f} Mbp in {ava_elapsed:.2f}s "
        f"({n_pairs/ava_elapsed:.1f} pairs/s, {mbp_s:.2f} Mbp/s, {hits_total} hits)"
    )
    ava_mbp = sum(len(g) for g in genomes) / 1e6
    detail.update(
        ava_genomes=len(genomes),
        ava_mbp=round(ava_mbp, 1),
        ava_index_s=round(t_ava_index, 2),
        ava_index_mbp_s=round(ava_mbp / t_ava_index, 1),
        ava_park_s=round(t_ava_park, 2),
        ava_warmup_s=round(t_ava_warm, 2),
        ava_pairs=n_pairs, ava_pairs_per_s=round(n_pairs / ava_elapsed, 2),
        ava_hits=hits_total,
        ava_intra_family_hits=len(genomes) * AVA_FAMILY,
        budget_escalations=session.stats["budget_escalations"],
    )

    # NOT a CPU-FastANI comparison: the denominator is this repo's own
    # NumPy *spec* engine (the semantic oracle, ~5x slower than the
    # reference's single-thread Cython).  The official denominator for
    # the >=10x north star is multithreaded CPU FastANI -- 4.3 Mbp/s
    # @12T published (BASELINE.md) -- which `vs_baseline` reports.
    detail["vs_self_numpy_spec"] = round(mbp_s / detail["cpu_mbp_s"], 2)
    result = {
        "metric": "query_throughput",
        "value": round(mbp_s, 3),
        "unit": "Mbp/s",
        "vs_baseline": round(mbp_s / BASELINE_MBP_S, 3),
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
