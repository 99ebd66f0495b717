#!/usr/bin/env python3
"""Run the query path once on one GPU, at the reference benchmark's size.

    python3 chip_smoke.py               # one card: the whole main path
    python3 chip_smoke.py --cards 4     # four cards: the sharded index only

One card: builds the native host extension, indexes a seeded synthetic
reference set of 50 genomes of mean 6.25 Mbp (the size of the reference
implementation's own mapping benchmark, ``benches/mapping/v0.6.0.json``)
through ``Sketch().add_genome`` -> ``index()`` on the default ``jax``
backend, answers genome queries through ``Mapper.query_genome``, a
~100-contig draft through ``Mapper.query_draft`` and a batch through
``ShardedSession.query_many``, and checks the hits bitwise against the
NumPy spec engine.  It then compares the compiled L2 kernel with the XLA
event scan (`ops.l2.l2_chunk_scan`) at real widths, and runs the tests
marked ``gpu`` in this process.

Four cards: the same data through a ``ShardedSession`` over a 1x4 and a
2x2 ("data", "shard") mesh, checked bitwise against the NumPy engine.

Prints figures on the way, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed phase raises,
so the script exits non-zero and prints no result; so does a machine
whose JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_N_GENOMES = 50  # the reference set
# genome lengths of the reference set cycle through these (mean 6.25 Mbp)
_LENGTHS = (4_500_000, 5_500_000, 6_500_000, 7_000_000, 7_750_000)
_FAMILY = 5  # genomes per mutation family
_MUT = 0.03  # within-family mutation rate
_CROSS = 0.09  # odd families descend from the previous family's ancestor


def _log(msg: str) -> None:
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _mutate(rng, base: np.ndarray, rate: float) -> np.ndarray:
    arr = base.copy()
    idx = np.flatnonzero(rng.random(arr.shape[0]) < rate)
    arr[idx] = _ACGT[rng.integers(0, 4, size=idx.shape[0])]
    return arr


def reference_set(seed: int):
    """`_N_GENOMES` genomes in families of `_FAMILY` mutants; every odd
    family descends from the previous family's ancestor at `_CROSS`, so
    cross-family pairs sit near the identity and minFraction gates."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for fam in range(-(-_N_GENOMES // _FAMILY)):
        if fam % 2 == 1:
            base = _mutate(rng, prev, _CROSS)
        else:
            n = _LENGTHS[(fam // 2) % len(_LENGTHS)]
            base = _ACGT[rng.integers(0, 4, size=n)]
        prev = base
        for _ in range(min(_FAMILY, _N_GENOMES - len(out))):
            out.append(_mutate(rng, base, _MUT))
    return out


def _same_hits(got, want, what: str) -> None:
    """Device hits equal the NumPy engine's field for field, identity
    bitwise (the device identity sums are exact fixed point)."""
    g = [(h.name, h.matches, h.fragments, np.float32(h.identity).tobytes()) for h in got]
    w = [(h.name, h.matches, h.fragments, np.float32(h.identity).tobytes()) for h in want]
    if g != w:
        raise AssertionError(f"{what}: device {got} != numpy {want}")
    if not got:
        raise AssertionError(f"{what}: no hits")
    _log(f"{what}: {len(got)} hits equal the NumPy engine bitwise")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def native_extension() -> bool:
    from pyfastani_tpu import _native

    if not _native.HAVE_NATIVE:
        import importlib

        from pyfastani_tpu._native.build import build

        build()
        importlib.reload(_native)
    return _native.HAVE_NATIVE


def build_index(genomes):
    from pyfastani_tpu import Sketch

    t0 = time.perf_counter()
    sk = Sketch()  # default backend: jax
    for i, g in enumerate(genomes):
        sk.add_genome(f"g{i}", g.tobytes())
    mapper = sk.index()
    dt = time.perf_counter() - t0
    mbp = sum(g.shape[0] for g in genomes) / 1e6
    _log(
        f"index: {len(genomes)} genomes, {mbp:.1f} Mbp, "
        f"{mapper._index.n_minimizers} minimizers in {dt:.2f} s"
    )
    if mapper._backend != "jax":
        raise AssertionError(f"default backend is {mapper._backend}, not jax")
    return mapper, dt


def _numpy_twin(mapper):
    """The same index behind the NumPy spec engine."""
    twin = copy.copy(mapper)
    twin._backend = "numpy"
    twin._session = None
    return twin


def _draft(rng, genome: np.ndarray, n_contigs: int):
    cuts = np.sort(rng.choice(np.arange(1, genome.shape[0]), n_contigs - 1, replace=False))
    return [c.tobytes() for c in np.split(genome, cuts)]


def _step_memory(sess, n_frag: int):
    """``compiled.memory_analysis()`` of the session's query step at the
    dispatch bucket of ``n_frag`` fragments."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pyfastani_tpu.parallel.sharded import _put

    fcap = sess._frag_bucket(n_frag)
    l = sess.params.min_read_length
    args = (
        _put(np.zeros((fcap, l + 4), np.uint8), NamedSharding(sess.mesh, P("data", None))),
        _put(np.zeros(fcap, np.int32), NamedSharding(sess.mesh, P("data"))),
        *sess._index_args, sess._ident_tab, sess._gpos_bucket_dev,
    )
    return sess._get_fn().lower(*args).compile().memory_analysis()


def main_path(seed: int):
    import jax

    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import ShardedSession

    figs = {}
    t0 = time.perf_counter()
    genomes = reference_set(seed)
    _log(f"generated the reference set in {time.perf_counter() - t0:.2f} s")
    mapper, figs["index_s"] = build_index(genomes)
    numpy_mapper = _numpy_twin(mapper)

    rng = np.random.default_rng(seed + 1)
    queries = [
        _mutate(rng, genomes[0], 0.02).tobytes(),
        _mutate(rng, genomes[7], 0.05).tobytes(),
        _ACGT[rng.integers(0, 4, size=genomes[0].shape[0] // 3)].tobytes(),
    ]
    draft = _draft(rng, _mutate(rng, genomes[12], 0.03), 100)
    l = mapper.fragment_length

    # --- Mapper.query_genome / query_draft (one-card session, q = 1)
    t0 = time.perf_counter()
    sess = mapper._device_session()
    figs["park_s"] = time.perf_counter() - t0
    _log(f"park (session build + h2d of the index): {figs['park_s']:.2f} s; L2 path {sess._l2_kernel}")
    if sess._l2_kernel != "triton":
        raise AssertionError(f"GPU session chose the {sess._l2_kernel} L2 path")
    n_frag = len(queries[0]) // l
    figs["compile_s"] = sess.warmup([n_frag])
    _log(f"compile + first dispatch per bucket: {figs['compile_s']}")
    mem = _step_memory(sess, n_frag)
    _log(f"step memory_analysis: {mem}")

    t0 = time.perf_counter()
    first = mapper.query_genome(queries[0])
    figs["first_query_s"] = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = mapper.query_genome(queries[0])
        steady.append(time.perf_counter() - t0)
        if again != first:
            raise AssertionError("repeated query_genome changed its hits")
    figs["steady_query_s"] = steady
    _log(
        f"query_genome {len(queries[0]) / 1e6:.2f} Mbp: first {figs['first_query_s']:.3f} s, "
        f"steady {', '.join(f'{s:.3f}' for s in steady)} s"
    )
    dev = [first] + [mapper.query_genome(q) for q in queries[1:]]
    if dev[2]:
        raise AssertionError(f"unrelated query hit {dev[2]}")
    t0 = time.perf_counter()
    dev_draft = mapper.query_draft(draft)
    _log(f"query_draft, {len(draft)} contigs: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    _same_hits(dev[0], numpy_mapper.query_genome(queries[0]), "query_genome")
    _same_hits(dev_draft, numpy_mapper.query_draft(draft), "query_draft")
    _log(f"NumPy engine comparisons: {time.perf_counter() - t0:.1f} s")

    # --- ShardedSession.query_many over a one-card mesh
    batch = [[queries[0]]] + [
        [_mutate(rng, genomes[i], 0.04).tobytes()]
        for i in range(1, len(genomes), len(genomes) // 15)
    ]
    t0 = time.perf_counter()
    panel = ShardedSession(mapper, make_mesh(1, 1))
    _log(f"query_many session park: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    got = panel.query_many(batch)
    first_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = panel.query_many(batch)
    steady_many = time.perf_counter() - t0
    if again != got:
        raise AssertionError("repeated query_many changed its hits")
    mbp = sum(len(g[0]) for g in batch) / 1e6
    _log(
        f"query_many {len(batch)} genomes, {mbp:.1f} Mbp: first {first_many:.3f} s, "
        f"steady {steady_many:.3f} s ({mbp / steady_many:.1f} Mbp/s), stats {panel.stats}"
    )
    _same_hits(got[0], dev[0], "query_many[0] vs query_genome")
    if not all(got):
        raise AssertionError("a query_many genome found no hits")
    stats = jax.devices()[0].memory_stats() or {}
    _log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return sess


def kernel_check(sess, seed: int, N: int = 16384, M: int = 4_000_000, F: int = 4096) -> None:
    """The compiled L2 kernel against the XLA event scan, at real widths:
    ranges of up to R entries (the presizer's rmax for the smoke index,
    + 128), sketches of S = smax hashes, N chunks, window positions above
    2^24.  The store is dense (4096 distinct hashes, gaps of 1-3) and
    every second chunk sits on its fragment's source region, so nearly
    every chunk is live with shared counts in the tens to hundreds, and
    the tie and first/last merges across anchor blocks are exercised.
    Exact equality: the outputs are integers and neither side has a
    float matrix product."""
    import jax
    import jax.numpy as jnp

    from pyfastani_tpu.ops.l2 import _l2_chunks_impl
    from pyfastani_tpu.ops.l2_pallas import compute_mini_prev, l2_chunks_pallas
    from pyfastani_tpu.parallel.sharded import _presize_rmax

    p = sess.params
    cmw = p.min_read_length - (p.kmer_size - 1)
    cmax = sess.budgets["cmax"]
    R = _presize_rmax(sess.sidx, cmax, cmw) + 128
    S = sess.budgets["smax"]

    rng = np.random.default_rng(seed + 2)
    wpos = (np.cumsum(rng.integers(1, 4, size=M)) + (1 << 24) + 12345).astype(np.int32)
    mh = rng.integers(0, 1 << 12, size=M).astype(np.uint32)
    prev = compute_mini_prev(mh, np.zeros(M, np.int32), wpos)
    # each sketch row: distinct hashes of its fragment's source region
    src = rng.integers(0, M - 2 * R, size=F)
    s_sizes = rng.integers(S // 2, S + 1, size=F).astype(np.int32)
    q = np.full((F, S), 0xFFFFFFFF, np.uint32)
    for f in range(F):
        u = np.unique(mh[src[f] : src[f] + 2 * R])
        q[f, : s_sizes[f]] = np.sort(rng.choice(u, size=s_sizes[f], replace=False))
    frag = rng.integers(0, F, size=N).astype(np.int32)
    lo = rng.integers(0, M - R, size=N).astype(np.int32)
    hom = np.arange(N) % 2 == 1
    lo[hom] = src[frag[hom]] + rng.integers(0, R, size=int(hom.sum()))
    rlen = rng.integers(0, R + 1, size=N).astype(np.int32)
    rlen[: N // 8] = 0  # empty slots, as in an over-provisioned budget
    c0 = wpos[lo]
    clen = rng.integers(1, cmax + 1, size=N).astype(np.int32)

    dq, ds, dh, dw, dp = map(jnp.asarray, (q, s_sizes, mh, wpos, prev))
    dc = [jnp.asarray(a) for a in (frag, c0, clen, lo, rlen)]

    def kern():
        return l2_chunks_pallas(dq, ds, dh, dw, dp, *dc, cmw=cmw)

    def xla():
        return _l2_chunks_impl(dq, ds, dh, dw, *dc, cmax, R, cmw)

    times = {}
    outs = {}
    for name, fn in (("kernel", kern), ("xla", xla)):
        t0 = time.perf_counter()
        outs[name] = jax.block_until_ready(fn())
        times[f"{name}_first_s"] = time.perf_counter() - t0
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            reps.append(time.perf_counter() - t0)
        times[f"{name}_s"] = sorted(reps)[len(reps) // 2]
    for a, b, what in zip(outs["kernel"], outs["xla"], ("best", "first", "last")):
        a, b = np.asarray(a), np.asarray(b)
        if not np.array_equal(a, b):
            bad = np.flatnonzero(a != b)
            raise AssertionError(f"L2 kernel {what} differs at {bad[:10]}: {a[bad[:10]]} vs {b[bad[:10]]}")
    best = np.asarray(outs["kernel"][0])
    live = float((best[rlen > 0] > 0).mean())
    hom_median = float(np.median(best[hom & (rlen > 0)]))
    if live < 0.9 or hom_median < 32:
        raise AssertionError(f"L2 check store too sparse: {live:.3f} live, median {hom_median}")
    _log(
        f"L2 kernel == XLA event scan on {N} chunks (R={R}, S={S}, positions "
        f"{int(wpos[0])}..{int(wpos[-1])}; {live:.3f} of non-empty chunks live, "
        f"source-region median count {hom_median:.0f}, max {int(best.max())}); "
        f"median kernel {times['kernel_s'] * 1e3:.3f} ms, xla {times['xla_s'] * 1e3:.3f} ms, "
        f"first calls {times['kernel_first_s']:.2f} / {times['xla_first_s']:.2f} s"
    )


def gpu_tests() -> None:
    import pytest

    os.environ["PYFASTANI_TEST_DEVICES"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(_ROOT, "tests")]
    )
    if rc != 0:
        raise AssertionError(f"tests marked gpu failed (pytest exit {rc})")


def four_cards(seed: int) -> None:
    import jax

    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import _GBIG, ShardedSession

    if len(jax.devices()) < 4:
        raise SystemExit(f"--cards 4 needs 4 GPUs, JAX found {len(jax.devices())}")
    genomes = reference_set(seed)
    mapper, _ = build_index(genomes)
    numpy_mapper = _numpy_twin(mapper)
    rng = np.random.default_rng(seed + 1)
    # one query genome from each quarter of the set; the shards split
    # every family (greedy packing by size), so each query hits genomes
    # on every shard
    n = len(genomes)
    batch = [
        [_mutate(rng, genomes[i], 0.03).tobytes()] for i in range(n // 8, n, n // 4)
    ]
    t0 = time.perf_counter()
    want = [numpy_mapper.query_genome(g[0]) for g in batch]
    _log(f"NumPy engine on {len(batch)} genomes: {time.perf_counter() - t0:.1f} s")
    for shape in ((1, 4), (2, 2)):
        t0 = time.perf_counter()
        sess = ShardedSession(mapper, make_mesh(*shape, devices=jax.devices()[:4]))
        park = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = sess.query_many(batch)
        first = time.perf_counter() - t0
        steady = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = sess.query_many(batch)
            steady.append(time.perf_counter() - t0)
            if again != got:
                raise AssertionError(f"mesh {shape}: repeated query_many changed its hits")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_hits(g, w, f"mesh {shape} genome {i}")
        busy = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.devices()[:4]]
        _log(
            f"mesh {shape}: park {park:.2f} s, first {first:.2f} s, steady "
            f"{', '.join(f'{s:.4f}' for s in steady)} s, shard minimizers "
            f"{[int(np.searchsorted(g, np.int32(_GBIG - 1))) for g in sess.sidx.mini_gpos]}, "
            f"peak_bytes_in_use per card {busy}, stats {sess.stats}"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU found: JAX devices are {devices}", file=sys.stderr)
        return 1
    _log(f"devices: {devices} ({devices[0].device_kind})")
    card = card_line()
    _log(f"card (name, power limit): {card}")
    sys.path.insert(0, _ROOT)
    _log(f"native extension used: {native_extension()}")

    if args.cards == 4:
        four_cards(args.seed)
        count = 4
    else:
        sess = main_path(args.seed)
        kernel_check(sess, args.seed)
        gpu_tests()
        count = 1
    print(f"card: {card}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": count,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
