"""Multi-chip sharded pipeline vs the single-host engine (8 CPU devices)."""

import numpy as np
import pytest

import jax

from pyfastani_tpu import Sketch
from pyfastani_tpu.parallel.mesh import make_mesh
from pyfastani_tpu.parallel.sharded import sharded_query


def _rand_genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def _mutate(rng, seq, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=int(idx.sum()))
    return arr.tobytes()


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_sharded_matches_host(mesh_shape, eight_devices):
    rng = np.random.default_rng(17)
    refs = [_rand_genome(rng, n) for n in (40_000, 25_000, 31_000, 18_000, 22_000)]
    query = _mutate(rng, refs[1], 0.04)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    expected = mapper.query_genome(query)

    mesh = make_mesh(*mesh_shape)
    got = sharded_query(
        mapper, [query], mesh,
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256,
    )

    assert [(h.name, h.matches, h.fragments) for h in got] == [
        (h.name, h.matches, h.fragments) for h in expected
    ]
    for a, b in zip(got, expected):
        assert a.identity == b.identity  # bitwise: fixed-point identity sums


def test_sharded_self_query(eight_devices):
    rng = np.random.default_rng(23)
    refs = [_rand_genome(rng, n) for n in (30_000, 45_000, 21_000)]
    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    mesh = make_mesh(2, 4)
    hits = sharded_query(
        mapper, [refs[1]], mesh,
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256,
    )
    assert len(hits) == 1
    assert hits[0].name == "g1"
    assert hits[0].identity == 100.0
    assert hits[0].matches == hits[0].fragments == 15


def test_query_many_matches_per_genome(eight_devices):
    """A batched multi-genome dispatch returns the same hits as one
    dispatch per genome (and as the host engine)."""
    from pyfastani_tpu.parallel.sharded import ShardedSession

    rng = np.random.default_rng(23)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000, 27_000)]
    queries = [
        _mutate(rng, refs[0], 0.03),
        _mutate(rng, refs[2], 0.05),
        _rand_genome(rng, 20_000),  # unrelated: expect no hits
    ]

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()

    mesh = make_mesh(2, 4)
    sess = ShardedSession(
        mapper, mesh,
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64,
        smax=256,
    )
    batched = sess.query_many([[q] for q in queries])
    assert len(batched) == 3
    for q, hits in zip(queries, batched):
        single = sess.query([q])
        assert hits == single
        expected = mapper.query_genome(q)
        assert [(h.name, h.matches, h.fragments) for h in hits] == [
            (h.name, h.matches, h.fragments) for h in expected
        ]
        for h, e in zip(hits, expected):
            assert h.identity == e.identity  # bitwise: fixed-point identity sums
    assert batched[2] == []


def test_determinism_across_repeats_and_meshes(eight_devices):
    """The same query gives identical hits on repeated dispatches and on
    different mesh layouts (the reference has no such guarantee -- its
    thread pool makes tie handling order-dependent; see
    KNOWN_DEVIATIONS.md)."""
    from pyfastani_tpu.parallel.sharded import ShardedSession

    rng = np.random.default_rng(31)
    refs = [_rand_genome(rng, n) for n in (26_000, 22_000, 24_000, 21_000)]
    query = _mutate(rng, refs[1], 0.04)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()

    runs = []
    for mesh_shape in [(2, 4), (4, 2), (8, 1)]:
        sess = ShardedSession(
            mapper, make_mesh(*mesh_shape),
            hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64,
            smax=256,
        )
        for _ in range(2):
            runs.append(sess.query([query]))
    first = runs[0]
    assert first, "expected a hit"
    for other in runs[1:]:
        assert [(h.name, h.matches, h.fragments) for h in other] == [
            (h.name, h.matches, h.fragments) for h in first
        ]
        for a, b in zip(other, first):
            assert a.identity == b.identity  # bitwise: fixed-point identity sums


def test_checkpoint_restore_matches_host(tmp_path, eight_devices):
    """ShardedIndex.save/load + ShardedSession.from_index: a session
    restored from a checkpoint (no Mapper, no re-partition) matches the
    host engine -- the multi-host resume path (SURVEY.md §5)."""
    from pyfastani_tpu.parallel.sharded import (
        ShardedIndex,
        ShardedSession,
        build_sharded_index,
    )

    rng = np.random.default_rng(41)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000, 27_000, 21_000)]
    query = _mutate(rng, refs[2], 0.04)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    expected = mapper.query_genome(query)

    path = str(tmp_path / "index.npz")
    build_sharded_index(mapper, 4).save(path)
    restored = ShardedIndex.load(path)
    assert restored.n_shards == 4
    assert restored.genome_names == build_sharded_index(mapper, 4).genome_names

    sess = ShardedSession.from_index(
        restored, mapper._param, make_mesh(2, 4),
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64,
        smax=256,
    )
    got = sess.query([query])
    assert [(h.name, h.matches, h.fragments) for h in got] == [
        (h.name, h.matches, h.fragments) for h in expected
    ]
    for a, b in zip(got, expected):
        assert a.identity == b.identity  # bitwise: fixed-point identity sums


def test_concurrent_queries_match_serial():
    """The reference documents query_* as safe to call concurrently from
    Python threads (ref _fastani.pyx:1157-1162, GIL released per
    fragment).  The jax backend funnels queries into one cached
    ShardedSession whose staging buffers are recycled across calls; the
    session lock must keep concurrent queries from corrupting each
    other's staging."""
    import concurrent.futures

    rng = np.random.default_rng(29)
    refs = [_rand_genome(rng, n) for n in (40_000, 30_000, 25_000)]
    queries = [_mutate(rng, refs[i % 3], 0.03) for i in range(6)]

    sk = Sketch(backend="jax")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()

    serial = [mapper.query_genome(q) for q in queries]
    assert any(serial), "workload produced no hits at all"

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        threaded = list(pool.map(mapper.query_genome, queries))

    assert threaded == serial


def test_lookup_index_edit_invalidates_jax_session():
    """Editing `lookup_index` on a jax-backend mapper must invalidate the
    cached device session (PostingIndex.version ride-along,
    _sketch.py:_device_session) -- queries after the edit read the edited
    posting rows."""
    rng = np.random.default_rng(31)
    ref = _rand_genome(rng, 50_000)
    query = _mutate(rng, ref, 0.02)

    sk = Sketch(backend="jax")
    sk.add_genome("g0", ref)
    mapper = sk.index()
    assert mapper.query_genome(query)

    idx = mapper.lookup_index
    for h in list(idx):
        del idx[h]
    assert len(mapper.lookup_index) == 0
    assert mapper.query_genome(query) == []


def test_many_genomes_per_shard():
    """>=128 genomes in a single shard (BASELINE.json config-4 shape):
    the per-shard capacity derivations (ivmax, bin_max, per-genome CGI
    segmentation) must hold with zero escalations and match the host
    engine."""
    rng = np.random.default_rng(53)
    genomes = []
    for fam in range(32):  # 32 families x 4 mutants = 128 genomes
        base = _rand_genome(rng, 18_000 + 500 * (fam % 5))
        for _ in range(4):
            genomes.append(_mutate(rng, base, 0.03))

    sk = Sketch(backend="numpy")
    for i, g in enumerate(genomes):
        sk.add_genome(f"g{i}", g)
    mapper = sk.index()

    from pyfastani_tpu.parallel.sharded import ShardedSession

    mesh = make_mesh(len(jax.devices()), 1)  # all-data, ONE shard
    sess = ShardedSession(mapper, mesh)
    queries = [genomes[i] for i in (0, 41, 87, 126)]
    got = sess.query_many([[q] for q in queries])
    assert sess.stats["budget_escalations"] == 0, sess.budgets
    for q, hits in zip(queries, got):
        expected = mapper.query_genome(q)
        assert [(h.name, h.matches, h.fragments) for h in hits] == [
            (h.name, h.matches, h.fragments) for h in expected
        ]
        for a, b in zip(hits, expected):
            assert a.identity == b.identity  # bitwise: fixed-point identity sums


def test_checkpoint_without_gpos_bucket_rebuilds(tmp_path):
    """Checkpoints predating the gpos prefix table restore cleanly: the
    session rebuilds the table lazily and results are unchanged."""
    from pyfastani_tpu.parallel.sharded import (
        ShardedIndex,
        ShardedSession,
        build_sharded_index,
    )

    rng = np.random.default_rng(61)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000)]
    query = _mutate(rng, refs[0], 0.04)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    expected = mapper.query_genome(query)

    sidx = build_sharded_index(mapper, 1)
    sidx.gpos_bucket = None  # simulate a pre-table checkpoint
    sidx.gpos_shift = 0
    sidx.gpos_steps = 0
    path = str(tmp_path / "old_index")
    sidx.save(path)
    restored = ShardedIndex.load(path)
    assert restored.gpos_bucket is None

    sess = ShardedSession.from_index(
        restored, mesh=make_mesh(1, 1),
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64,
        smax=256,
    )
    assert sess.sidx.gpos_bucket is not None and sess.sidx.gpos_steps >= 1
    got = sess.query([query])
    assert [(h.name, h.matches, h.fragments) for h in got] == [
        (h.name, h.matches, h.fragments) for h in expected
    ]


def test_session_warmup_api():
    """`ShardedSession.warmup` compiles the requested fragment buckets
    ahead of time and returns per-bucket seconds; queries after warmup
    reuse the compiled program (no new variants)."""
    from pyfastani_tpu.parallel.sharded import ShardedSession

    rng = np.random.default_rng(71)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000)]
    query = _mutate(rng, refs[0], 0.03)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()

    sess = ShardedSession(
        mapper, make_mesh(1, 1),
        hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64,
        smax=256,
    )
    rep = sess.warmup([10])
    assert rep and all(v >= 0 for v in rep.values())
    variants = sess.stats["compiled_variants"]
    hits = sess.query([query])
    assert hits and hits[0].name == "g0"
    assert sess.stats["compiled_variants"] == variants
