"""Sharded pipeline through the GPU L2 kernel vs the host engine.

On the CPU the session runs the kernel through the Pallas interpreter
(``interpret_kernels=True``) on the 8-device mesh, exercising the exact
kernel branch of `parallel.sharded._l2_interval_scan`; the test marked
``gpu`` runs the session's own platform choice on the card.
"""

import numpy as np
import pytest

from pyfastani_tpu import Sketch
from pyfastani_tpu.parallel.mesh import make_mesh
from pyfastani_tpu.parallel.sharded import ShardedSession, _l2_kernel_for


def _rand_genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def _mutate(rng, seq, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(
        np.frombuffer(b"ACGT", dtype=np.uint8), size=int(idx.sum())
    )
    return arr.tobytes()


def _workload():
    rng = np.random.default_rng(31)
    refs = [_rand_genome(rng, n) for n in (40_000, 25_000, 31_000)]
    queries = [_mutate(rng, refs[1], 0.04), refs[0]]
    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    return mapper, queries, [mapper.query_genome(q) for q in queries]


def _assert_same(got, expected):
    for g, e in zip(got, expected):
        assert [(h.name, h.matches, h.fragments) for h in g] == [
            (h.name, h.matches, h.fragments) for h in e
        ]
        for a, b in zip(g, e):
            assert a.identity == b.identity  # bitwise: fixed-point identity sums


def test_sharded_pallas_matches_host(eight_devices):
    mapper, queries, expected = _workload()
    session = ShardedSession(
        mapper, make_mesh(2, 4),
        hmax=512, ivmax=16, cmax=128, rmax=896, t_chunks=52, bin_max=64,
        smax=256, frag_capacity=32, q_capacity=2, interpret_kernels=True,
    )
    assert session._l2_kernel == "interpret"
    _assert_same(session.query_many([[q] for q in queries]), expected)


@pytest.mark.parametrize(
    "platform, interpret, path",
    [("gpu", False, "triton"), ("cpu", False, "xla"), ("cpu", True, "interpret")],
)
def test_l2_path_follows_platform(platform, interpret, path):
    assert _l2_kernel_for(platform, interpret) == path


@pytest.mark.gpu
def test_sharded_gpu_matches_host():
    mapper, queries, expected = _workload()
    session = ShardedSession(mapper, make_mesh(1, 1), q_capacity=2)
    assert session._l2_kernel == "triton"
    _assert_same(session.query_many([[q] for q in queries]), expected)
