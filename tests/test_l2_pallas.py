"""Parity tests for the GPU L2 kernel (`ops.l2_pallas`).

The kernel must reproduce `ops.l2.l2_chunk_scan` (the XLA event-scan
formulation, itself validated against the host oracle and the reference
goldens) bit-exactly: same best shared-sketch count and same first/last
maximal anchors per chunk.  Tolerance is exact equality: the outputs are
integers and neither side has a float matrix product, so TF32 and
summation order do not apply.  Reference semantics: ``slidingMap.hpp`` /
``computeL2MappedRegions`` declared at
``include/fastani/map/compute_map.pxd:30-51``.

On the CPU the kernel runs through the Pallas interpreter; the test
marked ``gpu`` runs it compiled for the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pyfastani_tpu.ops.l2 import l2_chunk_scan
from pyfastani_tpu.ops.l2_pallas import compute_mini_prev, l2_chunks_pallas


def _mini_store(rng, m, n_contigs=2, hash_bits=18, base=0, gap=(5, 20)):
    """Synthetic position-ordered minimizer store with dense hash reuse;
    contig-local positions start at ``base``."""
    gpos = np.cumsum(rng.integers(*gap, size=m))
    bounds = np.sort(rng.choice(gpos[m // 8 :], size=n_contigs - 1, replace=False))
    seqid = np.searchsorted(bounds, gpos, side="right").astype(np.int32)
    starts = np.concatenate([[0], bounds])
    wpos = (gpos - starts[seqid] + base).astype(np.int32)
    mh = rng.integers(0, 1 << hash_bits, size=m).astype(np.uint32)
    return mh, seqid, wpos


def _sketches(rng, mh, F, S, ragged=False):
    q = np.sort(rng.choice(mh, size=(F, S)), axis=1).astype(np.uint32)
    s_sizes = np.full(F, S, np.int32)
    if ragged:
        s_sizes = rng.integers(S // 2, S + 1, size=F).astype(np.int32)
        q[np.arange(S)[None, :] >= s_sizes[:, None]] = np.uint32(0xFFFFFFFF)
    return q, s_sizes


def _contig_pure(seqid, lo, rlen):
    """Cut each range at its first contig change (the sharded caller
    clamps ranges to one contig's minimizer block)."""
    rlen = rlen.copy()
    cseq = seqid[lo]
    for i in range(lo.shape[0]):
        run = np.flatnonzero(seqid[lo[i] : lo[i] + rlen[i]] != cseq[i])
        if run.size:
            rlen[i] = run[0]
    return rlen


def _assert_kernel_matches(q, s_sizes, mh, wpos, prev, frag, c0, clen, lo, rlen,
                           cmw=2985, cmax=3072, interpret=True):
    chunks = np.stack([frag, c0, clen, lo, rlen], axis=1).astype(np.int32)
    want = l2_chunk_scan(q, s_sizes, mh, wpos, chunks, cmw, cmax)
    got = l2_chunks_pallas(
        jnp.asarray(q), jnp.asarray(s_sizes), mh, wpos, prev,
        *(jnp.asarray(a, jnp.int32) for a in (frag, c0, clen, lo, rlen)),
        cmw=cmw, interpret=interpret,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, np.asarray(g))
    return want


def test_compute_mini_prev():
    rng = np.random.default_rng(0)
    mh, seqid, wpos = _mini_store(rng, 5000)
    prev = compute_mini_prev(mh, seqid, wpos)
    # oracle: dict scan in position order per (hash, contig)
    last = {}
    for j in np.lexsort((wpos, seqid)):
        key = (int(mh[j]), int(seqid[j]))
        expect = last.get(key, -(2**30))
        assert prev[j] == expect, (j, prev[j], expect)
        last[key] = int(wpos[j])


@pytest.mark.parametrize("seed", [1, 2])
def test_pallas_matches_xla_event_scan(seed):
    rng = np.random.default_rng(seed)
    M = 20000
    mh, seqid, wpos = _mini_store(rng, M)
    prev = compute_mini_prev(mh, seqid, wpos)
    q, s_sizes = _sketches(rng, mh, 16, 256, ragged=seed == 2)

    N = 64
    lo = rng.integers(0, M - 900, size=N).astype(np.int32)
    rlen = _contig_pure(seqid, lo, rng.integers(0, 700, size=N).astype(np.int32))
    frag = rng.integers(0, 16, size=N).astype(np.int32)
    clen = rng.integers(1, 3072, size=N).astype(np.int32)
    best, _, _ = _assert_kernel_matches(
        q, s_sizes, mh, wpos, prev, frag, wpos[lo], clen, lo, rlen
    )
    assert (best > 0).sum() > N // 2  # the sweep found real maxima


def test_pallas_empty_and_edge_chunks():
    rng = np.random.default_rng(3)
    M = 4096
    mh, seqid, wpos = _mini_store(rng, M, n_contigs=1)
    prev = compute_mini_prev(mh, seqid, wpos)
    q, s_sizes = _sketches(rng, mh, 8, 128)

    # zero-length ranges, zero-length chunks, a range at the very end,
    # one-entry and one-block-plus-one ranges
    frag = np.array([0, 1, 2, 3, 4, 5], np.int32)
    lo = np.array([0, M - 10, 100, 0, 7, 300], np.int32)
    rlen = np.array([0, 10, 0, 5, 1, 65], np.int32)
    c0 = np.array([0, wpos[M - 10], 50, 0, wpos[7], wpos[300]], np.int32)
    clen = np.array([100, 3072, 0, 1, 1, 3072], np.int32)
    best, first, last = _assert_kernel_matches(
        q, s_sizes, mh, wpos, prev, frag, c0, clen, lo, rlen
    )
    assert best[0] == best[2] == -1 and first[0] == last[0] == 0


def test_pallas_largest_rmax_high_positions():
    """Ranges at the presizer's largest rmax (8192 entries) with window
    positions near 2^30, far past the 2^24 limit of float-carried
    positions, on a dense store so the band spans many blocks."""
    rng = np.random.default_rng(5)
    M = 40000
    mh, seqid, wpos = _mini_store(
        rng, M, n_contigs=1, hash_bits=12, base=2**30 - 2**21, gap=(1, 4)
    )
    prev = compute_mini_prev(mh, seqid, wpos)
    q, s_sizes = _sketches(rng, mh, 8, 512)
    N = 24
    lo = rng.integers(0, M - 8200, size=N).astype(np.int32)
    rlen = np.full(N, 8192, np.int32)
    rlen[:3] = [0, 1, 63]
    frag = rng.integers(0, 8, size=N).astype(np.int32)
    clen = rng.integers(1, 3072, size=N).astype(np.int32)
    best, _, _ = _assert_kernel_matches(
        q, s_sizes, mh, wpos, prev, frag, wpos[lo], clen, lo, rlen
    )
    assert wpos.min() >= 2**24 and best.max() > 20


@pytest.mark.gpu
def test_pallas_compiled_matches_xla_event_scan():
    """The kernel as compiled for the GPU, at real widths: ranges up to
    rmax + 128 = 1024 entries, 384-hash sketches, 16k chunks, positions
    above 2^24."""
    rng = np.random.default_rng(11)
    M = 400_000
    mh, seqid, wpos = _mini_store(rng, M, n_contigs=3, hash_bits=20, base=2**24, gap=(1, 24))
    prev = compute_mini_prev(mh, seqid, wpos)
    q, s_sizes = _sketches(rng, mh, 4096, 384, ragged=True)
    N = 16384
    lo = rng.integers(0, M - 1024, size=N).astype(np.int32)
    rlen = _contig_pure(seqid, lo, rng.integers(0, 1025, size=N).astype(np.int32))
    frag = rng.integers(0, 4096, size=N).astype(np.int32)
    clen = rng.integers(1, 3073, size=N).astype(np.int32)
    _assert_kernel_matches(
        q, s_sizes, mh, wpos, prev, frag, wpos[lo], clen, lo, rlen,
        interpret=False,
    )
