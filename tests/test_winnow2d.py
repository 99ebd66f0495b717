"""(R, 128)-layout chunked winnowing vs the 1-D host specification.

`ops.winnow2d` re-derives winnowing (hashing, palindrome skip, sliding
minimum, dedup, the window-0 suppression quirk) in the (R, 128) layout
with carried chunk boundaries; it must be bitwise identical to
`models._engine_np.winnow_sequence` (itself pinned to the reference deque
loop by tests/test_winnow.py) for every chunk size.
"""

import numpy as np
import pytest

from pyfastani_tpu.models._engine_np import winnow_sequence
from pyfastani_tpu.models._params import Parameters
from pyfastani_tpu.ops import winnow2d as w2d
from pyfastani_tpu.ops.codec import to_bytes


def _winnow_chunked_np(data, k, w, protein, B):
    """Run the 2-D chunked formulation eagerly under numpy."""
    n = len(data)
    n_pos = n - k + 1
    n_windows = n_pos - w + 1
    if n_pos < 1 or n_windows < 1:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    R = w2d.chunk_slice_rows(B, w, k)
    L = R * 128
    carry = (np.bool_(False), np.int32(0), np.bool_(False), np.uint32(0))
    out_h, out_p = [], []
    with np.errstate(over="ignore"):
        for base in range(0, n_windows, B):
            sl = np.zeros(L, np.uint8)
            avail = data[base : base + L]
            sl[: len(avail)] = avail
            rec, wh, carry = w2d.winnow_chunk2d(
                np,
                sl.reshape(R, 128),
                np.int32(n_pos - base),
                np.int32(base),
                carry,
                k=k,
                w=w,
                B=B,
                protein=protein,
                first_chunk=(base == 0),
            )
            take = min(B, n_windows - base)
            r = rec.ravel()[:take]
            h = wh.ravel()[:take]
            sel = np.flatnonzero(r)
            out_h.append(h[sel])
            out_p.append((sel + base).astype(np.int32))
    return np.concatenate(out_h), np.concatenate(out_p)


def _reference(data, k, w, protein):
    params = Parameters(
        kmer_size=k, window_size=w, alphabet_size=20 if protein else 4
    )
    return winnow_sequence(data, params)


@pytest.mark.parametrize("protein", [False, True])
@pytest.mark.parametrize(
    "k,w", [(3, 5), (5, 4), (16, 24), (16, 5), (7, 7), (16, 1)]
)
def test_random_sequences_all_chunkings(k, w, protein):
    rng = np.random.default_rng(hash((k, w, protein)) % 2**32)
    alphabet = np.frombuffer(b"ACGTNacgtRYSWn", dtype=np.uint8)
    for trial in range(4):
        n = int(rng.integers(k + w - 1, 2500))
        data = to_bytes(rng.choice(alphabet, size=n).tobytes())
        h0, p0 = _reference(data, k, w, protein)
        for B in (128, 1024):
            h1, p1 = _winnow_chunked_np(data, k, w, protein, B)
            assert np.array_equal(h0, h1), (k, w, protein, n, B)
            assert np.array_equal(p0, p1), (k, w, protein, n, B)


def test_quirk_cases_across_chunk_boundaries():
    # low-complexity inputs drive the tie-to-latest + window-0 suppression
    # paths; small chunks force the carry across every recurrence
    seqs = [
        b"A" * 500,
        b"AT" * 300,
        b"ACG" * 200,
        b"AAAT" + b"A" * 400,
        b"A" * 100 + b"CGTAC" * 80,
    ]
    for seq in seqs:
        data = to_bytes(seq)
        for k, w in [(4, 3), (16, 24), (5, 1), (3, 7)]:
            if len(seq) < k + w - 1:
                continue
            h0, p0 = _reference(data, k, w, False)
            for B in (64, 256):
                h1, p1 = _winnow_chunked_np(data, k, w, False, B)
                assert np.array_equal(h0, h1), (seq[:6], k, w, B)
                assert np.array_equal(p0, p1), (seq[:6], k, w, B)


def test_device_long_sequence_matches_host():
    jax = pytest.importorskip("jax")
    from pyfastani_tpu.ops.fragments import winnow_long_sequence

    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    for n in (5000, 70000):
        data = rng.choice(alphabet, size=n)
        h0, p0 = _reference(data, 16, 24, False)
        h1, p1 = winnow_long_sequence(data, 16, 24, False, chunk=1 << 14)
        assert np.array_equal(h0, h1)
        assert np.array_equal(p0, p1)


def test_winnow_sequence_device_wrapper():
    """`_engine_jax.winnow_sequence_device` (the device ingest wrapper for
    device-resident pipelines) matches the host winnow bitwise."""
    import numpy as np

    from pyfastani_tpu.models import _engine_jax
    from pyfastani_tpu.models._engine_np import winnow_sequence
    from pyfastani_tpu.models._params import Parameters

    rng = np.random.default_rng(11)
    data = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=30_000)
    params = Parameters(kmer_size=16, window_size=24)
    dh, dp = _engine_jax.winnow_sequence_device(data, params)
    hh, hp = winnow_sequence(data, params)
    assert np.array_equal(np.asarray(dh), hh)
    assert np.array_equal(np.asarray(dp), hp)
