"""Host index-build throughput at bench scale (VERDICT r04 ask #3).

Measures the full ingest pipeline -- C winnow sketching, CSR construction
(threaded radix sort), sharded-index assembly, budget presizing -- on the
256-genome all-vs-all workload, without touching the device.

Usage: JAX_PLATFORMS=cpu python benches/profile_index_build.py [n_genomes]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n_genomes = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    lengths = [1000000, 2000000, 3000000, 5000000]
    genomes = []
    for fam in range(-(-n_genomes // 4)):
        base = rng.choice(alphabet, size=lengths[fam % 4])
        for _ in range(min(4, n_genomes - len(genomes))):
            arr = base.copy()
            idx = rng.random(arr.shape[0]) < 0.03
            arr[idx] = rng.choice(alphabet, size=int(idx.sum()))
            genomes.append(arr.tobytes())
    total = sum(len(g) for g in genomes) / 1e6
    print(f"{len(genomes)} genomes, {total:.0f} Mbp")

    from pyfastani_tpu import Sketch
    from pyfastani_tpu.parallel.sharded import (
        _presize_budgets, build_sharded_index,
    )

    t0 = time.time()
    sk = Sketch(backend="numpy")
    for i, g in enumerate(genomes):
        sk.add_genome(f"g{i}", g)
    t1 = time.time()
    print(f"add_genome (C winnow): {t1-t0:6.2f}s  ({total/(t1-t0):.0f} Mbp/s)")
    mapper = sk.index()
    t2 = time.time()
    print(f"index() CSR:           {t2-t1:6.2f}s  ({mapper._index.n_minimizers} minis)")
    sidx = build_sharded_index(mapper, 1)
    t3 = time.time()
    print(f"build_sharded_index:   {t3-t2:6.2f}s")
    budgets = _presize_budgets(sidx, mapper._param, {})
    t4 = time.time()
    print(f"presize:               {t4-t3:6.2f}s  {budgets}")
    print(f"TOTAL: {t4-t0:.2f}s = {total/(t4-t0):.1f} Mbp/s index build")


if __name__ == "__main__":
    main()
