"""Mapping benchmark harness (the analogue of the reference's
``benches/mapping/bench.py``, which sweeps thread counts on a CPU pool).

On the device the sweep axis is the *query batch size* instead of threads: the
fragment axis of one device dispatch plays the role the thread pool plays
in the reference.  Results are written as JSON records compatible in
spirit with the reference's ``v0.6.0.json`` (per-genome wall times over
repeated runs).

Data: point ``--data`` at a directory of FASTA files (parsed with the
built-in `pyfastani_tpu._fasta.Parser`), or use ``--synthetic N,LEN`` to
generate N random genomes of LEN bp with 3%-mutated queries (no dataset
download is possible in an air-gapped environment).

Usage:
    python benches/mapping/bench.py --synthetic 10,2000000 -o out.json
    python benches/mapping/bench.py --data ./genomes -o out.json
"""

import argparse
import glob
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.realpath(os.path.join(__file__, "..", "..", "..")))

import numpy as np


def load_genomes(args):
    if args.synthetic:
        n, length = (int(x) for x in args.synthetic.split(","))
        rng = np.random.default_rng(args.seed)
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        refs = []
        for i in range(n):
            refs.append((f"synthetic_{i}", [rng.choice(alphabet, size=length).tobytes()]))
        queries = []
        for i in range(n):
            base = np.frombuffer(refs[i][1][0], dtype=np.uint8).copy()
            idx = rng.random(base.shape[0]) < args.mutation
            base[idx] = rng.choice(alphabet, size=int(idx.sum()))
            queries.append((refs[i][0], [base.tobytes()]))
        return refs, queries
    from pyfastani_tpu._fasta import Parser

    genomes = []
    for filename in sorted(glob.glob(os.path.join(args.data, "*.fna"))) + sorted(
        glob.glob(os.path.join(args.data, "*.fa"))
    ):
        records = list(Parser(filename))
        if records:
            genomes.append((records[0].id, [r.seq for r in records]))
    return genomes, genomes  # all-vs-all


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-r", "--runs", default=3, type=int)
    parser.add_argument("-d", "--data")
    parser.add_argument("--synthetic", help="N,LEN -- generate N random genomes")
    parser.add_argument("--mutation", default=0.03, type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument(
        "-b", "--batch-sizes", default="1,2,4,8",
        help="query batch sizes to sweep (the device analogue of threads)",
    )
    args = parser.parse_args()
    if not args.data and not args.synthetic:
        parser.error("need --data or --synthetic")

    from pyfastani_tpu import Sketch
    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import ShardedSession

    refs, queries = load_genomes(args)
    print(f"[bench] {len(refs)} reference genomes", file=sys.stderr)

    t0 = time.time()
    sketch = Sketch()
    for name, contigs in refs:
        sketch.add_draft(name, contigs)
    mapper = sketch.index()
    t_index = time.time() - t0
    print(f"[bench] indexed in {t_index:.1f}s", file=sys.stderr)

    session = ShardedSession(mapper, make_mesh())
    results = {"index_s": t_index, "results": []}

    for batch in (int(b) for b in args.batch_sizes.split(",")):
        batches = [queries[i : i + batch] for i in range(0, len(queries), batch)]
        # warmup compile for this batch shape
        session.query_many([c for _, c in batches[0]])
        times = []
        total_bp = sum(sum(len(c) for c in contigs) for _, contigs in queries)
        for run in range(args.runs):
            t0 = time.time()
            for group in batches:
                session.query_many([c for _, c in group])
            times.append(time.time() - t0)
        results["results"].append(
            {
                "batch": batch,
                "genomes": len(queries),
                "total_bp": total_bp,
                "times": times,
                "mean_s": statistics.mean(times),
                "mbp_per_s": total_bp / 1e6 / min(times),
            }
        )
        print(
            f"[bench] batch={batch}: {min(times):.2f}s "
            f"({total_bp / 1e6 / min(times):.2f} Mbp/s)",
            file=sys.stderr,
        )

    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[bench] wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
