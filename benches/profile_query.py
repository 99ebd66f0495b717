"""Profile the sharded query path: host staging vs device compute vs fetch."""
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

    from pyfastani_tpu import Sketch
    from pyfastani_tpu.parallel.mesh import make_mesh
    from pyfastani_tpu.parallel.sharded import ShardedSession

    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(alphabet, size=REF_LEN).tobytes() for _ in range(N_REFS)]
    queries = []
    for i in range(N_QUERIES):
        base = np.frombuffer(refs[i % N_REFS], dtype=np.uint8).copy()
        idx = rng.random(base.shape[0]) < 0.03
        base[idx] = rng.choice(alphabet, size=int(idx.sum()))
        queries.append(base.tobytes())

    t0 = time.time()
    sketch = Sketch()
    for i, r in enumerate(refs):
        t1 = time.time()
        sketch.add_genome(f"ref{i}", r)
        print(f"  add ref{i}: {time.time()-t1:.2f}s", file=sys.stderr)
    mapper = sketch.index()
    print(f"index total: {time.time()-t0:.1f}s", file=sys.stderr)

    mesh = make_mesh(1, len(jax.devices()))
    session = ShardedSession(mapper, mesh)
    session.query_many([[q] for q in queries])  # warmup

    # full path
    t0 = time.time()
    session.query_many([[q] for q in queries])
    t_full = time.time() - t0

    # host staging only
    t0 = time.time()
    per_genome = [session._fragments([q]) for q in queries]
    t_fragment = time.time() - t0

    l = session.params.min_read_length
    Fb = session._frag_bucket(sum(p[1] for p in per_genome))
    frags = np.zeros((Fb, l + 4), dtype=np.uint8)
    frag_qg = np.zeros(Fb, dtype=np.int32)
    t0 = time.time()
    row = 0
    for qg, (blocks, _, _) in enumerate(per_genome):
        for block in blocks:
            n = block.shape[0]
            frags[row : row + n, :l] = block
            frag_qg[row : row + n] = qg
            row += n
    t_stage = time.time() - t0

    fn = session._get_fn()
    # device compute only (inputs already on device)
    darg0 = jax.device_put(jnp.asarray(frags))
    darg1 = jax.device_put(jnp.asarray(frag_qg))
    jax.block_until_ready((darg0, darg1))
    t0 = time.time()
    out = fn(
        darg0, darg1, *session._index_args, session._ident_tab,
        session._gpos_bucket_dev,
    )
    jax.block_until_ready(out)
    t_dev = time.time() - t0

    # transfer only
    t0 = time.time()
    x = jnp.asarray(frags)
    jax.block_until_ready(x)
    t_xfer = time.time() - t0

    total_bp = sum(len(q) for q in queries)
    print(f"full query_many:   {t_full*1e3:8.1f} ms  ({total_bp/1e6/t_full:.1f} Mbp/s)")
    print(f"  fragment (host): {t_fragment*1e3:8.1f} ms")
    print(f"  staging (host):  {t_stage*1e3:8.1f} ms")
    print(f"  h2d transfer:    {t_xfer*1e3:8.1f} ms")
    print(f"  device compute:  {t_dev*1e3:8.1f} ms  ({total_bp/1e6/t_dev:.1f} Mbp/s)")


if __name__ == "__main__":
    main()
