"""Standalone scipy eigsh baseline for the north-star problem.

Builds the same graph Laplacian as scripts/northstar.py and times
scipy.sparse.linalg.eigsh(k, which="SA") on the host CPU — runnable in
parallel with the device solve so the wall-clock race does not serialize.
It keeps JAX on the CPU backend, so it never takes the GPU's memory from the
solve beside it.
Writes {out} with the timing (or the elapsed lower bound on timeout/kill).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=432)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--out", default="/tmp/northstar_scipy.json")
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"  # set before anything imports JAX
    from northstar import build_graph_laplacian_rows  # noqa: E402

    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import scipy.sparse
    import scipy.sparse.linalg

    print("[scipy-baseline] building lattice ...", flush=True)
    lat, nbrs, rels, weights, deg, times = build_graph_laplacian_rows(
        args.n_fine, args.box_depth
    )
    p = lat.num_points
    rows = np.repeat(np.arange(p, dtype=np.int64), nbrs.shape[1])
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    A = scipy.sparse.csr_matrix(
        (np.ones(valid.sum(), dtype=np.float64), (rows[valid], cols[valid])),
        shape=(p, p),
    )
    L = scipy.sparse.diags(deg) - A
    del lat, nbrs, rels, weights, rows, cols, valid, A
    info = {"num_points": int(p), "k": args.k, "tol": args.tol,
            "host_cores": os.cpu_count()}
    # Record start so a killed run still yields an elapsed lower bound.
    t0 = time.time()
    info["started_unix"] = t0
    with open(args.out, "w") as f:
        json.dump({**info, "status": "running"}, f)
    print(f"[scipy-baseline] P={p}, starting eigsh ...", flush=True)
    vals = scipy.sparse.linalg.eigsh(L, k=args.k, which="SA", tol=args.tol)[0]
    info["scipy_eigsh_s"] = time.time() - t0
    info["eigenvalues_head"] = np.sort(vals)[:10].tolist()
    info["status"] = "done"
    with open(args.out, "w") as f:
        json.dump(info, f, indent=1)
    print(f"[scipy-baseline] done in {info['scipy_eigsh_s']:.1f}s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
