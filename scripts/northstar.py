"""North-star run (BASELINE.md): k=100 eigenpairs of a 10M+-node irregular
graph Laplacian to 1e-8 residual on one GPU, vs scipy eigsh on the host.

The graph is the irregular multi-resolution lattice's neighbor graph
(reference geometry: /root/reference/Python/Irregular/IrrGrid.py), made
undirected by edge reciprocity (keep (i,j) iff both endpoints list each
other), so L = D - A is exactly symmetric.  Pipeline:

1. CompositeV2 operator (ops/composite2.py): region-native layout, per-level
   stencils, strided interface classes — integer coefficients, so the
   fp32 operator is EXACT.
2. fp32 compensated thick-restart Lanczos (solver/restart.py) for
   k + buffer pairs down to the fp32 floor, with a live-masked start vector
   (dead region slots stay exactly zero).
3. Double-word refinement (solver/refine.py, host-anchored variant): breaks
   the fp32 storage floor; residuals computed with error-free tap products.
   A +1 spectral shift keeps the relative-residual criterion well-defined at
   the lambda=0 end (subtracted before reporting): rel residual vs the
   shifted eigenvalue ~ ABSOLUTE residual for the low modes.
4. TRUE fp64 residuals on the host scipy matrix; scipy eigsh wall-clock race.

Writes one JSON artifact (``--out``); ``main(argv)`` also returns it as a
dict, for in-process callers such as chip_smoke.py.

Usage: python scripts/northstar.py [--n-fine 432] [--k 100] [--tol 1e-8]
       [--scipy-timeout 1800] [--out northstar.json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_graph_laplacian_rows(n_fine: int, box_depth: int = 3):
    """Lattice -> symmetric graph-Laplacian rows (nbrs, rels, weights, deg)."""
    from lanczos_tpu.models.lattice import build_lattice, find_neighbors

    nb = box_depth**3
    sp = np.full(nb, 2, dtype=np.int64)
    sp[nb // 2] = 1  # the reference's overwrite_spacing debug lattice shape
    t0 = time.time()
    lat = build_lattice(n_fine, 25.0, box_depth, spacings=sp, ndim=3)
    nbrs, rels = find_neighbors(lat, 1)
    t_nbrs = time.time() - t0

    # Edge reciprocity: keep (i -> j) only if (j -> i) exists.  Native row
    # scan when the C++ engine is available (246 s -> seconds at 341M
    # edges); numpy sorted-key membership fallback otherwise.
    from lanczos_tpu.native import reciprocal_mask_native

    t0 = time.time()
    p, k = nbrs.shape
    keep = reciprocal_mask_native(nbrs)
    if keep is None:
        rows = np.repeat(np.arange(p, dtype=np.int64), k)
        cols = nbrs.reshape(-1)
        valid = cols >= 0
        rows_v, cols_v = rows[valid], cols[valid]
        fwd = rows_v * p + cols_v
        bwd = np.sort(cols_v * p + rows_v)
        pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
        recip = bwd[pos] == fwd
        keep = np.zeros(p * k, dtype=bool)
        keep[valid] = recip
        keep = keep.reshape(p, k)
    nbrs = np.where(keep, nbrs, -1)
    weights = np.where(keep, -1.0, 0.0)
    deg = keep.sum(axis=1).astype(np.float64)
    t_recip = time.time() - t0
    return lat, nbrs, rels, weights, deg, {"t_neighbors_s": t_nbrs,
                                           "t_reciprocity_s": t_recip}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=432)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--k-buffer", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--fp32-tol", type=float, default=3e-7)
    ap.add_argument("--max-basis", type=int, default=0)
    ap.add_argument("--n-locked", type=int, default=0)
    ap.add_argument("--max-cycles", type=int, default=400)
    ap.add_argument("--refine-rounds", type=int, default=4)
    ap.add_argument("--col-chunk", type=int, default=8)
    ap.add_argument(
        "--min-grid-rows", type=int, default=4096,
        help="interface pieces below this go to the block-ELL tail; keeps "
        "the strided-class op count (and hence XLA compile time) bounded "
        "at 10M+ scale",
    )
    ap.add_argument("--cg-steps", type=int, default=200)
    ap.add_argument("--scipy-timeout", type=float, default=1800.0)
    ap.add_argument("--skip-scipy", action="store_true")
    ap.add_argument("--skip-refine", action="store_true")
    ap.add_argument("--save-vectors", default="",
                    help="npz path for (lam, X64 region-layout, idx_map) — "
                    "enables continuing the refinement without re-solving")
    ap.add_argument(
        "--solve-cache", default="",
        help="npz path: the fp32 solve result is saved here right after "
        "readback, and reloaded instead of re-solving when the file exists",
    )
    ap.add_argument(
        "--checkpoint", default="",
        help="npz path for per-cycle solver checkpoints (locked block + "
        "restart vector); the solve resumes from the file when it exists",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=10,
        help="cycles between solver checkpoints (the state is ~6 GB at "
        "north-star scale; every cycle would saturate the disk)",
    )
    ap.add_argument(
        "--scipy-json", default="",
        help="merge the race result of a standalone parallel "
        "scripts/northstar_scipy.py run instead of racing in-process",
    )
    ap.add_argument("--out", default="northstar.json")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from lanczos_tpu.ops.composite2 import build_composite_v2
    from lanczos_tpu.solver.refine import refine_eigenpairs_dd_hosted
    from lanczos_tpu.solver.restart import eigsh_restarted
    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    if os.environ.get("NORTHSTAR_CPU"):
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    kk = args.k + args.k_buffer
    info = {
        "problem": "irregular lattice graph Laplacian, k smallest",
        "n_fine": args.n_fine,
        "box_depth": args.box_depth,
        "k": args.k,
        "k_buffer": args.k_buffer,
        "tol": args.tol,
        "dtype": "float32 (+ double-word refinement)",
        "compensated": True,
    }
    print(f"[northstar] building lattice N={args.n_fine} ...", flush=True)
    lat, nbrs, rels, weights, deg, times = build_graph_laplacian_rows(
        args.n_fine, args.box_depth
    )
    p = lat.num_points
    nnz = int((nbrs >= 0).sum() + p)
    info.update(times, num_points=p, nnz=nnz)
    print(f"[northstar] P={p} nnz={nnz} "
          f"(neighbors {times['t_neighbors_s']:.1f}s)", flush=True)

    dev = jax.devices()[0]
    info["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}
    shift = 1.0
    t0 = time.time()
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + shift, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=args.min_grid_rows,
    )
    m_op = comp.shape[0]
    info["t_build_composite_s"] = time.time() - t0
    info["m_operator"] = int(m_op)
    info["n_interface_classes"] = len(comp.grid_meta)
    print(f"[northstar] composite v2 built in {info['t_build_composite_s']:.1f}s "
          f"(M={m_op}, {len(comp.grid_meta)} classes)", flush=True)

    # fp32 compensated thick restart with a live-masked start vector.
    max_basis = args.max_basis or min(2 * kk + 30, 144 if p > 4e6 else 2 * kk + 30)
    n_locked = args.n_locked or min(kk + 4, max_basis - 2)
    info["max_basis"] = max_basis
    info["n_locked"] = n_locked
    if args.solve_cache and os.path.exists(args.solve_cache):
        print(f"[northstar] resuming fp32 solve from {args.solve_cache}",
              flush=True)
        cache = np.load(args.solve_cache)
        lam32 = np.asarray(cache["lam32"], np.float64)
        X32 = np.asarray(cache["X32"], np.float32)
        info["t_solve_fp32_s"] = float(cache["t_solve_fp32_s"])
        info["solve_resumed_from_cache"] = True
    else:
        rng = np.random.default_rng(99)
        v0 = np.zeros(m_op, dtype=np.float32)
        v0[idx_map] = rng.uniform(-1, 1, size=p).astype(np.float32)
        t0 = time.time()
        res = eigsh_restarted(
            comp,
            k=kk,
            tol=args.fp32_tol,
            which="SA",
            dtype="float32",
            v0=jnp.asarray(v0),
            compensated=True,
            max_basis=max_basis,
            n_locked=n_locked,
            max_cycles=args.max_cycles,
            rr_verify=False,
            verbose=True,
            checkpoint_path=args.checkpoint or None,
            checkpoint_every=args.checkpoint_every,
        )
        info["t_solve_fp32_s"] = time.time() - t0
        lam32 = np.asarray(res.eigenvalues, np.float64)
        X32 = np.asarray(res.eigenvectors)  # (M, kk) fp32, host
        del res
        if args.solve_cache:
            np.savez(args.solve_cache, lam32=lam32, X32=X32,
                     t_solve_fp32_s=info["t_solve_fp32_s"])
            print(f"[northstar] solve cached -> {args.solve_cache}",
                  flush=True)
    print(f"[northstar] fp32 solve {info['t_solve_fp32_s']:.1f}s "
          f"lam[0]={lam32[0]:.9g}", flush=True)

    # Double-word refinement (host-anchored fp64 master, chunked fp32-pair
    # device compute).  With --save-vectors, a run that finds the file
    # resumes from it: X64 is refined in place, and the in-span identity
    # S = X^T R + G diag(lam) is exact for WHATEVER lam the residual was
    # computed at, so a partially refined (lam, X64) pair is a valid start.
    if args.save_vectors and os.path.exists(args.save_vectors):
        print(f"[northstar] resuming refinement state from "
              f"{args.save_vectors}", flush=True)
        with np.load(args.save_vectors) as z:
            lam32 = np.asarray(z["lam"], np.float64)
            X64 = np.asarray(z["X64"], np.float64)
        info["refine_resumed_from_vectors"] = True
        del X32
    else:
        X64 = np.asarray(X32, np.float64)
        del X32
    if args.skip_refine:
        lam = lam32
        rel = np.full(kk, np.nan)
        info["t_refine_s"] = 0.0
    else:
        t0 = time.time()
        lam, X64, rel = refine_eigenpairs_dd_hosted(
            comp, lam32, X64,
            tol=args.tol,
            max_rounds=args.refine_rounds,
            cg_steps=args.cg_steps,
            col_chunk=args.col_chunk,
            k_report=args.k,
            verbose=True,
        )
        info["t_refine_s"] = time.time() - t0
        print(f"[northstar] dd refine {info['t_refine_s']:.1f}s "
              f"max rel {np.nanmax(rel):.2e}", flush=True)
    info["t_solve_s"] = info["t_solve_fp32_s"] + info["t_refine_s"]
    info["refine_rel_residual_max"] = float(np.nanmax(rel))
    if args.save_vectors:
        np.savez(args.save_vectors, lam=lam, X64=X64, idx_map=idx_map)

    # TRUE residuals in fp64 on the host matrix (oracle arithmetic),
    # reported for the FIRST k pairs (the buffer pairs guard the deflation
    # window and are dropped).  Column-chunked: a monolithic
    # ``L @ Xl_k - Xl_k * lam`` materializes two extra (p, k) fp64 blocks
    # (~20 GB at north-star scale) — the r4 run OOMed the host; chunks of
    # ``col_chunk`` columns bound the temporaries to ~1 GB.
    import scipy.sparse

    order = np.argsort(lam)[: args.k]
    lam_rep = lam[order] - shift

    rows = np.repeat(np.arange(p, dtype=np.int64), nbrs.shape[1])
    cols = nbrs.reshape(-1)
    m_valid = cols >= 0
    A = scipy.sparse.csr_matrix(
        (np.ones(m_valid.sum()), (rows[m_valid], cols[m_valid])), shape=(p, p)
    )
    del rows, cols, m_valid
    L = scipy.sparse.diags(deg) - A  # unshifted
    del A
    info["matrix_asymmetry"] = float(abs(L - L.T).max())
    rnorm = np.empty(args.k)
    xn = np.empty(args.k)
    for lo in range(0, args.k, args.col_chunk):
        hi = min(lo + args.col_chunk, args.k)
        Xc = X64[:, order[lo:hi]][idx_map, :]  # lattice-order columns
        Rc = L @ Xc - Xc * lam_rep[None, lo:hi]
        xn[lo:hi] = np.linalg.norm(Xc, axis=0)
        rnorm[lo:hi] = np.linalg.norm(Rc, axis=0)
        del Xc, Rc
    rnorm = rnorm / np.maximum(xn, 1e-300)
    true_res = rnorm / np.maximum(np.abs(lam_rep), 1.0)
    info["eigenvalues_head"] = [float(v) for v in lam_rep[:10]]
    info["true_residual_max"] = float(true_res.max())
    info["true_residual_median"] = float(np.median(true_res))
    info["pairs_below_1e-6"] = int((true_res < 1e-6).sum())
    info["pairs_below_1e-7"] = int((true_res < 1e-7).sum())
    info["pairs_below_1e-8"] = int((true_res < 1e-8).sum())
    # scipy-style normalization (relative to the operator norm, the tol
    # ARPACK itself uses): ||Lx - lam x|| / (||x|| ||L||).
    l_norm = float(abs(L).sum(axis=1).max())  # inf-norm bound
    res_opnorm = rnorm / l_norm
    info["operator_norm_bound"] = l_norm
    info["resid_over_opnorm_max"] = float(res_opnorm.max())
    info["resid_over_opnorm_median"] = float(np.median(res_opnorm))
    print(f"[northstar] true residuals (k={args.k}): max {true_res.max():.2e} "
          f"median {np.median(true_res):.2e} "
          f"(/||L||: {res_opnorm.max():.2e})", flush=True)

    if args.scipy_json and os.path.exists(args.scipy_json):
        with open(args.scipy_json) as f:
            sc = json.load(f)
        info["scipy_race"] = sc
        t_scipy = sc.get("scipy_eigsh_s")
        if t_scipy:
            info["scipy_eigsh_s"] = t_scipy
            info["speedup_vs_scipy"] = t_scipy / info["t_solve_s"]
        elif sc.get("started_unix"):
            lower = time.time() - sc["started_unix"]
            info["scipy_eigsh_s"] = None
            info["scipy_elapsed_lower_bound_s"] = lower
            info["speedup_vs_scipy"] = lower / info["t_solve_s"]
            info["speedup_note"] = (
                "lower bound (standalone scipy run still unfinished when "
                "recorded; ran CONCURRENTLY on the same 2-core host)"
            )
    elif not args.skip_scipy:
        import multiprocessing as mp

        def scipy_run(q):
            # Plain ARPACK SA (shift-invert would need an splu factorization
            # of a 3D-graph matrix — fill-in is prohibitive at this scale).
            t0 = time.time()
            vals = scipy.sparse.linalg.eigsh(
                L, k=args.k, which="SA", tol=args.tol
            )[0]
            q.put((time.time() - t0, np.sort(vals)[:10].tolist()))

        q = mp.Queue()
        proc = mp.Process(target=scipy_run, args=(q,))
        proc.start()
        proc.join(args.scipy_timeout)
        if proc.is_alive():
            proc.terminate()
            proc.join()
            info["scipy_eigsh_s"] = None
            info["scipy_note"] = (
                f"did not finish within {args.scipy_timeout:.0f}s"
            )
            info["speedup_vs_scipy"] = float(
                args.scipy_timeout / info["t_solve_s"]
            )
            info["speedup_note"] = "lower bound (scipy timed out)"
        else:
            t_scipy, head = q.get()
            info["scipy_eigsh_s"] = t_scipy
            info["scipy_eigenvalues_head"] = head
            info["speedup_vs_scipy"] = t_scipy / info["t_solve_s"]
        print(f"[northstar] scipy: {info.get('scipy_eigsh_s')}", flush=True)

    with open(args.out, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({k: info[k] for k in (
        "num_points", "nnz", "t_solve_s", "true_residual_max",
        "pairs_below_1e-8")}))
    return info


if __name__ == "__main__":
    main()
