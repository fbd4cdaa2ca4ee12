"""Irregular flagship artifact: the reference's production irregular run
(Irr3Ddeuteron.py: N=120 fine grid, box_depth=3) on the default device,
through the composite operator + Krylov-Schur, with TRUE residuals recorded
to a JSON artifact.

Usage: python scripts/irregular_flagship.py [--n-fine 120] [--k 8]
       [--basis 300] [--out irregular_flagship.json]
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
    ap.add_argument("--n-fine", type=int, default=120)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--basis", type=int, default=300)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument(
        "--compensated", action=argparse.BooleanOptionalAction, default=True,
        help="compensated fp32 dots in the solver (--no-compensated to "
        "disable; the recorded JSON setting matches the flag)",
    )
    ap.add_argument("--out", default="irregular_flagship.json")
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (lets the artifact run while the GPU "
        "is held by another run; the device is recorded)",
    )
    args = ap.parse_args()

    import jax

    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    import lanczos_tpu as lt
    from lanczos_tpu.models.irr_hamiltonian import (
        assemble_irregular_hamiltonian_composite,
    )

    info = {
        "problem": "3D deuteron, multi-resolution lattice "
                   "(Irr3Ddeuteron.py parity at production size)",
        "n_fine": args.n_fine,
        "box_depth": args.box_depth,
        "k": args.k,
        "max_basis": args.basis,
        "dtype": "float32",
        "compensated": bool(args.compensated),
        "solver": "krylov-schur (composite operator)",
    }
    t0 = time.time()
    lat = lt.build_lattice(
        args.n_fine, 25.0, args.box_depth,
        potential=lt.deuteron_potential_3d,
    )
    info["num_points"] = int(lat.num_points)
    info["spacings"] = sorted(set(lat.spacings.tolist()))
    info["t_lattice_s"] = time.time() - t0
    print(f"[irr] lattice P={lat.num_points} spacings {info['spacings']} "
          f"({info['t_lattice_s']:.1f}s)", flush=True)

    t0 = time.time()
    op, perm = assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype="float32"
    )
    info["t_assemble_s"] = time.time() - t0
    dev = jax.devices()[0]
    info["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}
    print(f"[irr] composite built ({info['t_assemble_s']:.1f}s), "
          f"device={dev.device_kind}", flush=True)

    t0 = time.time()
    res = lt.eigs_nonsym(
        op, k=args.k, max_basis=args.basis, tol=args.tol,
        dtype="float32", compensated=args.compensated, verbose=True,
    )
    jax.block_until_ready(res.eigenvalues)
    info["t_solve_s"] = time.time() - t0
    vals = np.asarray(res.eigenvalues)
    resid = np.asarray(res.residuals)
    order = np.argsort(np.real(vals))
    info["eigenvalues_fp32"] = [float(np.real(v)) for v in vals[order]]
    info["fp32_rel_residuals"] = [float(r) for r in resid[order]]
    info["fp32_residual_max"] = float(resid.max())
    # Reference acceptance: <(Hx/||Hx||), x>^2 within 0.01 of 1
    # (Regular/Lanczos.py:166-185).
    ip = np.asarray(res.inner_prod)
    info["acceptance_inner_prod"] = [float(v) for v in ip[order]]
    info["all_accepted_ref_tol"] = bool((np.abs(ip - 1.0) < 0.01).all())
    print(f"[irr] solve {info['t_solve_s']:.1f}s; eigenvalues "
          f"{info['eigenvalues_fp32'][:4]} ...; fp32 resid max "
          f"{resid.max():.2e}", flush=True)

    # fp64 host refinement against the TRUE fp64 operator: the fp32 stall ~eps32*||A||/|lam| is the storage floor of both
    # the vectors AND the stored fp32 weights; at this size the honest cure
    # is plain fp64 on the host (the reference's native precision) —
    # oblique Rayleigh-Ritz + deflated BiCGStab (solver/refine.py).
    from lanczos_tpu.solver.refine import refine_eigenpairs_fp64_host

    t0 = time.time()
    H64 = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, symmetrize=None, dtype=np.float64
    )
    A64 = H64.to_scipy()
    info["t_assemble64_s"] = time.time() - t0
    # eigs_nonsym vectors are in the composite's level-major order: perm
    # maps lattice order -> operator order (v_op = v_lat[perm]).
    X_op = np.asarray(res.eigenvectors, np.float64)[:, order]
    X_lat = np.empty_like(X_op)
    X_lat[np.asarray(perm)] = X_op
    t0 = time.time()
    lam_r, X_r, rel_r = refine_eigenpairs_fp64_host(
        A64, np.real(vals[order]), X_lat,
        tol=1e-10, max_rounds=6, cg_steps=300, verbose=True,
    )
    info["t_refine_s"] = time.time() - t0
    info["eigenvalues"] = [float(v) for v in lam_r]
    info["true_rel_residuals"] = [float(r) for r in rel_r]
    info["residual_max"] = float(rel_r.max())
    info["residual_min"] = float(rel_r.min())
    print(f"[irr] fp64 refine {info['t_refine_s']:.1f}s; resid max "
          f"{rel_r.max():.2e}; eigenvalues {info['eigenvalues'][:4]} ...",
          flush=True)

    with open(args.out, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({k: info[k] for k in (
        "num_points", "t_solve_s", "residual_max", "all_accepted_ref_tol")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
