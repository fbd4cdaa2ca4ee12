"""Command-line interface.

The reference's only CLI is MatrixWrite.py (argparse, flags -d -L -N -p,
MatrixWrite.py:66-76); its solves are driver scripts with hard-coded
constants (3Ddeuteron.py:63-71).  This CLI covers both as subcommands:

  python -m lanczos_tpu.cli solve-regular   -N 64 -L 25 -n 150 -k 8
  python -m lanczos_tpu.cli solve-irregular -N 60 -L 25 --box-depth 3 -n 250 -k 5
  python -m lanczos_tpu.cli export-matrix   -d 3 -L 25 -N 30 -p Deuteron
  python -m lanczos_tpu.cli bench
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

# --platform gpu names the CUDA backend and keeps the CPU backend beside it:
# potential sampling pins itself to the CPU (models/lattice.py).  The alias
# "gpu" would also ask for ROCm, and an explicitly listed platform that fails
# to start is an error.
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda,cpu"}


@dataclasses.dataclass
class Solve:
    """What a solve subcommand returns to an in-process caller.

    ``result.eigenvectors`` are in the input's point order (grid raster
    order, or lattice point order for the irregular solvers), whatever
    layout the operator used internally."""

    result: Any
    operator: Any
    lattice: Optional[Any]
    build_s: float  # grid / lattice construction and operator assembly
    solve_s: float  # eigensolver wall time, first compilation included


def _configure_platform(args):
    """Select the backend.  ``auto`` keeps JAX's default device for every
    dtype (the GPU when one is present: the card runs fp64 natively)."""
    import jax

    if args.platform != "auto":
        jax.config.update("jax_platforms", _PLATFORMS[args.platform])
        if args.platform == "gpu" and jax.devices()[0].platform != "gpu":
            raise SystemExit("--platform gpu: JAX found no GPU")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    return jax


def _add_common(p):
    p.add_argument("-L", type=float, default=25.0, help="box length [fm]")
    p.add_argument("-n", type=int, default=150, help="Krylov iterations")
    p.add_argument("-k", type=int, default=8, help="eigenpairs to report")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"]
    )
    p.add_argument(
        "--platform", default="auto", choices=["auto", "cpu", "gpu"],
        help="auto = JAX's default device (the GPU when present)",
    )
    p.add_argument("--out", default=None, help="prefix for .npy eigenpair dump")


def cmd_solve_regular(args):
    jax = _configure_platform(args)
    import numpy as np

    import lanczos_tpu as lt

    t0 = time.perf_counter()
    h = lt.build_regular_hamiltonian(
        args.N, args.L, lt.deuteron_potential_3d,
        stencil=args.stencil, dtype=args.dtype,
    )
    jax.block_until_ready(h)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.restart:
        res = lt.eigsh_restarted(
            h, k=args.k, max_basis=args.max_basis, tol=args.tol,
            seed=args.seed, dtype=args.dtype,
        )
    elif args.block_size > 1:
        res = lt.eigsh_block_restarted(
            h, k=args.k, block_size=args.block_size, tol=args.tol,
            seed=args.seed, dtype=args.dtype,
        )
    else:
        res = lt.eigsh(
            h, k=args.k, n=args.n, which="SA", seed=args.seed,
            reorth=args.reorth, dtype=args.dtype,
        )
    jax.block_until_ready((res.eigenvalues, res.eigenvectors))
    t_solve = time.perf_counter() - t0
    print(f"# regular {args.N}^3 grid, {args.stencil}-pt stencil, "
          f"build {t_build:.1f}s, solve {t_solve:.1f}s on "
          f"{jax.devices()[0].device_kind}")
    print(res.summary(print_nr=args.k))
    if args.out:
        from lanczos_tpu.utils.io import save_eigpairs

        save_eigpairs(args.out, res.eigenvalues, res.eigenvectors)
        print(f"# saved {args.out}_eigvals.npy / _eigvecs.npy")
    return Solve(res, h, None, t_build, t_solve)


def cmd_solve_irregular(args):
    jax = _configure_platform(args)
    import numpy as np

    import lanczos_tpu as lt

    t0 = time.perf_counter()
    lat = lt.build_lattice(
        args.N, args.L, args.box_depth,
        potential=lt.deuteron_potential_3d,
        overwrite_spacing=args.overwrite_spacing,
    )
    print(f"# lattice: {lat.num_points} points "
          f"(fine grid {args.N}^3 = {args.N**3}), spacings "
          f"{sorted(set(lat.spacings.tolist()))}")
    on_cpu = jax.default_backend() == "cpu"
    to_lattice = None  # operator slot order -> lattice point order
    if args.symmetrize != "none":
        h = lt.assemble_irregular_hamiltonian(
            lat, lt.deuteron_potential_3d, symmetrize=args.symmetrize,
            dtype=args.dtype,
        )
    elif on_cpu:
        h = lt.assemble_irregular_hamiltonian(
            lat, lt.deuteron_potential_3d, symmetrize=None, dtype=args.dtype,
        )
    elif args.solver == "krylov-schur":
        # On an accelerator the composite operator (stencil-speed SpMV);
        # its vectors live in level-major order.
        from lanczos_tpu.models.irr_hamiltonian import (
            assemble_irregular_hamiltonian_composite,
        )

        h, perm = assemble_irregular_hamiltonian_composite(
            lat, lt.deuteron_potential_3d, dtype=args.dtype
        )

        def to_lattice(vecs):
            back = np.empty_like(vecs)
            back[perm] = vecs
            return back
    else:
        # Two-sided on an accelerator: both directions on the v2 composite
        # format, with H^T materialized at assembly.
        from lanczos_tpu.models.irr_hamiltonian import (
            assemble_irregular_hamiltonian_composite2,
        )

        h, idx_map = assemble_irregular_hamiltonian_composite2(
            lat, lt.deuteron_potential_3d, dtype=args.dtype,
            build_transpose=True,
        )

        def to_lattice(vecs):
            return vecs[idx_map, :]
    jax.block_until_ready(h)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.symmetrize != "none":
        res = lt.eigsh(
            h, k=args.k, n=args.n, which="SA", seed=args.seed,
            dtype=args.dtype,
        )
        label = (f"symmetrize={args.symmetrize} (NOTE: symmetrized irregular "
                 "operators carry spurious interface modes; prefer "
                 "--symmetrize none)")
    elif args.solver == "krylov-schur":
        # The robust fp32 path (solver/arnoldi.py): Krylov-Schur on the raw
        # non-symmetric operator, verified against true residuals.
        res = lt.eigs_nonsym(
            h, k=args.k, max_basis=args.n, tol=args.tol,
            seed=args.seed, dtype=args.dtype,
            compensated=args.compensated, verbose=args.verbose,
        )
        label = f"Krylov-Schur (Arnoldi), basis {args.n}"
    else:
        # Two-sided biorthogonal path (reference IrrLanczos.py:77-187).
        fac = lt.two_sided_lanczos(
            h, args.n, seed=args.seed, op_transpose=h.transpose(),
            dtype=args.dtype, compensated=args.compensated,
        )
        res = lt.two_sided_eigs(fac, k=args.k, op=h, residual_tol=args.tol)
        drift = float(np.max(np.asarray(fac.biorth_drift)))
        label = (f"two-sided Lanczos, breakdown at "
                 f"{int(fac.breakdown_iter)}/{args.n}, max biorth drift "
                 f"{drift:.2e}")
    jax.block_until_ready((res.eigenvalues, res.eigenvectors))
    t_solve = time.perf_counter() - t0
    print(f"# {label}, build {t_build:.1f}s, solve {t_solve:.1f}s on "
          f"{jax.devices()[0].device_kind}")
    print(res.summary(print_nr=args.k))
    if to_lattice is not None:
        res = dataclasses.replace(
            res, eigenvectors=to_lattice(np.asarray(res.eigenvectors))
        )
    if args.out:
        from lanczos_tpu.utils.io import save_eigpairs

        save_eigpairs(args.out, res.eigenvalues, res.eigenvectors)
    return Solve(res, h, lat, t_build, t_solve)


def cmd_export_matrix(args):
    # MatrixWrite.py parity: -d -L -N -p, overwrite_spacing lattice,
    # T_factor doubled (MatrixWrite.py:30 — the *2 is the Laplacian
    # normalization our weights already carry, so NOT doubled here).
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import lanczos_tpu as lt
    from lanczos_tpu.utils.io import export_mathematica

    if args.p != "Deuteron":
        raise SystemExit(f"unsupported potential {args.p!r}")
    if args.d != 3:
        raise SystemExit("only 3 dimensions supported")
    lat = lt.build_lattice(
        args.N, args.L, 3, overwrite_spacing=True
    )
    h = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, dtype="float64"
    )
    out = args.out or f"matrix_d={args.d}_N={args.N}_L={args.L:g}_p={args.p}.dat"
    export_mathematica(
        out, h, ndim=args.d, length=args.L, potential_name=args.p
    )
    print(f"# wrote {out} ({lat.num_points} points)")


def cmd_bench(args):
    from lanczos_tpu.utils.bench_impl import main as bench_main

    bench_main()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="lanczos_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve-regular", help="3D deuteron on a regular grid")
    p.add_argument("-N", type=int, default=64, help="grid points per dim")
    p.add_argument("--stencil", default="27", choices=["7", "27"])
    p.add_argument("--reorth", default="full",
                   choices=["full", "selective", "periodic", "none"])
    p.add_argument("--restart", action="store_true",
                   help="memory-bounded thick-restart solver")
    p.add_argument("--max-basis", type=int, default=0,
                   help="restart basis bound (default 2k+30)")
    p.add_argument("--block-size", type=int, default=1,
                   help=">1: restarted BLOCK solver (degenerate multiplets)")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="restart/block convergence tolerance")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_regular)

    p = sub.add_parser("solve-irregular",
                       help="3D deuteron on a multi-resolution lattice")
    p.add_argument("-N", type=int, default=60, help="fine grid points per dim")
    p.add_argument("--box-depth", type=int, default=3)
    p.add_argument("--overwrite-spacing", action="store_true",
                   help="debug spacings: 2 everywhere, 1 in center box")
    p.add_argument("--symmetrize", default="none",
                   choices=["none", "average", "volume", "normal"])
    p.add_argument("--solver", default="krylov-schur",
                   choices=["krylov-schur", "two-sided"],
                   help="krylov-schur (robust, fp32-safe) or the "
                        "reference-parity two-sided biorthogonal Lanczos")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="true relative residual acceptance threshold")
    p.add_argument("--compensated", action="store_true",
                   help="error-free-transform scalar reductions")
    p.add_argument("--verbose", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_irregular)

    p = sub.add_parser("export-matrix",
                       help="export irregular H as Mathematica .dat "
                            "(MatrixWrite parity)")
    p.add_argument("-d", type=int, default=3)
    p.add_argument("-L", type=float, default=25.0)
    p.add_argument("-N", type=int, default=30)
    p.add_argument("-p", type=str, default="Deuteron")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_export_matrix)

    p = sub.add_parser("bench", help="flagship SpMV benchmark (JSON line)")
    p.set_defaults(fn=cmd_bench)

    return parser


def main(argv=None):
    """Run one subcommand; solve subcommands return their :class:`Solve`."""
    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
