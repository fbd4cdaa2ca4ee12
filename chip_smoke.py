"""Smoke test of lanczos_tpu on one NVIDIA GPU, at the reference's own sizes.

    python chip_smoke.py               one card: phases 0-4
    python chip_smoke.py --four-cards  the row-sharded solvers over four cards,
                                       each against the same solve on one card

Everything runs in this one process (the CLI is called in-process): a JAX
process reserves most of the card's memory, so a second one would fail.

0. Device.  A GPU is required.  Prints JAX's device, the JAX version and the
   card's name and power limit as nvidia-smi reports them.
1. Regular flagship, 3D deuteron on N=160^3 with the 27-point stencil in fp32
   (reference 3Ddeuteron.py:63-65): ``solve-regular -N 160 --stencil 27
   --restart -k 8``.  Reference: the true residual of every returned pair,
   in fp64 on the host CSR of the same operator.  At N=64 the eigenvalues
   are also compared with scipy's eigsh.
2. Irregular flagship (Irr3Ddeuteron.py:13-16): ``solve-irregular -N 120
   --box-depth 3``, Krylov-Schur on the raw non-symmetric operator.
   Reference: true fp64 residuals against the fp64 host CSR of the same
   lattice, and the CompositeV2 format's matvec and rmatvec against that CSR.
3. The north-star pipeline (scripts/northstar.py) at reduced size: fp32
   thick-restart solve, then double-word refinement; every reported pair
   must reach a true fp64 residual of at most 1e-8.
4. Kernel decisions: the stencil SpMV formulations and the CompositeV2
   matvec, timed on the card, each beside the formulation it was chosen over.

Each phase prints its error against its reference with the tolerance and the
precision, and its set-up time (build, assembly, first compilation) apart
from its solve time.  A failed check exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason.
#
# fp32 solves: the backward error eta = ||A x - lam x|| / (||A||_1 ||x||) of a
# pair computed in fp32 sits a small multiple of eps32 = 1.19e-7 above zero
# (the Rayleigh-Ritz verification stops cycling at the fp32 floor).
TOL_BACKWARD_FP32 = 1e-5
# Double-word refinement: BASELINE's north-star target, true fp64 residual
# relative to max(|lam|, 1).
TOL_REFINED = 1e-8
# One fp32 SpMV against the fp64 product of the same stored coefficients:
# 27 fp32 products and sums per row, relative to max |y|.
TOL_SPMV_FP32 = 1e-5
# Compiled double-word residual against fp64: exact transforms give ~1e-13;
# an FMA-contracting compiler gives fp32-level errors (~1e-9 on the CPU).
TOL_DD = 1e-11

# Problem sizes: the reference's own (regular N=160, irregular N=120), the
# north-star pipeline cut to a few minutes, and the four-card comparisons.
SIZES = {
    "regular": 160, "regular_scipy": 64, "irregular": 120, "k": 8,
    "refine_n_fine": 96, "refine_k": 6,
    "four_regular": 160, "four_graph_n_fine": 144,
}


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseFailed(what)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Phase 0


def keep_cpu_backend():
    """Potential sampling runs on JAX's CPU backend (models/lattice.py), so a
    JAX_PLATFORMS that names only the GPU gets the CPU added."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def require_gpu():
    """Phase 0: JAX's first device must be a GPU; returns the device info."""
    import jax

    from lanczos_tpu.utils.device import card_name_and_power_limit
    from lanczos_tpu.utils.device import require_gpu as _require_gpu

    info = _require_gpu("chip_smoke")
    log("phase 0", f"device {info['kind']} x{info['count']}, "
        f"jax {jax.__version__}")
    log("phase 0", f"nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    return info


# ---------------------------------------------------------------------------
# Shared helpers


class CompileClock:
    """Sums JAX's own compile-duration events (trace, lowering, backend
    compile) while active, to split a solve's wall time into first
    compilation and steady work."""

    def __init__(self):
        self.seconds = 0.0

    def _listener(self, event, duration, **kwargs):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._listener)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._listener)


def host_x64():
    """fp64 arrays on the host CPU device, for references."""
    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


def stencil_csr64(op):
    """fp64 scipy CSR of a StencilOperator's stored coefficients, each
    promoted exactly (the diagonal joins the centre tap in fp64)."""
    import dataclasses

    import jax.numpy as jnp
    import scipy.sparse

    from lanczos_tpu.ops.assemble import stencil_to_ell

    with host_x64():
        op64 = dataclasses.replace(
            op,
            weights=jnp.asarray(np.asarray(op.weights, np.float64)),
            diag=jnp.asarray(np.asarray(op.diag, np.float64)),
        )
        ell = stencil_to_ell(op64)
        cols, vals = np.array(ell.cols), np.array(ell.vals)
    m, k = cols.shape
    # Every row holds the same k taps: CSR straight from the ELL arrays.
    return scipy.sparse.csr_matrix(
        (vals.reshape(-1), cols.reshape(-1), np.arange(m + 1) * k),
        shape=(m, m),
    )


def true_residuals(A, lam, X):
    """Per column: relative residual ||Ax - lam x|| / (|lam| ||x||) and
    backward error ||Ax - lam x|| / (||A||_1 ||x||), in fp64."""
    X = np.asarray(X, np.float64)
    lam = np.asarray(lam, np.float64)
    R = A @ X - X * lam[None, :]
    r = np.linalg.norm(R, axis=0) / np.linalg.norm(X, axis=0)
    norm1 = float(np.bincount(A.indices, np.abs(A.data), A.shape[1]).max())
    return r, r / np.maximum(np.abs(lam), 1e-300), r / norm1


def load_script(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_smoke_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Phase 1


def phase_regular(n: int, k: int, compare_scipy: bool):
    """CLI regular solve at N^3; returns (Solve, fp64 host CSR)."""
    from lanczos_tpu import cli

    tag = f"phase 1 N={n}"
    with CompileClock() as cc:
        s = cli.main(["solve-regular", "-N", str(n), "--stencil", "27",
                      "--restart", "-k", str(k)])
    t0 = time.perf_counter()
    A = stencil_csr64(s.operator)
    lam = np.asarray(s.result.eigenvalues, np.float64)
    r, rel, eta = true_residuals(A, lam, np.asarray(s.result.eigenvectors))
    t_ref = time.perf_counter() - t0
    log(tag, f"set-up {s.build_s + cc.seconds:.2f} s (build {s.build_s:.2f} s "
        f"+ first compile {cc.seconds:.2f} s), solve "
        f"{s.solve_s - cc.seconds:.2f} s, reference {t_ref:.2f} s "
        f"(host CSR, {A.nnz} nnz)")
    log(tag, f"lowest eigenvalue {lam[0]:.8f}; true fp64 residual of {k} "
        f"fp32 pairs: max relative {rel.max():.3e}, max backward error "
        f"{eta.max():.3e} (tol {TOL_BACKWARD_FP32:g}; fp32 solve, fp64 check)")
    check(np.isfinite(lam).all() and lam.shape == (k,), f"{tag}: eigenvalues")
    check(eta.max() <= TOL_BACKWARD_FP32, f"{tag}: backward error {eta.max()}")
    if compare_scipy:
        import scipy.sparse.linalg

        t0 = time.perf_counter()
        mu = np.sort(scipy.sparse.linalg.eigsh(A, k=k, which="SA")[0])
        # For a symmetric A each computed pair has an eigenvalue within its
        # residual norm ||A x - lam x|| (x normalized).
        err = np.abs(np.sort(lam) - mu)
        bound = r[np.argsort(lam)]
        log(tag, f"scipy eigsh (fp64, {time.perf_counter() - t0:.1f} s): "
            f"max |lam - lam_scipy| {err.max():.3e}, each within its "
            f"residual bound (max bound {bound.max():.3e})")
        check((err <= bound).all(), f"{tag}: eigenvalues vs scipy {err}")
    return s, A


# ---------------------------------------------------------------------------
# Phase 2


def phase_irregular(n: int, k: int):
    """CLI irregular solve; returns (Solve, fp64 CSR, CompositeV2, its
    compiled matvec)."""
    import jax
    import jax.numpy as jnp

    import lanczos_tpu as lt
    from lanczos_tpu import cli

    tag = f"phase 2 N={n}"
    with CompileClock() as cc:
        s = cli.main(["solve-irregular", "-N", str(n), "--box-depth", "3",
                      "-k", str(k)])
    t0 = time.perf_counter()
    with host_x64():
        A = lt.assemble_irregular_hamiltonian(
            s.lattice, lt.deuteron_potential_3d, symmetrize=None,
            dtype=np.float64,
        ).to_scipy()
    lam = np.asarray(s.result.eigenvalues, np.float64)
    r, rel, eta = true_residuals(A, lam, s.result.eigenvectors)
    t_ref = time.perf_counter() - t0
    log(tag, f"P={s.lattice.num_points}; set-up {s.build_s + cc.seconds:.2f} s "
        f"(lattice + composite assembly {s.build_s:.2f} s + first compile "
        f"{cc.seconds:.2f} s), solve {s.solve_s - cc.seconds:.2f} s, "
        f"reference {t_ref:.2f} s")
    log(tag, f"lowest eigenvalue {lam.min():.8f}; true fp64 residual of {k} "
        f"fp32 pairs: max relative {rel.max():.3e}, max backward error "
        f"{eta.max():.3e} (tol {TOL_BACKWARD_FP32:g}; fp32 solve, fp64 check)")
    check(np.isfinite(lam).all() and lam.shape == (k,), f"{tag}: eigenvalues")
    check(eta.max() <= TOL_BACKWARD_FP32, f"{tag}: backward error {eta.max()}")

    t0 = time.perf_counter()
    comp, idx_map = lt.assemble_irregular_hamiltonian_composite2(
        s.lattice, lt.deuteron_potential_3d, dtype=np.float32,
        build_transpose=True,
    )
    jax.block_until_ready(comp)
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x = rng.standard_normal(s.lattice.num_points)
    v = np.zeros(comp.shape[0], np.float32)
    v[idx_map] = x
    v = jnp.asarray(v)
    compiled = {}
    for name, ref in (("matvec", A @ x), ("rmatvec", A.T @ x)):
        t0 = time.perf_counter()
        fn = jax.jit(lambda o, u, _n=name: getattr(o, _n)(u))
        compiled[name] = fn.lower(comp, v).compile()
        t_compile = time.perf_counter() - t0
        y = np.asarray(compiled[name](comp, v), np.float64)[idx_map]
        err = np.abs(y - ref).max() / np.abs(ref).max()
        log(tag, f"CompositeV2 {name} vs fp64 CSR: max error {err:.3e} "
            f"relative to max |y| (tol {TOL_SPMV_FP32:g}; fp32 operator); "
            f"compile {t_compile:.2f} s")
        check(err <= TOL_SPMV_FP32, f"{tag}: CompositeV2 {name} error {err}")
    log(tag, f"CompositeV2 + transpose assembly {t_build:.2f} s "
        f"(M={comp.shape[0]}, {len(comp.grid_meta)} interface classes)")
    return s, A, comp, compiled["matvec"]


# ---------------------------------------------------------------------------
# Phase 3


def phase_refine(n_fine: int, k: int, out_dir: str):
    """North-star pipeline at reduced size; returns its info dict."""
    tag = f"phase 3 n_fine={n_fine} k={k}"
    ns = load_script("northstar")
    with CompileClock() as cc:
        info = ns.main([
            "--n-fine", str(n_fine), "--k", str(k), "--skip-scipy",
            "--out", os.path.join(out_dir, f"northstar_{n_fine}.json"),
        ])
    setup = (info["t_neighbors_s"] + info["t_reciprocity_s"]
             + info["t_build_composite_s"])
    log(tag, f"P={info['num_points']} nnz={info['nnz']}; set-up "
        f"{setup + cc.seconds:.2f} s (graph + composite {setup:.2f} s + "
        f"compile {cc.seconds:.2f} s), fp32 solve {info['t_solve_fp32_s']:.2f} "
        f"s, dd refinement {info['t_refine_s']:.2f} s (compile included in "
        f"both)")
    log(tag, f"true fp64 residual of the {k} reported pairs: max "
        f"{info['true_residual_max']:.3e}, {info['pairs_below_1e-8']}/{k} "
        f"below 1e-8 (tol {TOL_REFINED:g}; fp32 solve + double-word "
        f"refinement, fp64 check)")
    check(info["true_residual_max"] <= TOL_REFINED,
          f"{tag}: true residual {info['true_residual_max']}")
    return info


def dd_compile_probe(n: int = 12, k: int = 3):
    """The refinement's double-word residual R = A X - X lam, run eagerly
    and jitted, against fp64 on near-exact eigenpairs (true residual
    ~1e-14).  A compiler that contracts a*b + c into an FMA breaks the
    error-free transforms, which shows as an fp32-level error under jit.
    Returns max |R_dd - R_64| / (|lam| ||x||) per mode."""
    import jax
    import jax.numpy as jnp

    import lanczos_tpu as lt
    from lanczos_tpu.ops.dd import matvec_dd
    from lanczos_tpu.solver.refine import _dd_residual, _split_vec

    H = lt.build_regular_hamiltonian(
        n, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    A = stencil_csr64(H)
    lam, X = np.linalg.eigh(A.toarray())
    lam, X = lam[:k], X[:, :k]
    R64 = A @ X - X * lam[None, :]
    Xh = X.astype(np.float32)
    Xl = (X - Xh).astype(np.float32)
    lh, ll = _split_vec(lam)
    args = (H, jnp.asarray(Xh), jnp.asarray(Xl), lh, ll)

    def residual_eager(op, Xh, Xl, lh, ll):
        cols = [matvec_dd(op, Xh[:, j], Xl[:, j]) for j in range(Xh.shape[1])]
        Yh = jnp.stack([c[0] for c in cols], axis=1)
        Yl = jnp.stack([c[1] for c in cols], axis=1)
        Y = np.asarray(Yh, np.float64) + np.asarray(Yl, np.float64)
        return Y - (np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)) * lam

    errs = {}
    R = residual_eager(*args)
    errs["eager"] = float((np.abs(R - R64).max(axis=0) / np.abs(lam)).max())
    Rh, Rl, *_ = jax.jit(_dd_residual.__wrapped__)(*args)
    R = np.asarray(Rh, np.float64) + np.asarray(Rl, np.float64)
    errs["jit"] = float((np.abs(R - R64).max(axis=0) / np.abs(lam)).max())
    return errs


# ---------------------------------------------------------------------------
# Phase 4


def stencil_candidates(op):
    """The three plain-JAX formulations of the 27-point graded stencil SpMV
    (y = S x + diag x) that were timed against each other."""
    import jax
    import jax.numpy as jnp

    gs = op.grid_shape
    w0, w1, w2, w3 = op.graded
    d = op.diag.reshape(gs)

    def roll27(x):
        xg = x.reshape(gs)
        y = d * xg
        for k, off in enumerate(op.offsets):
            y = y + op.weights[k] * jnp.roll(xg, tuple(-o for o in off),
                                             (0, 1, 2))
        return y.reshape(-1)

    def circulant(x):
        xg = x.reshape(gs)
        hi = jax.lax.Precision.HIGHEST

        def ring(n):
            i = jnp.arange(n)
            m = jnp.zeros((n, n), xg.dtype)
            return m.at[i, (i + 1) % n].add(1.0).at[i, (i - 1) % n].add(1.0)

        sz, sy, sx = ring(gs[0]), ring(gs[1]), ring(gs[2])
        c1 = jnp.einsum("Zz,zyx->Zyx", sz, xg, precision=hi)
        g01 = jnp.einsum("Yy,zyx->zYx", sy, xg, precision=hi)
        g11 = jnp.einsum("Yy,zyx->zYx", sy, c1, precision=hi)
        mid = g01 + c1
        a = w0 * xg + w1 * mid + w2 * g11
        b = w1 * xg + w2 * mid + w3 * g11
        y = a + jnp.einsum("Xx,zyx->zyX", sx, b, precision=hi)
        return (y + d * xg).reshape(-1)

    def graded_rolls(x):
        xg = x.reshape(gs)

        def s(a, axis):
            return jnp.roll(a, 1, axis) + jnp.roll(a, -1, axis)

        sy = s(xg, 1)
        szx = s(xg, 0)
        szsy = s(sy, 0)
        c = w1 * xg + w2 * sy + w2 * szx + w3 * szsy
        y = w0 * xg + w1 * sy + w1 * szx + w2 * szsy + s(c, 2)
        return (y + d * xg).reshape(-1)

    return {"roll27": roll27, "circulant": circulant,
            "graded_rolls": graded_rolls}


def count_hlo_kernels(compiled_text: str) -> int:
    """Instructions of the optimized ENTRY computation that launch work
    (fusions, custom calls, copies, ...), i.e. kernels per call."""
    import re

    skip = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast"}
    n, inside = 0, False
    for line in compiled_text.splitlines():
        if line.startswith("ENTRY"):
            inside = True
            continue
        if inside:
            if line.startswith("}"):
                break
            if "=" not in line:
                continue
            op = re.search(r"(?:^|\s)([a-z][a-z0-9\-]*)\(",
                           line.split("=", 1)[1])
            if op and op.group(1) not in skip:
                n += 1
    return n


def spmv_decision(op, A, candidates, iters=200):
    """Time each SpMV formulation and check it against the fp64 CSR."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu.utils.metrics import time_loop

    m = op.shape[0]
    w = np.asarray(op.weights, np.float64)
    scale = 1.0 / (np.abs(w).sum() + float(jnp.max(jnp.abs(op.diag))))
    x64 = np.random.default_rng(1).uniform(-1, 1, m)
    x = jnp.asarray(x64, jnp.float32)
    y64 = A @ x64.astype(np.float32).astype(np.float64)
    rows = {}
    for name, f in candidates.items():
        y = np.asarray(jax.jit(f)(x), np.float64)
        err = float(np.abs(y - y64).max() / np.abs(y64).max())
        check(err <= TOL_SPMV_FP32, f"SpMV {name}: error {err}")
        t = time_loop(lambda u: f(u) * scale, x, iters, 7)["median_s"]
        rows[name] = (t, err)
    return rows


def time_compiled(fn, args, iters: int = 100, repeats: int = 5) -> float:
    """Median seconds per call of an already compiled function, from
    ``iters`` back-to-back launches per repeat."""
    fn(*args).block_until_ready()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(*args)
        y.block_until_ready()
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def phase_kernels(op, A, comp, comp_matvec, tag="phase 4"):
    """Print both numbers of each kernel decision."""
    import jax.numpy as jnp

    from lanczos_tpu.utils.metrics import time_loop

    m = op.shape[0]
    floor = 12 * m / 3.35e12
    rows = spmv_decision(op, A, stencil_candidates(op))
    for name, (t, err) in sorted(rows.items(), key=lambda kv: kv[1][0]):
        log(tag, f"stencil SpMV N^3={m} {name}: {t * 1e6:.2f} us/SpMV, "
            f"{12 * m / t / 1e9:.1f} GB/s at 12 B/point ({t / floor:.2f}x the "
            f"{floor * 1e6:.1f} us bandwidth floor at 3.35 TB/s); error vs "
            f"fp64 CSR {err:.2e} (tol {TOL_SPMV_FP32:g}, fp32)")
    t_lib = time_loop(
        lambda u: op.matvec(u) * jnp.asarray(1e-4, u.dtype),
        jnp.ones(m, jnp.float32), 200, 7,
    )["median_s"]
    log(tag, f"decision: the package's StencilOperator.matvec (graded_rolls "
        f"for graded stencils) {t_lib * 1e6:.2f} us/SpMV")

    x = jnp.asarray(np.asarray(comp.live), jnp.float32)
    t_v2 = time_compiled(comp_matvec, (comp, x))
    nk = count_hlo_kernels(comp_matvec.as_text())
    log(tag, f"CompositeV2 matvec (XLA tap path) M={comp.shape[0]}: "
        f"{t_v2 * 1e6:.2f} us/matvec from back-to-back launches, {nk} "
        f"kernels per matvec in the compiled HLO, {len(comp.grid_meta)} "
        f"interface classes")


# ---------------------------------------------------------------------------
# Four cards


def graph_laplacian_v2(n_fine: int):
    """The north-star graph-Laplacian CompositeV2 (+1 shift) at ``n_fine``."""
    from lanczos_tpu.ops.composite2 import build_composite_v2

    ns = load_script("northstar")
    lat, nbrs, rels, weights, deg, _ = ns.build_graph_laplacian_rows(n_fine)
    return build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4096,  # scripts/northstar.py's default
    )


def peak_bytes(devices):
    out = []
    for d in devices:
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def agree(tag, lam_s, r_s, lam_1, r_1, n):
    """The lowest ``n`` eigenvalues of each run are matched by an eigenvalue
    of the other run within the sum of the two residual norms (each computed
    value is within its own residual of an eigenvalue of the same symmetric
    operator).  Matching against the other run's whole list, not by
    position, lets a degenerate multiplet be reported with a different
    number of copies by two valid runs."""
    lam_s, lam_1 = np.asarray(lam_s, np.float64), np.asarray(lam_1, np.float64)
    r_s, r_1 = np.asarray(r_s, np.float64), np.asarray(r_1, np.float64)
    worst = 0.0
    for a, ra, b, rb in ((lam_s, r_s, lam_1, r_1), (lam_1, r_1, lam_s, r_s)):
        for i in range(n):
            d = np.abs(b - a[i])
            j = int(np.argmin(d))
            worst = max(worst, d[j] / (ra[i] + rb[j]))
    log(tag, f"lowest {n} eigenvalues sharded vs one card: max |diff| / "
        f"(sum of residual norms) {worst:.3e} (tol 1); lowest "
        f"{lam_s[0]:.8f} vs {lam_1[0]:.8f}")
    check(worst <= 1.0, f"{tag}: sharded != one card ({worst})")


def four_cards(n_reg: int, n_graph: int, k: int, devices: int = 4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import lanczos_tpu as lt
    from lanczos_tpu.parallel import make_row_mesh, shard_operator

    mesh = make_row_mesh(devices)
    row = NamedSharding(mesh, PartitionSpec("rows"))
    devs = list(mesh.devices.flat)

    tag = f"four cards N={n_reg}"
    H = lt.build_regular_hamiltonian(
        n_reg, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    m = H.shape[0]
    v0 = jax.random.uniform(jax.random.PRNGKey(7), (m,), jnp.float32, -1, 1)
    Hs = shard_operator(H, mesh)
    t0 = time.perf_counter()
    res_s = lt.eigsh_restarted(Hs, k=k, v0=jax.device_put(v0, row))
    jax.block_until_ready(res_s.eigenvalues)
    t_s = time.perf_counter() - t0
    peaks = peak_bytes(devs)
    basis = (2 * k + 31) * m * 4
    log(tag, f"sharded solve {t_s:.2f} s over {devices} devices (compile "
        f"included); peak bytes in use per device {peaks}; one fp32 basis "
        f"(m+1={2 * k + 31} rows) is {basis} bytes")
    t0 = time.perf_counter()
    res_1 = lt.eigsh_restarted(H, k=k, v0=v0)
    jax.block_until_ready(res_1.eigenvalues)
    log(tag, f"one-card solve {time.perf_counter() - t0:.2f} s on "
        f"{devs[0]}; its peak bytes in use {peak_bytes(devs[:1])[0]}")
    agree(tag, res_s.eigenvalues, res_s.residuals,
          res_1.eigenvalues, res_1.residuals, k)
    if all(p is not None for p in peaks):
        check(max(peaks) < basis, f"{tag}: a device holds a whole basis")

    # The graph Laplacian's spectrum holds degenerate multiplets; two valid
    # runs may return different members of the cluster at the edge of the
    # wanted window, so two buffer pairs are solved beyond the k compared.
    tag = f"four cards graph Laplacian n_fine={n_graph}"
    kb = k + 2
    comp, idx_map = graph_laplacian_v2(n_graph)
    comp_s = shard_operator(comp, mesh)
    v = np.zeros(comp.shape[0], np.float32)
    v[idx_map] = np.random.default_rng(0).uniform(-1, 1, len(idx_map))
    t0 = time.perf_counter()
    res_s = lt.eigsh_restarted(
        comp_s, k=kb,
        v0=jax.device_put(jnp.asarray(comp_s.host.to_sharded(v)), row),
    )
    jax.block_until_ready(res_s.eigenvalues)
    log(tag, f"M={comp.shape[0]}: sharded solve {time.perf_counter() - t0:.2f}"
        f" s; peak bytes in use per device {peak_bytes(devs)}")
    t0 = time.perf_counter()
    res_1 = lt.eigsh_restarted(comp, k=kb, v0=jnp.asarray(v))
    jax.block_until_ready(res_1.eigenvalues)
    log(tag, f"one-card solve {time.perf_counter() - t0:.2f} s")
    agree(tag, res_s.eigenvalues, res_s.residuals,
          res_1.eigenvalues, res_1.residuals, k)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded comparisons on four cards")
    args = ap.parse_args(argv)

    keep_cpu_backend()
    device = require_gpu()
    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    log("phase 0", f"compile cache {enable_compile_cache()}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_all = time.perf_counter()
    k = SIZES["k"]
    if args.four_cards:
        check(device["count"] >= 4, f"--four-cards needs 4 GPUs, "
              f"found {device['count']}")
        four_cards(SIZES["four_regular"], SIZES["four_graph_n_fine"], k)
    else:
        phase_regular(SIZES["regular_scipy"], k, compare_scipy=True)
        s_reg, A_reg = phase_regular(SIZES["regular"], k, compare_scipy=False)
        _, _, comp, comp_matvec = phase_irregular(SIZES["irregular"], k)
        errs = dd_compile_probe()
        log("phase 3", f"double-word residual vs fp64 on near-exact pairs: "
            f"eager {errs['eager']:.2e}, jitted {errs['jit']:.2e} (tol "
            f"{TOL_DD:g}; the refinement runs jitted on the GPU)")
        check(errs["jit"] <= TOL_DD, f"phase 3: jitted dd error {errs['jit']}")
        phase_refine(SIZES["refine_n_fine"], SIZES["refine_k"], out_dir)
        phase_kernels(s_reg.operator, A_reg, comp, comp_matvec)
    log("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
