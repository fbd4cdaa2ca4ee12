"""CPU tests of what the GPU port relies on.

* Every dot_general in the fp32 recurrences runs at Precision.HIGHEST: on
  the GPU a default fp32 product may run in TF32, which keeps about three
  decimal digits and destroys Krylov orthogonality.
* The persistent compilation cache goes where JAX_COMPILATION_CACHE_DIR
  says, and otherwise to one fixed directory in the checkout.
* The measurement entry points refuse to run without a GPU.
* The CLI's --platform accepts gpu and rejects tpu.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import lanczos_tpu as lt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                out.extend(_dot_precisions(sub))
    return out


def _stencil_op(n=6):
    return lt.build_regular_hamiltonian(
        n, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )


def _lanczos_step(op, v0):
    from lanczos_tpu.solver.lanczos import lanczos_kernel

    return lanczos_kernel(op.matvec, v0, 6)


def _restart_cycle(op, v0):
    from lanczos_tpu.solver.restart import _cycle_kernel

    m = 8
    V = jnp.zeros((m + 1, v0.shape[0]), v0.dtype)
    sigma = jnp.ones((3,), v0.dtype)
    return _cycle_kernel(op.matvec, V, v0, sigma, 3, m)


def _arnoldi_step(op, v0):
    from lanczos_tpu.solver.arnoldi import arnoldi_kernel

    return arnoldi_kernel(op.matvec, v0, 6)


def _two_sided_step(op, v0):
    from lanczos_tpu.solver.two_sided import two_sided_lanczos_kernel

    return two_sided_lanczos_kernel(op.matvec, op.rmatvec, v0, v0, 6)


@pytest.mark.parametrize(
    "step", [_lanczos_step, _restart_cycle, _arnoldi_step, _two_sided_step],
    ids=["lanczos_kernel", "restart_orth", "arnoldi", "two_sided"],
)
def test_fp32_recurrence_dots_are_highest(step):
    op = _stencil_op()
    v0 = jax.random.uniform(jax.random.PRNGKey(0), (op.shape[0],), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    jaxpr = jax.make_jaxpr(lambda v: step(op, v))(v0)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "no dot_general traced"
    for p in precs:
        assert p in ((HIGHEST, HIGHEST), HIGHEST), p


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path, restore_cache_dir):
    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    from lanczos_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase0_refuses_cpu():
    smoke = _chip_smoke()
    with pytest.raises(SystemExit, match="no GPU found"):
        smoke.require_gpu()


def test_chip_smoke_main_refuses_cpu_and_prints_no_result(capsys):
    smoke = _chip_smoke()
    with pytest.raises(SystemExit):
        smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    from lanczos_tpu.utils.bench_impl import main

    with pytest.raises(SystemExit, match="no GPU found"):
        main()
    assert capsys.readouterr().out == ""


def test_chip_smoke_stencil_candidates_match_csr():
    """The formulations phase 4 times agree with the fp64 host CSR."""
    smoke = _chip_smoke()
    op = _stencil_op(8)
    A = smoke.stencil_csr64(op)
    x = np.random.default_rng(0).uniform(-1, 1, op.shape[0])
    y64 = A @ x.astype(np.float32).astype(np.float64)
    for name, f in smoke.stencil_candidates(op).items():
        y = np.asarray(f(jnp.asarray(x, jnp.float32)), np.float64)
        err = np.abs(y - y64).max() / np.abs(y64).max()
        assert err < smoke.TOL_SPMV_FP32, (name, err)


def test_chip_smoke_true_residuals_of_exact_pairs():
    smoke = _chip_smoke()
    A = smoke.stencil_csr64(_stencil_op(6))
    lam, X = np.linalg.eigh(A.toarray())
    r, rel, eta = smoke.true_residuals(A, lam[:3], X[:, :3])
    assert r.max() < 1e-9 and eta.max() < 1e-13


def test_chip_smoke_counts_hlo_kernels():
    smoke = _chip_smoke()
    text = jax.jit(lambda x: (jnp.sin(x) @ x, x * 2)).lower(
        jnp.ones((4, 4))
    ).compile().as_text()
    assert smoke.count_hlo_kernels(text) >= 2


@pytest.mark.parametrize("platform", ["auto", "cpu", "gpu"])
def test_cli_platform_choices(platform):
    from lanczos_tpu.cli import build_parser

    args = build_parser().parse_args(
        ["solve-regular", "-N", "8", "--platform", platform]
    )
    assert args.platform == platform


def test_cli_platform_tpu_rejected(capsys):
    from lanczos_tpu.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["solve-regular", "--platform", "tpu"])
    assert "invalid choice: 'tpu'" in capsys.readouterr().err


def test_cli_solve_returns_lattice_order_vectors():
    """In-process CLI callers get eigenvectors in lattice point order."""
    from lanczos_tpu.cli import main

    s = main(["solve-irregular", "-N", "24", "-k", "2", "-n", "30",
              "--platform", "cpu"])
    assert s.result.eigenvectors.shape == (s.lattice.num_points, 2)
    assert s.build_s > 0 and s.solve_s > 0
