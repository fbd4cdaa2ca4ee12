"""The stencil SpMV the GPU runs (StencilOperator.matvec) vs two references.

References: a plain 27-tap roll loop over the operator's own offsets and
weights (written here, independent of the operator's dispatch), and the
scipy CSR of the same stencil (``stencil_to_ell``).  The GPU path for graded
{-1,0,1}^3 stencils is the 8-roll factorization; every other stencil takes
the per-offset roll loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lanczos_tpu as lt
from lanczos_tpu.ops.assemble import stencil_to_ell
from lanczos_tpu.ops.operators import make_stencil_operator


def _roll_reference(op, x):
    """y = sum_k w_k roll(x, -off_k) + diag x, one roll per tap."""
    xg = x.reshape(op.grid_shape)
    axes = tuple(range(len(op.grid_shape)))
    y = jnp.zeros_like(xg)
    for k, off in enumerate(op.offsets):
        y = y + op.weights[k] * jnp.roll(xg, tuple(-o for o in off), axes)
    y = y.reshape(-1)
    if op.diag is not None:
        y = y + op.diag * x
    return y


def _check(op, x, y, rtol=1e-5):
    """y against the roll reference and the fp64 scipy CSR product."""
    y = np.asarray(y, np.float64)
    y_roll = np.asarray(_roll_reference(op, x), np.float64)
    y_csr = stencil_to_ell(op).to_scipy() @ np.asarray(x, np.float64)
    scale = np.abs(y_csr).max()
    np.testing.assert_allclose(y, y_roll, atol=rtol * scale)
    np.testing.assert_allclose(y, y_csr, atol=rtol * scale)


@pytest.mark.parametrize("n,stencil", [(12, "27"), (10, "7"), (8, "27")])
def test_spmv_matches_xla(n, stencil):
    H = lt.build_regular_hamiltonian(
        n, 25.0, lt.deuteron_potential_3d, stencil=stencil, dtype="float32"
    )
    assert (H.graded is not None) == (stencil == "27")
    x = jax.random.normal(jax.random.PRNGKey(0), (H.shape[0],), jnp.float32)
    _check(H, x, jax.jit(H.matvec)(x))


def test_spmv_no_diag_anisotropic_grid():
    # Non-cubic grid, pure stencil (no diagonal), asymmetric weights.
    offs = [(0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1), (-1, 1, -1)]
    w = [2.0, -1.0, 0.5, 0.25, 1.5]
    op = make_stencil_operator((6, 10, 14), offs, w, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (op.shape[0],), jnp.float32)
    _check(op, x, op.matvec(x))


def test_spmm_matches_xla():
    H = lt.build_regular_hamiltonian(
        10, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    X = jax.random.normal(jax.random.PRNGKey(2), (H.shape[0], 3), jnp.float32)
    Y = H.matmat(X)
    for j in range(3):
        _check(H, X[:, j], Y[:, j])


def test_spmv_diag_mixed_offsets():
    """(8, 16, 8) grid with a diagonal and offsets mixing all three axes."""
    offs = [
        (0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
        (1, 0, 0), (-1, 0, 0), (1, 1, 1), (-1, -1, -1), (0, 1, -1),
    ]
    w = [1.0, 0.5, -0.5, 0.25, 2.0, -1.5, 3.0, 0.125, -0.25, 0.75]
    diag = np.linspace(-1.0, 1.0, 8 * 16 * 8).astype(np.float32)
    op = make_stencil_operator((8, 16, 8), offs, w, diag=diag, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(3), (op.shape[0],), jnp.float32)
    _check(op, x, op.matvec(x))


def test_spmv_graded_ladder():
    """N=16 27-pt deuteron: the graded 8-roll factorization."""
    H = lt.build_regular_hamiltonian(
        16, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    assert H.graded is not None
    x = jax.random.normal(jax.random.PRNGKey(4), (H.shape[0],), jnp.float32)
    _check(H, x, H.matvec(x))


def test_offsets_beyond_unit():
    """Offsets beyond +-1 (a 2-plane z shift) take the per-offset roll loop."""
    op = make_stencil_operator(
        (8, 8, 8), [(2, 0, 0), (0, 0, -3), (0, 0, 0)], [1.0, -0.5, 2.0],
        dtype=jnp.float32,
    )
    assert op.graded is None
    x = jax.random.normal(jax.random.PRNGKey(5), (512,), jnp.float32)
    _check(op, x, op.matvec(x))


def test_lanczos_spectrum_with_gpu_matvec():
    """End-to-end: Lanczos driven by the GPU SpMV matches the run driven by
    the roll reference."""
    H = lt.build_regular_hamiltonian(
        8, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    from lanczos_tpu.solver.lanczos import lanczos_kernel
    from lanczos_tpu.solver.tridiag import ritz_from_factorization

    m = H.shape[0]
    v0 = jax.random.uniform(jax.random.PRNGKey(7), (m,), jnp.float32, -1.0, 1.0)
    fac_p = lanczos_kernel(H.matvec, v0, 20)
    fac_x = lanczos_kernel(lambda v: _roll_reference(H, v), v0, 20)
    th_p, _, _ = ritz_from_factorization(fac_p)
    th_x, _, _ = ritz_from_factorization(fac_x)
    np.testing.assert_allclose(np.asarray(th_p), np.asarray(th_x), rtol=1e-3, atol=1e-3)
