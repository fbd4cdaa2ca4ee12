"""Arnoldi / Krylov-Schur (the robust non-symmetric engine) and the
op-aware two-sided filtering.

Oracles: dense host eig of the assembled matrix; fp64 runs as oracle for
fp32 (the flagship precision on the GPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from lanczos_tpu import ell_from_scipy
from lanczos_tpu.models.irr_hamiltonian import assemble_irregular_hamiltonian
from lanczos_tpu.models.lattice import build_lattice
from lanczos_tpu.models.potentials import deuteron_potential_3d
from lanczos_tpu.solver.arnoldi import arnoldi, eigs_nonsym
from lanczos_tpu.solver.two_sided import two_sided_eigs, two_sided_lanczos

from conftest import random_sparse_symmetric


def _random_nonsym(rng, m, eps=0.05):
    import scipy.sparse

    a = random_sparse_symmetric(rng, m)
    b = scipy.sparse.random(m, m, density=0.02, random_state=11)
    return (a + eps * b).tocsr()


@pytest.fixture(scope="module")
def irr_problem():
    lat = build_lattice(12, 25.0, 3, overwrite_spacing=True)
    h64 = assemble_irregular_hamiltonian(
        lat, deuteron_potential_3d, symmetrize=None, dtype=np.float64
    )
    dense = h64.to_scipy().toarray()
    exact = np.sort(np.linalg.eig(dense)[0].real)
    return lat, h64, dense, exact


def test_arnoldi_factorization_invariants(rng):
    """A V[:n].T = V[:n].T H[:n,:n] + H[n,n-1] v_n e_n^T, V orthonormal."""
    m, n = 300, 40
    a = _random_nonsym(rng, m)
    op = ell_from_scipy(a, dtype=np.float64)
    fac = arnoldi(op, n, dtype=np.float64)
    V = np.asarray(fac.V)
    H = np.asarray(fac.H)
    # orthonormal rows
    G = V @ V.T
    np.testing.assert_allclose(G, np.eye(n + 1), atol=1e-12)
    # Arnoldi relation
    AV = a @ V[:n].T
    rhs = V[:n].T @ H[:n, :n]
    rhs[:, n - 1] += H[n, n - 1] * V[n]
    np.testing.assert_allclose(AV, rhs, atol=1e-10)
    # Hessenberg structure: strictly-below-subdiagonal entries are zero
    for j in range(n):
        np.testing.assert_allclose(H[j + 2 :, j], 0.0, atol=1e-14)


def test_eigs_nonsym_matches_dense(rng):
    m = 400
    a = _random_nonsym(rng, m)
    op = ell_from_scipy(a, dtype=np.float64)
    res = eigs_nonsym(op, k=5, tol=1e-10, which="SR", dtype="float64")
    exact = np.sort(np.linalg.eig(a.toarray())[0].real)[:5]
    np.testing.assert_allclose(
        np.asarray(res.eigenvalues), exact, rtol=1e-8, atol=1e-8
    )
    assert float(np.max(np.asarray(res.residuals))) < 1e-9


def test_eigs_nonsym_irregular_fp64(irr_problem):
    _, h64, _, exact = irr_problem
    res = eigs_nonsym(h64, k=4, tol=1e-9, which="SR", dtype="float64")
    np.testing.assert_allclose(
        np.asarray(res.eigenvalues), exact[:4], rtol=1e-7, atol=1e-7
    )


@pytest.mark.parametrize("compensated", [False, True])
def test_eigs_nonsym_irregular_fp32(irr_problem, compensated):
    """The flagship configuration in miniature: fp32 Krylov-Schur on the
    non-symmetric irregular operator matches the fp64 oracle — the
    solve-level fp32(+compensated) test VERDICT r1 asked for."""
    lat, _, _, exact = irr_problem
    h32 = assemble_irregular_hamiltonian(
        lat, deuteron_potential_3d, symmetrize=None, dtype=np.float32
    )
    res = eigs_nonsym(
        h32, k=4, tol=1e-4, which="SR", dtype="float32",
        compensated=compensated,
    )
    np.testing.assert_allclose(
        np.asarray(res.eigenvalues), exact[:4], rtol=2e-4, atol=2e-4
    )
    assert float(np.max(np.asarray(res.residuals))) < 1e-3


def test_two_sided_filtered_result(irr_problem):
    """two_sided_eigs(op=...) returns residual-filtered EigResult: every
    reported pair verifies against the operator; ghosts are dropped."""
    _, h64, dense, exact = irr_problem
    fac = two_sided_lanczos(h64, 150, op_transpose=h64.transpose(), dtype=np.float64)
    res = two_sided_eigs(fac, k=4, op=h64, residual_tol=1e-5)
    vals = np.asarray(res.eigenvalues)
    resid = np.asarray(res.residuals)
    assert len(vals) >= 2  # the low pairs converge at n=150
    assert (resid < 1e-5).all()
    # every accepted value is a true eigenvalue of the dense matrix
    for v in vals:
        assert np.min(np.abs(exact - v)) < 1e-5 * max(1.0, abs(v))


def test_two_sided_telemetry(irr_problem):
    """Per-iteration health telemetry is recorded and reported (parity with
    the reference's in-loop diagnostics, IrrLanczos.py:147-160)."""
    _, h64, _, _ = irr_problem
    n = 60
    fac = two_sided_lanczos(h64, n, op_transpose=h64.transpose(), dtype=np.float64)
    drift = np.asarray(fac.biorth_drift)
    pn = np.asarray(fac.p_norm)
    assert drift.shape == (n,) and pn.shape == (n,)
    assert np.isfinite(drift).all() and np.isfinite(pn).all()
    # with full rebiorthogonalization the drift stays tiny in fp64
    assert drift[1:].max() < 1e-6
    report = fac.health_report()
    assert "biorth-drift" in report and report.count("\n") == n
    # unit right vectors under the new scaling
    qn = np.linalg.norm(np.asarray(fac.Q), axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-10)


def test_arnoldi_breakdown_benign():
    """Start vector inside an invariant subspace: breakdown is recorded and
    the Ritz values of the subspace are still exact."""
    d = np.diag(np.arange(1.0, 9.0))
    op = ell_from_scipy(__import__("scipy.sparse", fromlist=["csr_matrix"]).csr_matrix(d), dtype=np.float64)
    v0 = np.zeros(8)
    v0[:3] = [1.0, 1.0, 1.0]  # spans eigvecs 1..3
    fac = arnoldi(op, 6, v0=jnp.asarray(v0), dtype=np.float64)
    assert int(fac.breakdown_iter) <= 3
    # The breakdown step still writes its (final) column: the Rayleigh
    # quotient of the invariant subspace is the leading (j+1, j+1) block.
    j = int(fac.breakdown_iter) + 1
    H = np.asarray(fac.H)[:j, :j]
    vals = np.sort(np.linalg.eigvals(H).real)
    np.testing.assert_allclose(vals, [1.0, 2.0, 3.0], atol=1e-10)
