"""On-device tridiagonal eigensolve + Ritz extraction.

Replaces the reference's host-side LAPACK call ``np.linalg.eigh(H_eff)``
(/root/reference/Python/Regular/Lanczos.py:151) with a jitted on-device
eigensolve of the (n, n) tridiagonal matrix, and the per-column Python loop of
the Ritz back-transform (Lanczos.py:154-156) with one (M, n) x (n, k) matmul.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "tridiag_to_dense",
    "tridiag_eigh",
    "ritz_from_factorization",
    "cullum_willoughby_mask",
]


def tridiag_to_dense(alpha: jax.Array, beta: jax.Array) -> jax.Array:
    """Dense symmetric tridiagonal from diagonal alpha (n,) and off-diag beta (n-1,)."""
    return (
        jnp.diag(alpha)
        + jnp.diag(beta, 1)
        + jnp.diag(beta, -1)
    )


@jax.jit
def tridiag_eigh(alpha: jax.Array, beta: jax.Array):
    """Eigendecomposition of the symmetric tridiagonal T = tridiag(beta, alpha, beta).

    Returns (eigvals ascending, eigvecs columns).  Runs on-device via XLA's
    eigh of the dense (n, n) matrix — n is the Krylov depth (<= a few
    thousand), so the dense form is small regardless of problem size M.
    """
    return jnp.linalg.eigh(tridiag_to_dense(alpha, beta))


@jax.jit
def ritz_from_factorization(fac) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Ritz values/vectors and residual-norm estimates from a Lanczos run.

    Returns (theta, X, resid_est):
      theta     (n,)   Ritz values, ascending.
      X         (M, n) Ritz vectors, columns — X = V.T @ W, one matmul
                       (the reference loops over columns, Lanczos.py:154-156).
      resid_est (n,)   ||A x_i - theta_i x_i|| estimated as beta_n * |W[n-1, i]|
                       (the classical Lanczos residual bound — free, no extra
                       matvec; beta_n = ||resid|| of the factorization).
    """
    theta, W = tridiag_eigh(fac.alpha, fac.beta)
    # HIGHEST precision: a default fp32 matmul may run in TF32 (about three
    # decimal digits), which is not accurate enough for the back-transform.
    hi = jax.lax.Precision.HIGHEST
    X = jnp.dot(fac.V.T, W, precision=hi)  # (M, n)
    beta_n = jnp.sqrt(jnp.dot(fac.resid, fac.resid, precision=hi))
    resid_est = beta_n * jnp.abs(W[-1, :])
    return theta, X, resid_est


def cullum_willoughby_mask(
    alpha: np.ndarray,
    beta: np.ndarray,
    theta: np.ndarray,
    *,
    tol: Optional[float] = None,
) -> np.ndarray:
    """Ghost-eigenvalue (spurious Ritz value) detection, Cullum–Willoughby test.

    A Ritz value of T_n that is ALSO an eigenvalue of the submatrix T_hat
    (T_n with its first row/column deleted) and is simple, is an artifact of
    lost orthogonality ("ghost"), not an eigenvalue of A.  The reference has
    no such filter — it relies on full reorthogonalization plus a residual
    check (Regular/Lanczos.py:166-185).  This test is what makes cheaper
    reorthogonalization strategies (none/periodic/selective) usable.

    Host-side (numpy): runs once per solve on (n,)-sized data.

    Returns a boolean mask over ``theta`` — True = genuine, False = ghost.
    """
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    n = len(alpha)
    if n < 3:
        return np.ones_like(theta, dtype=bool)

    import scipy.linalg

    theta_hat = scipy.linalg.eigh_tridiagonal(
        alpha[1:], beta[1:], eigvals_only=True
    )
    scale = max(np.max(np.abs(theta)), 1.0)
    if tol is None:
        tol = 1e-8 * scale

    good = np.ones_like(theta, dtype=bool)
    # A Ritz value matching an eigenvalue of the deflated matrix is spurious
    # unless it is a (converged) multiple copy among the theta themselves.
    for i, t in enumerate(theta):
        near_hat = np.min(np.abs(theta_hat - t)) < tol
        if near_hat:
            multiplicity = np.sum(np.abs(theta - t) < tol)
            if multiplicity == 1:
                good[i] = False
    return good
