"""Symmetric Lanczos recurrence as a single compiled XLA program.

Compiled redesign of the reference's eager Krylov loop
(/root/reference/Python/Regular/Lanczos.py:75-141):

* The whole n-step recurrence is one ``lax.scan`` under ``jit`` — no host
  round-trips between iterations (the reference crosses host<->GPU per step
  via CuPy and drives the loop from Python).
* Full reorthogonalization is expressed as two (n,M) matmuls per pass
  (classical Gram-Schmidt against the whole stored basis), the matmul
  form of the reference's batched reorthogonalization
  (Regular/Lanczos.py:233-251).  CGS is run twice ("CGS2") by default, which
  restores orthogonality to machine precision — unlike the reference's single
  pass.
* The basis V is stored row-major (n, M) exactly as the reference does "for
  cache reasons" (Lanczos.py:103) — this makes both reorth matmuls and the
  Ritz back-transform contiguous.
* Breakdown (beta ~ 0, i.e. an exact invariant subspace) is detected and
  recorded instead of dividing by ~0 like the reference's ``j=0 -> beta[-1]``
  quirk (Lanczos.py:111-113, documented in SURVEY.md §"quirks").

The recurrence is parameterized over ``dot``/``basis_dot`` callables so the
distributed row-sharded solver (lanczos_tpu.parallel) can inject psum-reduced
versions and reuse this exact kernel inside ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import LinearOperator

__all__ = [
    "LanczosFactorization",
    "lanczos",
    "lanczos_kernel",
    "lanczos_segment",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LanczosFactorization:
    """Result of an n-step Lanczos run: A V.T ≈ V.T T + r e_n.T.

    alpha: (n,) diagonal of the tridiagonal T.
    beta:  (n-1,) off-diagonal of T.
    V:     (n, M) Krylov basis, rows are the Lanczos vectors.
    resid: (M,) final residual vector (unnormalized candidate v_n).
    breakdown_iter: iteration index where beta underflowed (n if none did).
    """

    alpha: jax.Array
    beta: jax.Array
    V: jax.Array
    resid: jax.Array
    breakdown_iter: jax.Array

    @property
    def n(self) -> int:
        return self.alpha.shape[0]

    @property
    def m(self) -> int:
        return self.V.shape[1]


# All reductions in the recurrence run at Precision.HIGHEST: on the GPU a
# default fp32 matmul may run in TF32 (about three decimal digits), which
# destroys Krylov orthogonality.  HIGHEST keeps full fp32 at a small cost on
# these bandwidth-bound matvec-like products.
_PRECISION = jax.lax.Precision.HIGHEST


def _default_dot(a, b):
    # Vectors may carry any shape; contract over every axis.  dot_general with multiple contracting dims — no
    # reshape, no layout conversion.
    return jnp.tensordot(
        a, b, axes=a.ndim, precision=_PRECISION,
        preferred_element_type=a.dtype,
    )


def _default_basis_dot(V, v):
    # (n, *vs) x (*vs,) -> (n,); zero rows of V contribute zeros.
    return jnp.tensordot(V, v, axes=v.ndim, precision=_PRECISION)


def _resolve_dot(dot, compensated):
    """Swap the default vector-vector dot for the error-free-transform one.

    Compensation targets the recurrence reductions (alpha, beta, norms) whose
    plain fp32 rounding puts a floor on achievable Ritz residuals; the reorth
    projections stay plain matmuls (CGS2 self-corrects, and eps-level
    orthogonality of fp32 *vectors* cannot be improved by better coefficients).
    """
    if compensated:
        if dot is _default_dot:
            from ..ops.compensated import dot2_rounded

            return dot2_rounded
        import warnings

        warnings.warn(
            "compensated=True has no effect when a custom dot is supplied "
            "(e.g. the sharded psum dot); compensation applies only to the "
            "default dot",
            stacklevel=3,
        )
    return dot


def _orthogonalize(V, v, basis_dot, passes: int):
    """Orthogonalize v against all (zero-padded) rows of V, CGS x passes."""
    for _ in range(passes):
        coeff = basis_dot(V, v)  # (n,)
        v = v - jnp.tensordot(coeff, V, axes=1, precision=_PRECISION)
    return v


def lanczos_segment(
    matvec: Callable,
    V: jax.Array,
    r: jax.Array,
    alpha_h: jax.Array,
    beta_h: jax.Array,
    breakdown_iter: jax.Array,
    j0: int,
    j1: int,
    *,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dot: Callable = _default_dot,
    basis_dot: Callable = _default_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
):
    """Run Lanczos steps j0..j1-1 from a warm state (the restartable core).

    ``V`` (n, M) holds rows [0, j0); ``r`` is the current unnormalized
    residual; ``alpha_h`` (n,) / ``beta_h`` (n-1,) are the histories filled
    up to j0.  Returns the advanced (V, r, alpha_h, beta_h, breakdown_iter).
    Both ``lanczos_kernel`` and the checkpointing driver
    (utils.checkpoint.lanczos_checkpointed) run THIS function, so the two
    paths cannot drift.
    """
    dot = _resolve_dot(dot, compensated)
    dtype = r.dtype
    if breakdown_tol is None:
        breakdown_tol = float(10 * np.finfo(np.dtype(dtype)).eps)

    def norm(x):
        return jnp.sqrt(dot(x, x))

    def reorth_step(V, v):
        v = _orthogonalize(V, v, basis_dot, reorth_passes)
        nrm = norm(v)
        return v * jnp.where(nrm > 0, 1.0 / nrm, 0.0)

    def step(carry, j):
        V, r, alpha_h, beta_h, breakdown_iter = carry
        beta = norm(r)
        # Scale-aware breakdown test: beta relative to typical basis scale (=1).
        ok = beta > breakdown_tol
        breakdown_iter = jnp.where(
            ok, breakdown_iter, jnp.minimum(breakdown_iter, j)
        )
        v = r * jnp.where(ok, 1.0 / jnp.where(ok, beta, 1.0), 0.0)

        if reorth == "full":
            v = reorth_step(V, v)
        elif reorth == "periodic":
            v = jax.lax.cond(
                (j % reorth_period) == 0,
                lambda args: reorth_step(*args),
                lambda args: args[1],
                (V, v),
            )

        V = jax.lax.dynamic_update_slice_in_dim(V, v[None], j, axis=0)
        v_prev = jax.lax.dynamic_index_in_dim(V, j - 1, axis=0, keepdims=False)
        w = matvec(v)
        alpha = dot(v, w)
        r = w - alpha * v - beta * v_prev
        alpha_h = alpha_h.at[j].set(alpha)
        beta_h = beta_h.at[j - 1].set(beta)
        return (V, r, alpha_h, beta_h, breakdown_iter), None

    (V, r, alpha_h, beta_h, breakdown_iter), _ = jax.lax.scan(
        step,
        (V, r, alpha_h, beta_h, breakdown_iter),
        jnp.arange(j0, j1, dtype=jnp.int32),
    )
    return V, r, alpha_h, beta_h, breakdown_iter


def lanczos_kernel(
    matvec: Callable,
    v0: jax.Array,
    n: int,
    *,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dot: Callable = _default_dot,
    basis_dot: Callable = _default_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
) -> LanczosFactorization:
    """Run n Lanczos steps from start vector v0 (need not be normalized).

    Pure function of jax arrays — safe to wrap in jit / shard_map.  ``n``,
    ``reorth`` and the callables must be static.  ``compensated=True`` runs
    every alpha/beta/norm reduction through the error-free-transform dot
    (ops.compensated) — correctly rounded regardless of M, recovering the
    fp64-reference accuracy the plain fp32 reductions lose.
    """
    dot = _resolve_dot(dot, compensated)
    if reorth == "selective":
        return _lanczos_selective_kernel(
            matvec,
            v0,
            n,
            reorth_passes=reorth_passes,
            dot=dot,
            basis_dot=basis_dot,
            breakdown_tol=breakdown_tol,
        )
    if reorth not in ("full", "none", "periodic"):
        raise ValueError(f"unknown reorth strategy: {reorth!r}")
    vshape = v0.shape
    m = int(np.prod(vshape))
    dtype = v0.dtype

    def norm(x):
        return jnp.sqrt(dot(x, x))

    v0 = v0 / norm(v0)
    V = jnp.zeros((n, *vshape), dtype=dtype).at[0].set(v0)
    w = matvec(v0)
    alpha0 = dot(v0, w)
    r = w - alpha0 * v0

    alpha_h = jnp.zeros(n, dtype=dtype).at[0].set(alpha0)
    beta_h = jnp.zeros(max(n - 1, 0), dtype=dtype)
    # ``dot`` is already compensation-resolved above — pass compensated=False.
    V, r, alpha_h, beta_h, breakdown_iter = lanczos_segment(
        matvec,
        V,
        r,
        alpha_h,
        beta_h,
        jnp.asarray(n, dtype=jnp.int32),
        1,
        n,
        reorth=reorth,
        reorth_passes=reorth_passes,
        reorth_period=reorth_period,
        dot=dot,
        basis_dot=basis_dot,
        breakdown_tol=breakdown_tol,
        compensated=False,
    )
    # Public factorization keeps the flat (n, M) layout regardless of the
    # internal carry shape (one relayout per solve, not per step).
    return LanczosFactorization(
        alpha=alpha_h, beta=beta_h, V=V.reshape(n, m), resid=r.reshape(m),
        breakdown_iter=breakdown_iter,
    )


def _lanczos_selective_kernel(
    matvec,
    v0,
    n,
    *,
    reorth_passes,
    dot,
    basis_dot,
    breakdown_tol,
):
    """Selective reorthogonalization via the omega recurrence (Simon 1984).

    Tracks running estimates omega[j, i] ~ |v_j . v_i| of orthogonality loss
    using only the alpha/beta history (O(n) work per step), and triggers a
    FULL reorthogonalization pass (lax.cond — the O(nM) matmuls execute only
    on triggering steps) whenever max_i omega exceeds sqrt(machine eps).
    After a trigger, omega resets to the machine-eps floor.

    This is the strategy SURVEY.md §7.5 calls for; the reference only has
    always-on full reorthogonalization (Regular/Lanczos.py:115).  Cost on
    well-behaved spectra: O(sqrt(n)) reorth passes instead of n.
    """
    vshape = v0.shape
    m = int(np.prod(vshape))
    dtype = v0.dtype
    eps = float(np.finfo(np.dtype(dtype)).eps)
    threshold = np.sqrt(eps)
    if breakdown_tol is None:
        breakdown_tol = 10 * eps

    def norm(x):
        return jnp.sqrt(dot(x, x))

    v0 = v0 / norm(v0)
    V = jnp.zeros((n, *vshape), dtype=dtype).at[0].set(v0)
    w = matvec(v0)
    alpha0 = dot(v0, w)
    r = w - alpha0 * v0

    alpha_h = jnp.zeros(n, dtype=dtype).at[0].set(alpha0)
    beta_h = jnp.zeros(n, dtype=dtype)  # beta_h[j] = beta_{j} (norm before v_j)
    # omega_prev = estimates for v_{j-1}, omega_curr for v_j (index i over n).
    omega_prev = jnp.zeros(n, dtype=dtype)
    omega_curr = jnp.zeros(n, dtype=dtype).at[0].set(1.0)

    def reorth_pass(V, v):
        v = _orthogonalize(V, v, basis_dot, reorth_passes)
        nrm = norm(v)
        return v * jnp.where(nrm > 0, 1.0 / nrm, 0.0)

    def step(carry, j):
        V, r, alpha_h, beta_h, omega_prev, omega_curr, breakdown_iter = carry
        beta = norm(r)
        ok = beta > breakdown_tol
        breakdown_iter = jnp.where(ok, breakdown_iter, jnp.minimum(breakdown_iter, j))
        v = r * jnp.where(ok, 1.0 / jnp.where(ok, beta, 1.0), 0.0)

        # omega update for the new vector v_j (Simon's recurrence):
        #   beta_j w_{j,i} = beta_{i} w_{j-1,i+1} + (alpha_i - alpha_{j-1})
        #       w_{j-1,i} + beta_{i-1} w_{j-1,i-1} - beta_{j-1} w_{j-2,i}
        idx = jnp.arange(n)
        alpha_jm1 = alpha_h[j - 1]
        beta_jm1 = beta_h[j - 1]
        w_ip1 = jnp.roll(omega_curr, -1)
        w_im1 = jnp.roll(omega_curr, 1)
        beta_im1 = jnp.roll(beta_h, 1)
        raw = (
            beta_h * w_ip1
            + (alpha_h - alpha_jm1) * omega_curr
            + beta_im1 * w_im1
            - beta_jm1 * omega_prev
        ) / jnp.where(ok, beta, 1.0)
        noise = eps * 2.0
        w_new = jnp.abs(raw) + noise
        w_new = jnp.where(idx < j, w_new, 0.0).at[j].set(1.0)
        w_new = w_new.at[j - 1].set(eps)

        drift = jnp.max(jnp.where(idx < j - 1, w_new, 0.0))
        trigger = drift > threshold

        v = jax.lax.cond(
            trigger, lambda args: reorth_pass(*args), lambda args: args[1], (V, v)
        )
        w_new = jnp.where(trigger, jnp.where(idx < j, noise, w_new), w_new)
        omega_curr2 = jnp.where(trigger, jnp.where(idx < j, noise, omega_curr), omega_curr)

        V = jax.lax.dynamic_update_slice_in_dim(V, v[None], j, axis=0)
        v_prev = jax.lax.dynamic_index_in_dim(V, j - 1, axis=0, keepdims=False)
        wv = matvec(v)
        alpha = dot(v, wv)
        r = wv - alpha * v - beta * v_prev

        alpha_h = alpha_h.at[j].set(alpha)
        beta_h = beta_h.at[j].set(beta)
        carry = (V, r, alpha_h, beta_h, omega_curr2, w_new, breakdown_iter)
        return carry, (alpha, beta, trigger)

    init = (
        V, r, alpha_h, beta_h, omega_prev, omega_curr,
        jnp.asarray(n, dtype=jnp.int32),
    )
    (V, r, alpha_h, beta_h, _, _, breakdown_iter), (alphas, betas, triggers) = (
        jax.lax.scan(step, init, jnp.arange(1, n, dtype=jnp.int32))
    )
    alpha = jnp.concatenate([alpha0[None], alphas])
    return LanczosFactorization(
        alpha=alpha, beta=betas, V=V.reshape(n, m), resid=r.reshape(m),
        breakdown_iter=breakdown_iter,
    )


@partial(
    jax.jit,
    static_argnames=(
        "n", "reorth", "reorth_passes", "reorth_period", "dtype", "compensated",
    ),
)
def _lanczos_jit(
    op, n, seed, v0, reorth, reorth_passes, reorth_period, dtype, compensated
):
    m = op.shape[0]
    if v0 is None:
        # Uniform(-1, 1) start vector, mirroring the reference's choice
        # (Regular/Lanczos.py:97) but with a JAX PRNG key instead of global state.
        v0 = jax.random.uniform(
            jax.random.PRNGKey(seed), (m,), dtype=dtype, minval=-1.0, maxval=1.0
        )
    else:
        v0 = v0.astype(dtype)
    return lanczos_kernel(
        op.matvec,
        v0,
        n,
        reorth=reorth,
        reorth_passes=reorth_passes,
        reorth_period=reorth_period,
        compensated=compensated,
    )


def lanczos(
    op: LinearOperator,
    n: int,
    *,
    seed: int = 99,
    v0: Optional[jax.Array] = None,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dtype=None,
    compensated: bool = False,
) -> LanczosFactorization:
    """High-level single-device entry point.

    Mirrors the contract of the reference's ``Lanczos.execute_Lanczos``
    (Regular/Lanczos.py:75: n, seed, v0) minus ``use_cuda`` — device placement
    is JAX's job, the same code runs on CPU and GPU.
    """
    m = op.shape[0]
    if n > m:
        raise ValueError(f"n={n} cannot exceed operator dimension M={m}")
    if dtype is None:
        dtype = op.dtype
    return _lanczos_jit(
        op, n, seed, v0, reorth, reorth_passes, reorth_period,
        jnp.dtype(dtype), compensated,
    )
