"""Thick-restart Lanczos (Wu & Simon 2000) — memory-bounded eigensolving.

The reference (and our plain ``lanczos``) stores the full (n, M) Krylov
basis, so converging hard spectra means growing n until device memory runs
out (at N=160^3 each fp32 basis vector is 16 MB, so n=600 holds 9.8 GB).  Thick restart bounds the
basis at m vectors: after each cycle the best l Ritz vectors are locked into
the basis, the recurrence restarts from the cycle's residual, and the
projected matrix becomes arrowhead + tridiagonal:

    B = [[diag(theta_1..l), sigma],
         [sigma^T,          T_new]],     sigma_i = beta_m * y_i[m]

Each cycle is one jitted scan (static shapes); only the small (m x m)
projected eigenproblem runs per cycle on the host-visible side.  Residual
estimates are |beta_m * y_i[m]| — no extra SpMVs.

This is an extension beyond the reference (which has no restarting at all);
it is what BASELINE.md's k=100-eigenpair target actually requires.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import LinearOperator
from .lanczos import _PRECISION, _default_basis_dot, _default_dot, _resolve_dot
from .results import EigResult, acceptance_inner_prod

__all__ = ["eigsh_restarted"]


def _cycle_kernel(
    matvec: Callable,
    V: jax.Array,  # (m+1, M) basis storage; rows [0, l) = locked Ritz vecs
    u: jax.Array,  # (M,) normalized start vector (residual direction)
    sigma: jax.Array,  # (l,) arrowhead couplings (0 on first cycle)
    l: int,
    m: int,
    *,
    dot=_default_dot,
    basis_dot=_default_basis_dot,
    reorth_passes: int = 2,
):
    """Run steps l..m-1 of a thick-restart cycle.

    Returns (V, alpha (m-l,), beta (m-l-1,), u_next, beta_last).
    V rows [l, m) get the new Lanczos vectors; the projected matrix is
    [[diag(theta), sigma], [sigma^T, tridiag(alpha, beta)]].
    """
    dtype = u.dtype

    def norm(x):
        return jnp.sqrt(dot(x, x))

    def orth(V, v):
        for _ in range(reorth_passes):
            coeff = basis_dot(V, v)
            v = v - jnp.tensordot(coeff, V, axes=1, precision=_PRECISION)
        return v

    V = V.at[l].set(u)
    # First new step: w = A u - sum_i sigma_i y_i - alpha u.
    w = matvec(u)
    alpha0 = dot(u, w)
    w = w - alpha0 * u
    if l > 0:
        w = w - jnp.tensordot(sigma, V[:l], axes=1, precision=_PRECISION)
    w = orth(V, w)

    def step(carry, j):
        V, r = carry
        beta = norm(r)
        v = r * jnp.where(beta > 0, 1.0 / jnp.where(beta > 0, beta, 1.0), 0.0)
        v = orth(V, v)
        nv = norm(v)
        v = v * jnp.where(nv > 0, 1.0 / jnp.where(nv > 0, nv, 1.0), 0.0)
        V = jax.lax.dynamic_update_slice_in_dim(V, v[None], j, axis=0)
        w = matvec(v)
        alpha = dot(v, w)
        v_prev = jax.lax.dynamic_index_in_dim(V, j - 1, axis=0, keepdims=False)
        r = w - alpha * v - beta * v_prev
        r = orth(V, r)
        return (V, r), (alpha, beta)

    if m - l - 1 > 0:
        (V, r), (alphas, betas) = jax.lax.scan(
            step, (V, w), jnp.arange(l + 1, m, dtype=jnp.int32)
        )
        alpha = jnp.concatenate([alpha0[None], alphas])
    else:
        V, r = V, w
        alpha = alpha0[None]
        betas = jnp.zeros((0,), dtype)
    beta_last = norm(r)
    u_next = r * jnp.where(
        beta_last > 0, 1.0 / jnp.where(beta_last > 0, beta_last, 1.0), 0.0
    )
    return V, alpha, betas, u_next, beta_last


@partial(
    jax.jit,
    static_argnames=("l", "m", "reorth_passes", "compensated"),
    donate_argnums=(1,),
)
def _cycle_jit(op, V, u, sigma, l, m, reorth_passes, compensated=False):
    # V is donated: at north-star scale the basis is 9.2 GB, and the
    # caller always rebinds it to this function's result.
    return _cycle_kernel(
        op.matvec, V, u, sigma, l, m, reorth_passes=reorth_passes,
        dot=_resolve_dot(_default_dot, compensated),
    )


@jax.jit
def _rayleigh_ritz_refine(op, X):
    """Rayleigh–Ritz on the explicit subspace X (M, k): the op-aware correction.

    In fp32 the thick-restart *model* (arrowhead + tridiagonal) drifts away
    from the true operator as lock-time rounding accumulates across cycles:
    the model's residual estimate keeps shrinking (observed 1e-11) while the
    true residual ||A x - theta x|| stalls near 5e-4, and the model eigenvalue
    can be off by ~1e-4 (measured on the N=32 deuteron).  Projecting A onto
    the computed subspace and re-solving the small (k, k) problem removes the
    drift entirely: eigenvalues become Rayleigh quotients (accurate to
    eps * ||A||) and residuals are measured against A itself.

    Returns (S, G, W): the projected operator X^T A X, the Gram matrix X^T X,
    and W = A X (reused for the true residuals — no extra matvecs).
    """
    W = op.matmat(X)
    S = jnp.dot(X.T, W, precision=_PRECISION)
    G = jnp.dot(X.T, X, precision=_PRECISION)
    return S, G, W


def _refine_host(op, X):
    """Host-side finish of the Rayleigh–Ritz refinement in fp64.

    Returns (lam (k,), Xr (M, k), true_resid (k,), Wr (M, k) = A Xr), lam
    ascending, Xr columns normalized.
    """
    import scipy.linalg

    S, G, W = _rayleigh_ritz_refine(op, X)
    S64 = np.asarray(S, np.float64)
    G64 = np.asarray(G, np.float64)
    Ssym, Gsym = (S64 + S64.T) / 2, (G64 + G64.T) / 2
    try:
        lam, Z = scipy.linalg.eigh(Ssym, Gsym)
    except np.linalg.LinAlgError:
        # G not numerically positive definite (near-dependent locked vectors,
        # e.g. after breakdown or k near the numerical rank).  Degrade
        # gracefully: Cholesky-regularize G with a small diagonal shift
        # scaled to its trace; fall back to the unweighted projected problem
        # if even that fails.
        shift = 1e-6 * max(np.trace(Gsym) / max(len(Gsym), 1), 1e-30)
        try:
            lam, Z = scipy.linalg.eigh(Ssym, Gsym + shift * np.eye(len(Gsym)))
        except np.linalg.LinAlgError:
            lam, Z = scipy.linalg.eigh(Ssym)
    Zj = jnp.asarray(Z, X.dtype)
    Xr = jnp.dot(X, Zj, precision=_PRECISION)
    Wr = jnp.dot(W, Zj, precision=_PRECISION)
    R = Wr - Xr * jnp.asarray(lam, X.dtype)[None, :]
    nrm = jnp.sqrt(jnp.sum(Xr * Xr, axis=0))
    inv = jnp.where(nrm > 0, 1.0 / jnp.where(nrm > 0, nrm, 1.0), 0.0)
    resid = jnp.sqrt(jnp.sum(R * R, axis=0)) * inv
    return lam, Xr * inv[None, :], np.asarray(resid, np.float64), Wr * inv[None, :]


@partial(jax.jit, static_argnames=("l", "chunked"), donate_argnums=(0,))
def _ritz_update(V, evecs, l, chunked=True):
    """Lock the first l Ritz vectors into rows [0, l) of V.

    Rows >= l are ZEROED: the next cycle's full-basis orthogonalization runs
    against every row of V, and stale vectors from the finished cycle would
    wrongly deflate directions that are no longer in the basis.

    Memory: V is donated AND the rotation runs in COLUMN chunks updated in
    place — a whole-basis ``y = E^T V`` intermediate plus old and new V
    peaks at ~3 bases (21 GB at north-star scale, an on-chip OOM).  Each
    chunk reads its own columns of the carry before overwriting them, so
    XLA keeps a single basis buffer live.  Normalization happens on the
    COEFFICIENT side: V's rows are orthonormal to ~eps, so ||y_i|| equals
    ||evecs_i|| to the same accuracy (the per-cycle CGS2 reorthogonalization
    is the drift guard, not this scaling).

    ``chunked=False`` rotates in one piece: for a row-sharded basis each
    device holds only its share, and column chunks that do not line up with
    the shards would make XLA gather the whole basis onto every device.
    """
    m1 = V.shape[0]
    vs = V.shape[1:]
    mflat = int(np.prod(vs))
    e = evecs[:, :l]
    e = e / jnp.sqrt(jnp.sum(e * e, axis=0, keepdims=True))
    et = e.T  # (l, m)
    v2 = V.reshape(m1, mflat)
    nchunk = max(1, min(16, mflat // (1 << 20) or 1)) if chunked else 1
    bounds = [(mflat * i) // nchunk for i in range(nchunk + 1)]
    zrows = m1 - l
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == b:
            continue
        y_c = jnp.dot(et, jax.lax.slice(v2, (0, a), (m1 - 1, b)),
                      precision=_PRECISION)
        blk = jnp.concatenate([y_c, jnp.zeros((zrows, b - a), V.dtype)], axis=0)
        v2 = jax.lax.dynamic_update_slice(v2, blk, (0, a))
    return v2.reshape(m1, *vs)


def eigsh_restarted(
    op: LinearOperator,
    k: int = 10,
    *,
    max_basis: int = 0,
    n_locked: int = 0,
    tol: float = 1e-6,
    max_cycles: int = 100,
    which: str = "SA",
    seed: int = 99,
    v0: Optional[jax.Array] = None,
    dtype=None,
    reorth_passes: int = 2,
    compensated: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    rr_verify: bool = True,
) -> EigResult:
    """Thick-restart Lanczos for the k extremal eigenpairs.

    max_basis: basis bound m (default 2k + 30, min k + 10).
    n_locked:  Ritz vectors carried across restarts (default k + 10).
    tol:       relative residual |beta_m y_i[m]| / |theta_i| threshold.
    which:     "SA" (smallest algebraic) or "LA".
    compensated: run alpha/beta/norm reductions through the error-free-
               transform dot (ops.compensated) — removes the fp32 reduction
               floor on large M at negligible cost (the reductions are
               bandwidth-bound).
    checkpoint_path: if given, the run checkpoints at cycle boundaries (every
               ``checkpoint_every`` cycles) and resumes from the file when it
               exists.  Cycle state is only the locked block + restart vector
               ((l+1, M) — NOT the full (m+1, M) basis), the natural unit for
               k=100-class runs.
    rr_verify: run the op-aware Rayleigh-Ritz verification/refinement loop
               on convergence (default).  Disable at north-star scale, where
               the verification's (M, k) X and W blocks would sit beside
               the basis and the caller follows with the double-word
               refinement (solver.refine) anyway — the result then carries
               the locked Ritz block with ESTIMATED residuals and NaN
               acceptance.
    """
    if which not in ("SA", "LA"):
        raise ValueError("which must be SA or LA")
    mdim = op.shape[0]
    if dtype is None:
        dtype = op.dtype
    dtype = jnp.dtype(dtype)
    m = max_basis or max(2 * k + 30, k + 10)
    m = min(m, mdim)
    l_keep = min(n_locked or (k + min(10, m - k - 1)), m - 2)
    if l_keep < k:
        # On max_cycles exhaustion the locked block is all the caller gets
        # back: theta would hold only l_keep < k entries and V[l_keep:k]
        # zeros — fail fast instead (ADVICE r3).
        raise ValueError(
            f"n_locked={l_keep} < k={k}: the locked window must cover the "
            f"requested pairs (raise n_locked or max_basis; m={m})"
        )

    if v0 is None:
        v0 = jax.random.uniform(
            jax.random.PRNGKey(seed), (mdim,), dtype=dtype, minval=-1, maxval=1
        )
    sigma = jnp.zeros((0,), dtype)
    theta = np.zeros(0)
    l = 0
    history = []
    refined = None  # best (lam, Xr, true_resid) seen so far
    best_rel = np.inf
    cycle0 = 0

    # Checkpoint resume is resolved BEFORE the random start vector so a
    # resumed run never touches v0.  The locked block is merged into the
    # device basis in DONATED ~256 MB row chunks: an eager
    # ``V.at[:l].set(locked)`` compiles to a program holding both the old
    # and the updated basis copy (2 x 9.2 GB at north-star scale, m=176,
    # M=13.1M fp32).  Donation keeps the device peak at one basis + one
    # chunk; a traced start index keeps it at one compile.
    V_locked = None
    if checkpoint_path is not None:
        import os

        from ..utils.checkpoint import load_restart_state, save_restart_state

        if os.path.exists(checkpoint_path):
            V_locked, u_np, theta, sigma_np, cycle0 = load_restart_state(
                checkpoint_path
            )
            l = V_locked.shape[0]
            u = jnp.asarray(u_np, dtype=dtype).reshape(mdim)
            sigma = jnp.asarray(sigma_np, dtype)
            theta = np.asarray(theta, np.float64)

    if V_locked is None:
        u = (v0 / jnp.linalg.norm(v0)).astype(dtype).reshape(mdim)

    # Row-sharded operators (ops.composite.ShardedCompositeOperator,
    # parallel.composite2.ShardedCompositeV2, parallel.distributed.
    # ShardedStencilOperator — anything exposing mesh + axis_name): the
    # matvec runs through its own shard_map; the dense basis algebra here
    # partitions automatically under GSPMD once V/u carry the row sharding.
    # The basis is created sharded, so no device ever holds all of it.
    op_mesh = getattr(op, "mesh", None)
    basis_sharding = None
    if op_mesh is not None and getattr(op, "axis_name", None) is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        basis_sharding = NamedSharding(
            op_mesh, PartitionSpec(None, op.axis_name)
        )
    V = jnp.zeros((m + 1, mdim), dtype=dtype, device=basis_sharding)
    if V_locked is not None:
        import functools

        @functools.partial(jax.jit, donate_argnums=0)
        def _set_rows(V, rows, start):
            flat = V.reshape(m + 1, -1)
            flat = jax.lax.dynamic_update_slice(
                flat, rows.reshape(rows.shape[0], -1),
                (start, jnp.zeros((), start.dtype)),
            )
            return flat.reshape(V.shape)

        row_bytes = mdim * np.dtype(dtype).itemsize
        chunk = min(l, max(1, (1 << 28) // row_bytes))
        Vl = np.asarray(V_locked, np.dtype(dtype)).reshape(l, mdim)
        del V_locked
        for s in range(0, l, chunk):
            if s + chunk > l:
                s = l - chunk  # full-width window; overlap rewrites are
                # idempotent and keep the jitted shape (= one compile)
            V = _set_rows(V, jnp.asarray(Vl[s : s + chunk]), jnp.int32(s))
        del Vl
        V_locked = True  # sentinel: resumed

    if basis_sharding is not None:
        # Ghost/dead slots (box padding, dead region slots) must stay
        # exactly zero in the start vector.
        host = getattr(op, "host", None)
        if host is not None and cycle0 == 0:
            u = u * jnp.asarray(host.live_mask(), dtype=dtype)
            u = u / jnp.linalg.norm(u)
        u = jax.device_put(
            u, NamedSharding(op_mesh, PartitionSpec(op.axis_name))
        )

    for cycle in range(cycle0, max_cycles):
        V, alpha, beta, u, beta_last = _cycle_jit(
            op, V, u, jnp.asarray(sigma, dtype), l, m, reorth_passes,
            compensated,
        )
        # Projected matrix: arrowhead(theta, sigma) + tridiag(alpha, beta).
        B = np.zeros((m, m))
        if l:
            B[np.arange(l), np.arange(l)] = theta
            B[np.arange(l), l] = np.asarray(sigma)
            B[l, np.arange(l)] = np.asarray(sigma)
        a = np.asarray(alpha)
        b = np.asarray(beta)
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            # Surface numerical blow-up immediately with actionable context
            # instead of silently locking NaN Ritz pairs for the remaining
            # cycles (SURVEY §5.2: the reference has no NaN detection).
            raise FloatingPointError(
                f"non-finite recurrence coefficients in restart cycle "
                f"{cycle} (alpha finite: {np.isfinite(a).all()}, beta "
                f"finite: {np.isfinite(b).all()}); typical causes: operator "
                f"overflow in {dtype}, an unmasked dead-slot start vector, "
                f"or missing Precision.HIGHEST in a custom matvec"
            )
        idx = np.arange(l, m)
        B[idx, idx] = a
        if len(b):
            B[idx[:-1], idx[:-1] + 1] = b
            B[idx[:-1] + 1, idx[:-1]] = b
        w_all, y_all = np.linalg.eigh(B)
        order = np.argsort(w_all) if which == "SA" else np.argsort(-w_all)
        w_all, y_all = w_all[order], y_all[:, order]

        bl = float(np.asarray(beta_last))
        resid = np.abs(bl * y_all[m - 1, :])
        scale = np.maximum(np.abs(w_all), 1e-30)
        rel = resid / scale
        history.append(float(rel[:k].max()))
        if verbose:
            print(
                f"cycle {cycle}: theta[0]={w_all[0]:.8g} "
                f"max-rel-resid(k)={history[-1]:.2e}"
            )
        converged = bool((rel[:k] < tol).all())

        l_new = l_keep if not converged else max(k, l_keep)
        V = _ritz_update(V, jnp.asarray(y_all, dtype), l_new,
                         chunked=basis_sharding is None)
        theta = w_all[:l_new]
        sigma = bl * y_all[m - 1, :l_new]
        l = l_new
        if checkpoint_path is not None and (cycle + 1) % checkpoint_every == 0:
            save_restart_state(
                checkpoint_path, V[:l], u, theta, sigma, cycle + 1
            )
        if not converged:
            continue
        if not rr_verify:
            break

        # The cheap estimate says converged — verify against the operator
        # itself.  In fp32 the arrowhead model drifts from A as lock-time
        # rounding accumulates: the model residual keeps shrinking while the
        # TRUE residual ||A x - theta x|| stalls, and the model eigenvalue
        # can be off by ~1e-4 (measured, N=32 deuteron).  Rayleigh-Ritz
        # refinement on the locked block removes the drift.
        lam, Xr, tres, Wr = _refine_host(op, V[:k].reshape(k, mdim).T)
        order = np.argsort(lam) if which == "SA" else np.argsort(-lam)
        oj = jnp.asarray(order)
        lam, tres = lam[order], tres[order]
        Xr, Wr = Xr[:, oj], Wr[:, oj]
        trel = tres / np.maximum(np.abs(lam), 1e-30)
        worst = float(trel.max())
        if verbose:
            print(f"  refine: lam[0]={lam[0]:.10g} max-true-rel-resid={worst:.2e}")
        improved = worst < best_rel / 1.3
        if refined is None or worst < best_rel:
            refined, best_rel = (lam, Xr, tres), worst
        if (trel < tol).all() or not improved:
            # Converged against A itself, or hit the precision floor of the
            # working dtype (further cycles measured not to help).
            break
        # Not truly converged: anchor the locked block to the refined
        # eigenpairs (better vectors AND an honest model) and keep cycling.
        V = V.at[:k].set(Xr.T)
        theta = np.concatenate([lam, theta[k:]])
        sigma_k = np.asarray(
            jnp.dot(Wr.T, u, precision=_PRECISION), np.float64
        )  # sigma_i = x_i^T A u = (A x_i)^T u for the refreshed locked rows
        sigma = np.concatenate([sigma_k, np.asarray(sigma, np.float64)[k:]])

    if not rr_verify:
        # Locked Ritz block as-is: eigenvalues theta[:k] with the cheap
        # |beta_m y[m]| residual ESTIMATES; acceptance left NaN (no extra
        # (M, k) blocks are materialized).
        vals = jnp.asarray(theta[:k])
        # Transpose on the HOST, a few rows at a time: an on-device (M, k)
        # transpose next to the (m, M) basis would double the device peak.
        # Small transfers also give progress visibility.
        vecs = np.empty((mdim, k), dtype=np.dtype(V.dtype))
        itemsize = np.dtype(V.dtype).itemsize
        row_chunk = max(1, min(k, (1 << 28) // (mdim * itemsize)))  # ~256 MB
        Vk = V[:k].reshape(k, mdim)
        for lo_r in range(0, k, row_chunk):
            hi_r = min(lo_r + row_chunk, k)
            vecs[:, lo_r:hi_r] = np.asarray(Vk[lo_r:hi_r]).T
            if verbose:
                print(f"  readback {hi_r}/{k} rows", flush=True)
        est = np.abs(theta[:k]) * np.asarray(history[-1] if history else np.nan)
        return EigResult(
            eigenvalues=vals,
            eigenvectors=vecs,
            residuals=jnp.asarray(np.broadcast_to(est, (k,)).copy()),
            inner_prod=jnp.full((k,), jnp.nan, dtype=dtype),
            residuals_are_estimates=True,
        )
    if refined is None:
        lam, Xr, tres, _ = _refine_host(op, V[:k].reshape(k, mdim).T)
        order = np.argsort(lam) if which == "SA" else np.argsort(-lam)
        lam, tres = lam[order], tres[order]
        Xr = Xr[:, jnp.asarray(order)]
        refined = (lam, Xr, tres)
    lam, Xr, tres = refined
    vals = jnp.asarray(lam)
    vecs = jnp.asarray(Xr, dtype=dtype)
    inner = acceptance_inner_prod(op, vecs)
    return EigResult(
        eigenvalues=vals,
        eigenvectors=vecs,
        residuals=jnp.asarray(tres),
        inner_prod=inner,
    )
