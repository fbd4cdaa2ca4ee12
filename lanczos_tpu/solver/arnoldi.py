"""Arnoldi + Krylov–Schur: the robust engine for the non-symmetric operator.

Why this exists.  The irregular lattice's LSQ Laplacian is non-symmetric
(models/irr_hamiltonian.py); the reference solves it with two-sided
biorthogonal Lanczos (/root/reference/Python/Irregular/IrrLanczos.py:77-187).
Two-sided Lanczos keeps TWO bases whose biorthogonality conditioning is
unbounded: measured on the N=60 deuteron lattice, the oblique condition
1/cos(angle(r, s)) has median ~2.5e3 and peaks at 1e8 over a 250-step run —
fp64 survives (losing ~4 of 16 digits), fp32 does not (7 digits total; the
recurrence collapses by iteration ~15 under scale-aware breakdown detection,
or silently overflows by ~100 under the reference's scaling).  Arnoldi keeps
ONE orthonormal basis (condition number 1 by construction), costs one matvec
per step instead of two, needs no transpose operator, and its full
orthogonalization is the same batched-matmul pattern as the symmetric
solver's reorthogonalization.  In fp32 it is strictly more robust at the
same per-iteration cost; the projected problem is a small (n, n) Hessenberg
eigensolve on the host.

Krylov–Schur restarting (Stewart 2002) bounds the basis at m vectors, like
solver/restart.py does for the symmetric path: after each cycle the Schur
form of the Rayleigh quotient is sorted, the k wanted Schur vectors are
locked, and the recurrence continues from the cycle's residual against the
locked block — A V_l = V_l T_l + v_next b^T with T_l quasi-triangular.

All precision-critical reductions honor ``compensated=True`` via the
error-free-transform dot (ops.compensated).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import LinearOperator
from .results import EigResult, acceptance_inner_prod

__all__ = ["ArnoldiFactorization", "arnoldi", "eigs_nonsym"]

_PRECISION = jax.lax.Precision.HIGHEST


def _default_dot(a, b):
    return jnp.dot(a, b, precision=_PRECISION, preferred_element_type=a.dtype)


def _default_basis_dot(B, v):
    return jnp.dot(B, v, precision=_PRECISION)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ArnoldiFactorization:
    """A V[:n].T = V[:n].T H[:n,:n] + H[n, n-1] V[n] e_n^T.

    V: (n+1, M) orthonormal rows; H: (n+1, n) upper Hessenberg (host-side
    consumers read the dense array).  breakdown_iter: first j where the new
    direction vanished (n if none) — an invariant subspace, benign.
    """

    V: jax.Array
    H: jax.Array
    breakdown_iter: jax.Array

    @property
    def n(self) -> int:
        return self.H.shape[1]


def arnoldi_kernel(
    matvec: Callable,
    v0: jax.Array,
    n: int,
    *,
    reorth_passes: int = 2,
    dot: Callable = _default_dot,
    basis_dot: Callable = _default_basis_dot,
    compensated: bool = False,
) -> ArnoldiFactorization:
    """n Arnoldi steps from v0 (need not be normalized); jit/shard_map safe.

    Orthogonalization is CGS with ``reorth_passes`` passes (CGS2 default —
    the classical twice-is-enough result); each pass is one (n+1, M) @ (M,)
    matmul pair.
    """
    if compensated:
        from ..ops.compensated import dot2_rounded

        dot = dot2_rounded

    m = v0.shape[0]
    dtype = v0.dtype

    def norm(x):
        return jnp.sqrt(dot(x, x))

    v0 = v0 / norm(v0)
    V = jnp.zeros((n + 1, m), dtype=dtype).at[0].set(v0)
    H = jnp.zeros((n + 1, n), dtype=dtype)

    def step(carry, j):
        V, H, breakdown_iter = carry
        vj = jax.lax.dynamic_index_in_dim(V, j, axis=0, keepdims=False)
        w = matvec(vj)
        h = jnp.zeros(n + 1, dtype=dtype)
        for _ in range(reorth_passes):
            c = basis_dot(V, w)  # rows > j are zero
            w = w - jnp.dot(c, V, precision=_PRECISION)
            h = h + c
        hn = norm(w)
        ok = hn > 10 * jnp.finfo(dtype).eps
        breakdown_iter = jnp.where(
            ok, breakdown_iter, jnp.minimum(breakdown_iter, j)
        )
        v_next = w * jnp.where(ok, 1.0 / jnp.where(ok, hn, 1.0), 0.0)
        V = jax.lax.dynamic_update_slice_in_dim(V, v_next[None], j + 1, axis=0)
        col = h.at[j + 1].set(hn)
        H = jax.lax.dynamic_update_slice(H, col[:, None], (jnp.int32(0), j))
        return (V, H, breakdown_iter), None

    (V, H, breakdown_iter), _ = jax.lax.scan(
        step,
        (V, H, jnp.asarray(n, dtype=jnp.int32)),
        jnp.arange(n, dtype=jnp.int32),
    )
    return ArnoldiFactorization(V=V, H=H, breakdown_iter=breakdown_iter)


@partial(jax.jit, static_argnames=("n", "reorth_passes", "dtype", "compensated"))
def _arnoldi_jit(op, n, seed, reorth_passes, dtype, compensated):
    m = op.shape[0]
    v0 = jax.random.uniform(
        jax.random.PRNGKey(seed), (m,), dtype=dtype, minval=-1.0, maxval=1.0
    )
    return arnoldi_kernel(
        op.matvec, v0, n, reorth_passes=reorth_passes, compensated=compensated
    )


@partial(jax.jit, static_argnames=("n", "reorth_passes", "compensated"))
def _arnoldi_v0_jit(op, v0, n, reorth_passes, compensated):
    return arnoldi_kernel(
        op.matvec, v0, n, reorth_passes=reorth_passes, compensated=compensated
    )


def arnoldi(
    op: LinearOperator,
    n: int,
    *,
    seed: int = 99,
    v0: Optional[jax.Array] = None,
    reorth_passes: int = 2,
    dtype=None,
    compensated: bool = False,
) -> ArnoldiFactorization:
    """Run n Arnoldi steps on op (no symmetry assumed)."""
    if n > op.shape[0]:
        raise ValueError("n cannot exceed operator dimension")
    if dtype is None:
        dtype = op.dtype
    dtype = jnp.dtype(dtype)
    if v0 is not None:
        v0 = jnp.asarray(v0, dtype=dtype)
        return _arnoldi_v0_jit(op, v0, n, reorth_passes, compensated)
    return _arnoldi_jit(op, n, seed, reorth_passes, dtype, compensated)


# ---------------------------------------------------------------------------
# Krylov–Schur restart cycle


def _ks_cycle_kernel(
    matvec: Callable,
    V: jax.Array,  # (m+1, M); rows [0, l) locked Schur vectors, row l start
    B: jax.Array,  # (m+1, m) Rayleigh-quotient storage; [0:l, 0:l] = T_l,
    #               row-l couplings B[l, :l] = b^T from the truncation
    l: int,
    m: int,
    *,
    reorth_passes: int = 2,
    dot=_default_dot,
    basis_dot=_default_basis_dot,
):
    """Extend a Krylov–Schur decomposition from order l to m.

    On entry: A V_l^T = V_l^T T_l + u b^T with u = V[l] (unit norm).  The
    continuation runs Arnoldi steps l..m-1 orthogonalizing against ALL rows;
    the new columns fill B[:, l:m] and the subdiagonal B[j+1, j].
    """
    dtype = V.dtype

    def norm(x):
        return jnp.sqrt(dot(x, x))

    def step(carry, j):
        V, B, breakdown_iter = carry
        vj = jax.lax.dynamic_index_in_dim(V, j, axis=0, keepdims=False)
        w = matvec(vj)
        h = jnp.zeros(m + 1, dtype=dtype)
        for _ in range(reorth_passes):
            c = basis_dot(V, w)
            w = w - jnp.dot(c, V, precision=_PRECISION)
            h = h + c
        hn = norm(w)
        ok = hn > 10 * jnp.finfo(dtype).eps
        breakdown_iter = jnp.where(
            ok, breakdown_iter, jnp.minimum(breakdown_iter, j)
        )
        v_next = w * jnp.where(ok, 1.0 / jnp.where(ok, hn, 1.0), 0.0)
        V = jax.lax.dynamic_update_slice_in_dim(V, v_next[None], j + 1, axis=0)
        col = h.at[j + 1].set(hn)
        B = jax.lax.dynamic_update_slice(B, col[:, None], (jnp.int32(0), j))
        return (V, B, breakdown_iter), None

    (V, B, breakdown_iter), _ = jax.lax.scan(
        step,
        (V, B, jnp.asarray(m, dtype=jnp.int32)),
        jnp.arange(l, m, dtype=jnp.int32),
    )
    return V, B, breakdown_iter


@partial(jax.jit, static_argnames=("l", "m", "reorth_passes", "compensated"))
def _ks_cycle_jit(op, V, B, l, m, reorth_passes, compensated=False):
    dot = _default_dot
    if compensated:
        from ..ops.compensated import dot2_rounded

        dot = dot2_rounded
    return _ks_cycle_kernel(
        op.matvec, V, B, l, m, reorth_passes=reorth_passes, dot=dot
    )


@partial(jax.jit, static_argnames=("l",))
def _rotate_basis(V, Z, l):
    """V_new rows [0, l) = Z^T @ V[:m]; row l = old residual row V[m]."""
    m = V.shape[0] - 1
    locked = jnp.dot(Z.T, V[:m], precision=_PRECISION)  # (l, M)
    out = jnp.zeros_like(V)
    out = out.at[:l].set(locked)
    out = out.at[l].set(V[m])
    return out


def _schur_sort_select(Bm, which, k):
    """Sorted real Schur form of Bm; returns (T, Z, l) with the l wanted
    Ritz values leading, l >= k, never splitting a 2x2 block."""
    import scipy.linalg

    if which == "SR":
        keyfun = lambda x: -x.real
    elif which == "LR":
        keyfun = lambda x: x.real
    elif which == "LM":
        keyfun = lambda x: np.abs(x)
    else:
        raise ValueError("which must be SR, LR or LM")
    T, Z = scipy.linalg.schur(Bm, output="real")
    vals = scipy.linalg.eigvals(T)
    order = np.argsort(-np.asarray([keyfun(v) for v in vals]))
    # Reorder so the k best lead, via scipy's ordschur-equivalent: use
    # schur(sort=...) with a threshold on the key.
    kth = keyfun(vals[order[k - 1]])
    # f2py inspects the callback's arity: dgees passes (wr, wi) to a two-arg
    # select function, so the signature must be explicit.
    T, Z, sdim = scipy.linalg.schur(
        Bm,
        output="real",
        sort=lambda wr, wi: _sort_pred(complex(wr, wi), which, kth),
    )
    l = max(int(sdim), k)
    # Guard 2x2 block splitting: if T[l, l-1] != 0, extend by one.
    if l < Bm.shape[0] and abs(T[l, l - 1]) > 0:
        l += 1
    return T, Z, min(l, Bm.shape[0])


def _sort_pred(val, which, kth):
    if which == "SR":
        return -val.real >= kth
    if which == "LR":
        return val.real >= kth
    return abs(val) >= kth


def eigs_nonsym(
    op: LinearOperator,
    k: int = 6,
    *,
    max_basis: int = 0,
    tol: float = 1e-6,
    max_cycles: int = 60,
    which: str = "SR",
    seed: int = 99,
    v0: Optional[jax.Array] = None,
    dtype=None,
    reorth_passes: int = 2,
    compensated: bool = False,
    verbose: bool = False,
) -> EigResult:
    """k eigenpairs of a general (non-symmetric) operator by Krylov–Schur.

    The non-Hermitian counterpart of solver.restart.eigsh_restarted, and the
    RECOMMENDED solver for the irregular-lattice Hamiltonian in fp32 (see
    module docstring for why two-sided Lanczos cannot be trusted there).

    which: "SR" (smallest real part), "LR", or "LM".
    tol:   true relative residual ||A x - lam x|| / max(|lam|, 1).
    Returns an EigResult of the k accepted pairs (real parts; on these
    near-symmetric operators genuine eigenvalues are real — a complex pair
    in the wanted set is reported via its real part and flagged by its
    residual).
    """
    mdim = op.shape[0]
    if dtype is None:
        dtype = op.dtype
    dtype = jnp.dtype(dtype)
    m = max_basis or max(2 * k + 30, k + 12)
    m = min(m, mdim - 1)

    if v0 is None:
        v0 = jax.random.uniform(
            jax.random.PRNGKey(seed), (mdim,), dtype=dtype, minval=-1, maxval=1
        )
    u = (v0 / jnp.linalg.norm(v0)).astype(dtype)
    V = jnp.zeros((m + 1, mdim), dtype=dtype).at[0].set(u)
    B = jnp.zeros((m + 1, m), dtype=dtype)

    # Row-sharded operators (ops.composite.ShardedCompositeOperator): the
    # matvec runs through its own shard_map; the dense basis algebra here
    # partitions automatically under GSPMD once V/u carry the row sharding.
    # Ghost slots (box padding) must stay exactly zero in the start vector.
    from ..ops.composite import ShardedCompositeOperator

    if isinstance(op, ShardedCompositeOperator):
        from jax.sharding import NamedSharding, PartitionSpec

        host = getattr(op, "host", None)
        if host is not None:
            u = u * jnp.asarray(host.live_mask(), dtype=dtype)
            u = u / jnp.linalg.norm(u)
            V = V.at[0].set(u)
        sh_row = NamedSharding(op.mesh, PartitionSpec(op.axis_name))
        sh_mat = NamedSharding(op.mesh, PartitionSpec(None, op.axis_name))
        u = jax.device_put(u, sh_row)
        V = jax.device_put(V, sh_mat)
    l = 0
    best = None
    best_worst = np.inf
    stall = 0

    for cycle in range(max_cycles):
        V, B, bki = _ks_cycle_jit(op, V, B, l, m, reorth_passes, compensated)
        Bm = np.asarray(B, np.float64)[:m, :m]
        bout = float(np.asarray(B[m, m - 1], np.float64))
        if not np.isfinite(Bm).all() or not np.isfinite(bout):
            raise FloatingPointError(
                f"non-finite Rayleigh quotient in Krylov-Schur cycle "
                f"{cycle}: operator overflow in {dtype} or an invalid "
                f"start vector (see SURVEY §5.2 — surfaced, not silent)"
            )

        T, Z, l_new = _schur_sort_select(Bm, which, min(k + 8, m - 2))
        # Residual couplings: A (V Z) = (V Z) T + v_m (bout e_m^T Z).
        b_new = bout * Z[m - 1, :l_new]

        # Ritz pairs + model residual from the leading Schur block.
        import scipy.linalg

        Tl = T[:l_new, :l_new]
        vals, Y = scipy.linalg.eig(Tl)
        # model residual |b^T y| per Ritz vector
        mres = np.abs(b_new @ Y)

        order = np.argsort(vals.real if which == "SR" else -vals.real)
        vals, Y, mres = vals[order], Y[:, order], mres[order]
        scale = np.maximum(np.abs(vals.real), 1.0)
        conv = (mres[:k] / scale[:k] < tol).all()
        if verbose:
            print(
                f"cycle {cycle}: ritz[0]={vals[0].real:.8g} "
                f"max-model-resid(k)={float((mres[:k]/scale[:k]).max()):.2e}"
            )

        # Truncate: rotate basis to the l_new leading Schur vectors.
        Zl = jnp.asarray(Z[:, :l_new], dtype)
        V = _rotate_basis(V, Zl, l_new)
        B = jnp.zeros_like(B)
        B = B.at[:l_new, :l_new].set(jnp.asarray(T[:l_new, :l_new], dtype))
        B = B.at[l_new, :l_new].set(jnp.asarray(b_new, dtype))
        l = l_new

        if conv or cycle == max_cycles - 1:
            # Verify against the operator itself (the model residual can
            # drift from the true one in fp32, same as the symmetric path).
            Xr = np.asarray(V[:l], np.float64).T @ Y.real
            nrm = np.linalg.norm(Xr, axis=0)
            Xr = Xr / np.where(nrm > 0, nrm, 1.0)
            Xk = Xr[:, :k]
            W = np.asarray(op.matmat(jnp.asarray(Xk, dtype)), np.float64)
            R = W - Xk * vals[:k].real
            tres = np.linalg.norm(R, axis=0) / scale[:k]
            worst = float(tres.max())
            if verbose:
                print(f"  verify: max-true-rel-resid={worst:.2e}")
            if worst < best_worst / 1.2:
                stall = 0  # meaningful improvement; noise-level wiggles
                # below 1.2x must not reset the stall counter (measured:
                # the N=120 fp32 run re-verified an unchanged 3.8e-4 five
                # times before this damping).
            else:
                stall += 1
            if worst < best_worst:
                best, best_worst = (vals[:k].real.copy(), Xk.copy(), tres), worst
            if worst < tol or stall >= 2:
                break

    lam, Xk, tres = best
    vecs = jnp.asarray(Xk, dtype=dtype)
    return EigResult(
        eigenvalues=jnp.asarray(lam),
        eigenvectors=vecs,
        residuals=jnp.asarray(tres),
        inner_prod=acceptance_inner_prod(op, vecs),
    )
