"""Block Lanczos: the SpMM path for clustered/degenerate spectra.

New capability beyond the reference (single-vector only): iterate on a block
of b vectors at once.  Each step does one operator application on an (M, b)
block — the SpMM shape (one index read feeds b values per row) —
and resolves degenerate eigenvalue clusters up to multiplicity b that
single-vector Lanczos provably cannot separate.

Recurrence (blocks stored row-major (b, M) like the single-vector basis):

    W   = A Q_j^T            (SpMM)
    A_j = Q_j W              (b x b, symmetric)
    R   = W^T - Q_j^T A_j - Q_{j-1}^T B_{j-1}^T
    [full reorthogonalization of R against all stored blocks]
    Q_{j+1}^T B_j^T = qr(R)  (tall-skinny QR on device)

The projected matrix is block tridiagonal with A_j on the diagonal and B_j
on the off-diagonal; Ritz extraction mirrors the single-vector path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import LinearOperator

__all__ = [
    "BlockLanczosFactorization",
    "block_lanczos",
    "block_ritz",
    "eigsh_block_restarted",
]

_PRECISION = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockLanczosFactorization:
    """A Q^T ~ Q^T T with Q = stacked blocks (nb, b, M), T block tridiagonal.

    a_blocks: (nb, b, b) diagonal blocks (symmetric).
    b_blocks: (nb-1, b, b) subdiagonal blocks (upper triangular from QR).
    Q:        (nb, b, M) orthonormal basis blocks (rows are vectors).
    """

    a_blocks: jax.Array
    b_blocks: jax.Array
    Q: jax.Array
    resid_block: jax.Array  # (M, b) final residual block (unnormalized)

    @property
    def num_blocks(self) -> int:
        return self.a_blocks.shape[0]

    @property
    def block_size(self) -> int:
        return self.a_blocks.shape[1]


def _orth_block(basis_flat, r):
    """Orthogonalize the (M, b) block r against all rows of (K, M) basis, CGS2."""
    for _ in range(2):
        coeff = jnp.dot(basis_flat, r, precision=_PRECISION)  # (K, b)
        r = r - jnp.dot(basis_flat.T, coeff, precision=_PRECISION)
    return r


def _qr_cure_breakdown(r, q_next, b_j, orth_fn, j):
    """Block-Lanczos breakdown handling for a (near-)rank-deficient residual
    block — exactly the degenerate-multiplet case this solver targets.

    ``jnp.linalg.qr`` of a rank-deficient r returns ARBITRARY columns for
    the deficient directions (near-zero diagonal in b_j, not orthogonal to
    the basis); feeding them into the recurrence silently corrupts it and
    the non-finite guard never fires.  Standard cure (Golub–Underwood
    block-Lanczos deflation): replace deficient columns with fresh random
    directions orthogonalized against the whole basis, re-orthonormalize,
    and zero their coupling rows in b_j (the deficient directions carry
    only ~eps residual mass, so the block-tridiagonal model stays honest).

    orth_fn: projects an (M, b) block against the current full basis.
    j:       step index (traced ok) — salts the replacement directions.
    """
    eps = jnp.finfo(r.dtype).eps
    diag = jnp.abs(jnp.diagonal(b_j))
    scale = jnp.maximum(
        jnp.max(diag), jnp.asarray(jnp.finfo(r.dtype).tiny, r.dtype)
    )
    bad = diag <= jnp.sqrt(eps) * scale

    def cure(args):
        q_next, b_j = args
        key = jax.random.fold_in(jax.random.PRNGKey(1718), j)
        rnd = jax.random.normal(key, q_next.shape, q_next.dtype)
        cand = jnp.where(bad[None, :], rnd, q_next)
        cand = orth_fn(cand)
        q_fix, _ = jnp.linalg.qr(cand)
        b_fix = jnp.dot(q_fix.T, r, precision=_PRECISION)
        b_fix = jnp.where(bad[:, None], jnp.zeros_like(b_fix), b_fix)
        return q_fix, b_fix

    return jax.lax.cond(jnp.any(bad), cure, lambda a: a, (q_next, b_j))


def block_lanczos_kernel(
    matmat,
    q0: jax.Array,  # (M, b) initial block, need not be orthonormal
    num_blocks: int,
) -> BlockLanczosFactorization:
    m, b = q0.shape
    dtype = q0.dtype

    q0, _ = jnp.linalg.qr(q0)  # (M, b) orthonormal columns

    Q = jnp.zeros((num_blocks, b, m), dtype=dtype).at[0].set(q0.T)

    def step(carry, j):
        Q, q_prev_t, b_prev = carry  # q_prev_t: (M, b); b_prev: (b, b)
        w = matmat(q_prev_t)  # (M, b) = A Q_j^T
        a_j = jnp.dot(q_prev_t.T, w, precision=_PRECISION)  # (b, b)
        a_j = 0.5 * (a_j + a_j.T)

        q_prev2_t = jax.lax.dynamic_index_in_dim(
            Q, jnp.maximum(j - 1, 0), axis=0, keepdims=False
        ).T  # (M, b)
        r = w - jnp.dot(q_prev_t, a_j, precision=_PRECISION)
        r = r - jnp.where(
            j > 0, 1.0, 0.0
        ) * jnp.dot(q_prev2_t, b_prev.T, precision=_PRECISION)

        basis_flat = Q.reshape(num_blocks * b, m)
        r = _orth_block(basis_flat, r)
        q_next, b_j = jnp.linalg.qr(r)  # (M, b), (b, b) upper triangular
        q_next, b_j = _qr_cure_breakdown(
            r, q_next, b_j, lambda c: _orth_block(basis_flat, c), j
        )

        Q = jax.lax.dynamic_update_slice_in_dim(
            Q, q_next.T[None], j + 1, axis=0
        )
        return (Q, q_next, b_j), (a_j, b_j)

    (Q, q_last, b_last), (a_blocks, b_blocks) = jax.lax.scan(
        step, (Q, q0, jnp.zeros((b, b), dtype=dtype)),
        jnp.arange(0, num_blocks - 1, dtype=jnp.int32),
    )
    # Final diagonal block + the residual block that the (unperformed) next
    # step would orthonormalize — it yields the Ritz residual estimates.
    w = matmat(q_last)
    a_last = jnp.dot(q_last.T, w, precision=_PRECISION)
    a_last = 0.5 * (a_last + a_last.T)
    a_blocks = jnp.concatenate([a_blocks, a_last[None]])
    q_prev2_t = Q[num_blocks - 2].T if num_blocks >= 2 else jnp.zeros_like(q_last)
    resid_block = (
        w
        - jnp.dot(q_last, a_last, precision=_PRECISION)
        - jnp.dot(q_prev2_t, b_last.T, precision=_PRECISION)
    )
    return BlockLanczosFactorization(
        a_blocks=a_blocks, b_blocks=b_blocks, Q=Q, resid_block=resid_block
    )


@partial(jax.jit, static_argnames=("num_blocks", "block_size", "dtype"))
def _block_jit(op, num_blocks, block_size, seed, dtype):
    m = op.shape[0]
    q0 = jax.random.normal(
        jax.random.PRNGKey(seed), (m, block_size), dtype=dtype
    )
    return block_lanczos_kernel(op.matmat, q0, num_blocks)


def block_lanczos(
    op: LinearOperator,
    num_blocks: int,
    block_size: int = 4,
    *,
    seed: int = 99,
    dtype=None,
) -> BlockLanczosFactorization:
    if num_blocks * block_size > op.shape[0]:
        raise ValueError("num_blocks * block_size cannot exceed dimension M")
    if dtype is None:
        dtype = op.dtype
    return _block_jit(op, num_blocks, block_size, seed, jnp.dtype(dtype))


@partial(
    jax.jit, static_argnames=("l", "nb", "b"), donate_argnums=(1,)
)
def _block_cycle_jit(op, V, Q0t, l, nb, b):
    """One thick-restart BLOCK cycle: blocks j = 0..nb-1 from start block
    Q0t (b, M), deflating against locked rows V[:l] via the full CGS2
    reorthogonalization.  Returns (V, a_blocks (nb,b,b), b_blocks
    (nb-1,b,b), resid (M, b) orthogonal to the whole basis).
    """
    matmat = op.matmat
    m1 = V.shape[0]
    V = jax.lax.dynamic_update_slice_in_dim(V, Q0t, l, axis=0)

    def orth(V, R):
        basis = V[: m1 - 1]
        for _ in range(2):
            coeff = jnp.dot(basis, R, precision=_PRECISION)
            R = R - jnp.dot(basis.T, coeff, precision=_PRECISION)
        return R

    def step(carry, j):
        V, q_prev_t = carry  # (M, b)
        w = matmat(q_prev_t)
        a_j = jnp.dot(q_prev_t.T, w, precision=_PRECISION)
        a_j = 0.5 * (a_j + a_j.T)
        r = w - jnp.dot(q_prev_t, a_j, precision=_PRECISION)
        # CGS2 against the full basis removes the previous block's B^T
        # component and the locked coupling in one sweep.
        r = orth(V, r)
        q_next, b_j = jnp.linalg.qr(r)
        q_next, b_j = _qr_cure_breakdown(
            r, q_next, b_j, lambda c: orth(V, c), j
        )
        V = jax.lax.dynamic_update_slice_in_dim(
            V, q_next.T, l + (j + 1) * b, axis=0
        )
        return (V, q_next), (a_j, b_j)

    if nb > 1:
        (V, q_last), (a_blocks, b_blocks) = jax.lax.scan(
            step,
            (V, Q0t.T),
            jnp.arange(0, nb - 1, dtype=jnp.int32),
        )
    else:
        V, q_last = V, Q0t.T
        a_blocks = jnp.zeros((0, b, b), V.dtype)
        b_blocks = jnp.zeros((0, b, b), V.dtype)
    w = matmat(q_last)
    a_last = jnp.dot(q_last.T, w, precision=_PRECISION)
    a_last = 0.5 * (a_last + a_last.T)
    a_blocks = jnp.concatenate([a_blocks, a_last[None]])
    resid = w - jnp.dot(q_last, a_last, precision=_PRECISION)
    resid = orth(V, resid)
    return V, a_blocks, b_blocks, resid


def eigsh_block_restarted(
    op: LinearOperator,
    k: int = 10,
    block_size: int = 4,
    *,
    num_blocks: int = 0,
    n_locked: int = 0,
    tol: float = 1e-6,
    max_cycles: int = 60,
    which: str = "SA",
    seed: int = 99,
    dtype=None,
    verbose: bool = False,
) -> "EigResult":
    """Thick-restart BLOCK Lanczos: degenerate multiplets at bounded basis.

    Single-vector thick restart (solver.restart.eigsh_restarted) provably
    finds at most one copy of each degenerate eigenvalue per Krylov space;
    the unrestarted block solver (block_lanczos) resolves multiplicity <=
    block_size but its basis grows without bound.  This routine combines
    them (block Wu-Simon): after each cycle the l best Ritz vectors are
    locked, the recurrence restarts from the (M, b) residual block, and
    the projected matrix is arrowhead + block-tridiagonal:

        B = [[diag(theta_1..l),  C^T],
             [C,  block-tridiag(A_j, B_j)]],     C = S Y_last (b, l)

    with S the QR factor of the cycle's residual block.  Residual
    estimates are ||S y_i[last b]|| — no extra SpMMs.  Convergence is
    verified against the operator itself (Rayleigh-Ritz in fp64 on the
    host, solver.restart._refine_host).

    No reference counterpart (SURVEY §7.7: the reference has neither
    blocking nor restarting); the degenerate-multiplet test is
    tests/test_block_selective.py.
    """
    from .restart import _refine_host, _ritz_update
    from .results import EigResult

    b = int(block_size)
    mdim = op.shape[0]
    if dtype is None:
        dtype = op.dtype
    dtype = jnp.dtype(dtype)
    if which not in ("SA", "LA"):
        raise ValueError("which must be SA or LA")
    nb = num_blocks or max(-(-(2 * k + 20) // b), 4)
    l_keep = n_locked or min(k + max(b, 4), nb * b - b)
    if l_keep < k:
        raise ValueError(f"n_locked={l_keep} < k={k}")
    mtot = l_keep + nb * b
    if mtot >= mdim:
        raise ValueError(
            f"basis {mtot} (n_locked={l_keep} + {nb}x{b}) must be smaller "
            f"than the operator dimension {mdim}"
        )

    rng = jax.random.PRNGKey(seed)
    Q0t = jax.random.normal(rng, (b, mdim), dtype=dtype)
    Q0t = jnp.linalg.qr(Q0t.T)[0].T
    V = jnp.zeros((mtot + 1, mdim), dtype=dtype)
    theta = np.zeros(0)
    C = np.zeros((b, 0))
    l = 0
    refined = None
    best_rel = np.inf

    for cycle in range(max_cycles):
        V, a_blocks, b_blocks, resid = _block_cycle_jit(
            op, V, Q0t, l, nb, b
        )
        mt = l + nb * b
        B = np.zeros((mt, mt))
        if l:
            B[:l, :l] = np.diag(theta)
            B[l : l + b, :l] = C
            B[:l, l : l + b] = C.T
        ab = np.asarray(a_blocks, np.float64)
        bb = np.asarray(b_blocks, np.float64)
        for j in range(nb):
            B[l + j * b : l + (j + 1) * b, l + j * b : l + (j + 1) * b] = ab[j]
        for j in range(nb - 1):
            B[l + (j + 1) * b : l + (j + 2) * b, l + j * b : l + (j + 1) * b] = bb[j]
            B[l + j * b : l + (j + 1) * b, l + (j + 1) * b : l + (j + 2) * b] = bb[j].T
        if not np.isfinite(B).all():
            raise FloatingPointError(
                f"non-finite projected matrix in block-restart cycle "
                f"{cycle} (operator overflow in {dtype} or degenerate "
                f"start block)"
            )
        w_all, y_all = np.linalg.eigh(B)
        order = np.argsort(w_all) if which == "SA" else np.argsort(-w_all)
        w_all, y_all = w_all[order], y_all[:, order]

        Q0_dev, S_dev = jnp.linalg.qr(resid)
        S = np.asarray(S_dev, np.float64)
        est = np.linalg.norm(S @ y_all[mt - b :, :], axis=0)
        rel = est / np.maximum(np.abs(w_all), 1e-30)
        if verbose:
            print(
                f"block cycle {cycle}: theta[0]={w_all[0]:.8g} "
                f"max-rel-resid(k)={rel[:k].max():.2e}"
            )
        converged = bool((rel[:k] < tol).all())

        l_new = min(l_keep, mt - b)
        e_pad = np.zeros((mtot, l_new))
        e_pad[:mt] = y_all[:, :l_new]
        V = _ritz_update(V, jnp.asarray(e_pad, dtype), l_new)
        theta = w_all[:l_new]
        C = S @ y_all[mt - b :, :l_new]
        l = l_new
        Q0t = Q0_dev.T.astype(dtype)

        if not converged:
            continue
        # Verify against the operator itself (fp32 model drift, same
        # rationale as eigsh_restarted's rr_verify).
        lam, Xr, tres, _ = _refine_host(op, V[:k].reshape(k, mdim).T)
        o2 = np.argsort(lam) if which == "SA" else np.argsort(-lam)
        lam, tres = lam[o2], tres[o2]
        Xr = Xr[:, jnp.asarray(o2)]
        trel = tres / np.maximum(np.abs(lam), 1e-30)
        worst = float(trel.max())
        if verbose:
            print(f"  verify: max-true-rel-resid={worst:.2e}")
        if refined is None or worst < best_rel:
            refined, best_rel = (lam, Xr, tres), worst
        if (trel < tol).all() or worst > best_rel * 1.3:
            break

    if refined is None:
        lam, Xr, tres, _ = _refine_host(op, V[:k].reshape(k, mdim).T)
        o2 = np.argsort(lam) if which == "SA" else np.argsort(-lam)
        lam, tres = lam[o2], tres[o2]
        Xr = Xr[:, jnp.asarray(o2)]
        refined = (lam, Xr, tres)
    lam, Xr, tres = refined
    vecs = jnp.asarray(Xr, dtype=dtype)
    from .results import acceptance_inner_prod

    return EigResult(
        eigenvalues=jnp.asarray(lam),
        eigenvectors=vecs,
        residuals=jnp.asarray(tres),
        inner_prod=acceptance_inner_prod(op, vecs),
    )


@jax.jit
def block_ritz(fac: BlockLanczosFactorization):
    """(theta, X, resid_est) from the block factorization.

    Builds the dense block-tridiagonal T (nb*b, nb*b), eigensolves on device,
    back-transforms through the stacked basis, and estimates residuals from
    the last block row: ||A x_i - theta_i x_i|| ~ ||B_last W[last block, i]||.
    """
    nb, b = fac.num_blocks, fac.block_size
    n = nb * b
    m = fac.Q.shape[2]
    t = jnp.zeros((n, n), dtype=fac.a_blocks.dtype)
    for j in range(nb):
        t = jax.lax.dynamic_update_slice(t, fac.a_blocks[j], (j * b, j * b))
    # A Qc_j = Qc_{j-1} B_{j-1}^T + Qc_j A_j + Qc_{j+1} B_j (B upper
    # triangular from QR), so T_{j+1,j} = B_j and T_{j,j+1} = B_j^T.
    for j in range(nb - 1):
        t = jax.lax.dynamic_update_slice(
            t, fac.b_blocks[j], ((j + 1) * b, j * b)
        )
        t = jax.lax.dynamic_update_slice(
            t, fac.b_blocks[j].T, (j * b, (j + 1) * b)
        )
    theta, w = jnp.linalg.eigh(t)
    basis = fac.Q.reshape(n, m)  # (n, M)
    x = jnp.dot(basis.T, w, precision=_PRECISION)  # (M, n)
    # Residual: A X - X T = R_last E_last^T  =>  per-pair norm is
    # ||resid_block @ W[last block rows, i]||.
    last_rows = w[-b:, :]  # (b, n)
    resid = jnp.linalg.norm(
        jnp.dot(fac.resid_block, last_rows, precision=_PRECISION), axis=0
    )
    return theta, x, resid
