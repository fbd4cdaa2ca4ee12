"""Double-word eigenpair refinement: from the fp32 floor to 1e-8 residuals.

Classical mixed-precision eigenvector refinement (Wilkinson; Dongarra 1982)
restated for double-word fp32 storage: given fp32-converged Ritz pairs
(lam_i, x_i) sitting at the fp32 storage floor (~2.4e-7 TRUE relative
residual), iterate

    r_i   = A x_i - lam_i x_i          computed in DOUBLE-WORD (ops.dd):
                                       the cancellation is exact to ~1e-14
    lam_i = lam_i + x_i.r_i / x_i.x_i  double-word Rayleigh-quotient update
    IN-SPAN: Rayleigh-Ritz ROTATION of the block in double-word arithmetic
            (S = C + G Lam with C = X^T R small and G the dd Gram matrix;
            host fp64 generalized eigh; dd rotation X <- X Z).  This is
            what resolves NEAR-DEGENERATE clusters: fp32 vectors mix a
            cluster with gap g at angle ~ eps32 ||A|| / g, stalling the
            residual at ~g * theta, and no X-orthogonal correction can fix
            it.
    OUT-OF-SPAN: d_i := argmin ||(A - lam_i) d + r_i|| over span(X)^perp,
            approximated by a few steps of BLOCK DEFLATED CG in plain fp32
            (the correction is ~1e-7 small, so fp32 loses nothing), then
            x_i <- renormalize_dd(x_i + d_i).

Each outer round contracts both error components; two-three rounds take
2.4e-7 to ~1e-9.  All vectors stay fp32 pairs; fp64 appears only in host
k x k algebra.  The inner operator P (A - lam) P (P = I - X X^T) is
positive semidefinite on range(P) as long as X spans the lowest k
eigenvectors to fp32 accuracy; refining a few BUFFER pairs beyond the k
reported ones keeps the deflation gap healthy when the spectrum is
clustered.

This is the designed route to BASELINE.md's 1e-8 north-star residual target
with an fp32 basis — the reference gets there by running fp64 end-to-end on
CPU (/root/reference/Python/Regular/Lanczos.py:75).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.compensated import dd_add, two_prod, two_sum
from ..ops.dd import _dd_tree_lastaxis, matmat_dd

__all__ = [
    "refine_eigenpairs_dd",
    "refine_eigenpairs_dd_hosted",
    "refine_eigenpairs_dd_nonsym",
    "refine_eigenpairs_fp64_host",
]

_PREC = jax.lax.Precision.HIGHEST



def _jit_unless_cpu(fn, **kw):
    """jit on the GPU; EAGER on CPU.

    XLA:CPU contracts ``a*b + c`` into FMA across error-free-transform
    boundaries under compilation (measured: a jitted dd residual degrades
    from 1e-14 to 2e-8; optimization_barrier, bitcasts and the documented
    XLA flags all fail to stop the LLVM-level contraction).  XLA:GPU keeps
    the dd residual at fp64 accuracy when compiled (chip_smoke.py's
    dd_compile_probe measures both modes on the card), so the device path
    stays compiled; CPU (the test backend) runs these few functions
    eagerly at negligible cost.
    """
    import functools

    jitted = jax.jit(fn, **kw)

    @functools.wraps(fn)
    def wrapper(*a, **k):
        if jax.default_backend() == "cpu":
            return fn(*a, **k)
        return jitted(*a, **k)

    return wrapper


def _col_dots(A, B):
    return jnp.sum(A * B, axis=0)


@partial(jax.jit, static_argnames=("steps",))
def _deflated_cg(op, X, lam, R, steps: int):
    """Approximately solve P (A - lam_i) P d_i = -r_i for all columns.

    X (M, k) the (near-orthonormal) current eigenvector block — deflation
    basis; lam (k,) shifts; R (M, k) dd residual rounded to fp32.  Fixed
    ``steps`` CG iterations, batched over columns with per-column scalars.
    Plain fp32: the correction only needs ~1e-1 relative accuracy per outer
    round to contract the outer error by ~10x.
    """

    def project(V):
        C = jnp.dot(X.T, V, precision=_PREC)
        return V - jnp.dot(X, C, precision=_PREC)

    def apply(V):
        W = op.matmat(V) - V * lam[None, :]
        return project(W)

    B = project(-R)
    D = jnp.zeros_like(B)
    Rc = B
    Pv = Rc
    rho = _col_dots(Rc, Rc)

    def body(carry, _):
        D, Rc, Pv, rho = carry
        Ap = apply(Pv)
        denom = _col_dots(Pv, Ap)
        alpha = rho / jnp.where(denom != 0, denom, 1.0)
        # Guard: if a column's curvature collapses (deflation imperfect),
        # freeze that column rather than blowing it up.
        alpha = jnp.where(denom > 0, alpha, 0.0)
        D = D + Pv * alpha[None, :]
        Rc_new = Rc - Ap * alpha[None, :]
        rho_new = _col_dots(Rc_new, Rc_new)
        beta = rho_new / jnp.where(rho != 0, rho, 1.0)
        Pv = Rc_new + Pv * beta[None, :]
        return (D, Rc_new, Pv, rho_new), None

    (D, Rc, Pv, rho), _ = jax.lax.scan(
        body, (D, Rc, Pv, rho), None, length=steps
    )
    return project(D)


@partial(jax.jit, static_argnames=("steps",))
def _deflated_bicgstab(op, X, lam, R, steps: int):
    """Transpose-free counterpart of _deflated_cg for NON-SYMMETRIC A:
    approximately solve P (A - lam_i) P d_i = -r_i by BiCGStab, batched
    over columns.

    The irregular LSQ Laplacian (models/irr_hamiltonian.py, reference
    Irregular/IrrLap.py) is near-symmetric, so BiCGStab behaves CG-like;
    it needs only ``op.matmat`` (no A^T — CompositeV2's rmatvec refusal is
    irrelevant here).  Columns whose breakdown scalars collapse are frozen
    (their correction stays where it was) rather than poisoned.
    """

    def project(V):
        C = jnp.dot(X.T, V, precision=_PREC)
        return V - jnp.dot(X, C, precision=_PREC)

    def apply(V):
        W = op.matmat(V) - V * lam[None, :]
        return project(W)

    B = project(-R)
    D = jnp.zeros_like(B)
    Rc = B
    R0 = Rc
    P = Rc
    rho = _col_dots(R0, Rc)
    tiny = jnp.finfo(B.dtype).tiny * 1e8

    def body(carry, _):
        D, Rc, P, rho = carry
        V = apply(P)
        den_a = _col_dots(R0, V)
        ok_a = jnp.abs(den_a) > tiny
        alpha = jnp.where(ok_a, rho / jnp.where(ok_a, den_a, 1.0), 0.0)
        S = Rc - V * alpha[None, :]
        T = apply(S)
        den_w = _col_dots(T, T)
        ok_w = den_w > tiny
        omega = jnp.where(
            ok_w, _col_dots(T, S) / jnp.where(ok_w, den_w, 1.0), 0.0
        )
        D = D + P * alpha[None, :] + S * omega[None, :]
        Rc_new = S - T * omega[None, :]
        rho_new = _col_dots(R0, Rc_new)
        ok_b = (jnp.abs(rho) > tiny) & (jnp.abs(omega) > tiny)
        beta = jnp.where(
            ok_b,
            (rho_new / jnp.where(jnp.abs(rho) > tiny, rho, 1.0))
            * (alpha / jnp.where(jnp.abs(omega) > tiny, omega, 1.0)),
            0.0,
        )
        P_new = Rc_new + (P - V * omega[None, :]) * beta[None, :]
        return (D, Rc_new, P_new, rho_new), None

    (D, Rc, P, rho), _ = jax.lax.scan(
        body, (D, Rc, P, rho), None, length=steps
    )
    return project(D)


@_jit_unless_cpu
def _dd_residual(op, Xh, Xl, lam_h, lam_l):
    """R = A X - lam X in double-word.

    Returns (Rh, Rl, lam_corr, rel, C) with lam_corr = (x.r)/(x.x) per
    column, rel = ||r|| / ||x||, and C = X^T R (fp32 — R is eps-small, so
    plain dots carry ~1e-13 absolute accuracy) for the in-span rotation.
    """
    Yh, Yl = matmat_dd(op, Xh, Xl)
    ph, pe = two_prod(lam_h[None, :], Xh)
    Rh, Rl = dd_add(Yh, Yl, -ph, -pe)
    low = lam_h[None, :] * Xl + lam_l[None, :] * Xh
    s, e = two_sum(Rh, -low)
    Rh, Rl = s, Rl + e
    xr = _col_dots(Xh, Rh) + _col_dots(Xh, Rl) + _col_dots(Xl, Rh)
    xx = _col_dots(Xh, Xh) + 2.0 * _col_dots(Xh, Xl)
    # The norm must use the SUM of the words: under the massive y ~ lam*x
    # cancellation the hi word alone carries ~eps*|x|-scale junk that the lo
    # word cancels exactly.
    rfl = Rh + Rl
    rr = _col_dots(rfl, rfl)
    C = (
        jnp.dot(Xh.T, Rh, precision=_PREC)
        + jnp.dot(Xh.T, Rl, precision=_PREC)
        + jnp.dot(Xl.T, Rh, precision=_PREC)
    )
    return Rh, Rl, xr / xx, jnp.sqrt(rr / xx), C


@_jit_unless_cpu
def _dd_gram(Xh, Xl):
    """G = (Xh+Xl)^T (Xh+Xl) as a dd (k, k) pair — fp32 matmuls cannot see
    the ~1e-7 off-diagonals under their ~1e-6 reduction noise at large M."""

    def one(cols):
        ah, al = cols  # (M,)
        p, e = two_prod(ah[:, None], Xh)  # (M, k)
        hi, lo = _dd_tree_lastaxis(p.T, e.T)
        cross = jnp.sum(ah[:, None] * Xl + al[:, None] * Xh, axis=0)
        s, e2 = two_sum(hi, cross)
        return s, lo + e2

    H, L = jax.lax.map(one, (Xh.T, Xl.T))
    return H, L


@_jit_unless_cpu
def _dd_rotate(Xh, Xl, Zh, Zl):
    """X <- X Z in double-word (Z a (k, k) fp32 pair from host fp64).

    A plain fp32 matmul would re-round every element to eps32, destroying
    the dd precision; instead each output column accumulates its k exact
    products through the dd tree (lax.map keeps the graph small).
    """

    def one(zc):
        zh, zl = zc  # (k,)
        p, e = two_prod(Xh, zh[None, :])  # (M, k)
        hi, lo = _dd_tree_lastaxis(p, e)
        cross = jnp.sum(Xh * zl[None, :] + Xl * zh[None, :], axis=1)
        s, e2 = two_sum(hi, cross)
        return s, lo + e2

    H, L = jax.lax.map(one, (Zh.T, Zl.T))
    return H.T, L.T


@_jit_unless_cpu
def _dd_update(Xh, Xl, D):
    """X <- (X + D) / ||X + D|| column-wise in double-word (D fp32-small)."""
    s, e = two_sum(Xh, D)
    Xh, Xl = s, Xl + e
    nn = _col_dots(Xh, Xh) + 2.0 * _col_dots(Xh, Xl)
    inv = 1.0 / jnp.sqrt(nn)
    inv = inv * (1.5 - 0.5 * nn * inv * inv)  # one Newton step
    ph, pe = two_prod(Xh, inv[None, :])
    s, e = two_sum(ph, Xl * inv[None, :])
    return s, pe + e


@_jit_unless_cpu
def _dd_residual_cols(op, Xh, Xl, lam_h, lam_l):
    """Chunked-column variant of _dd_residual without the C block."""
    Yh, Yl = matmat_dd(op, Xh, Xl)
    ph, pe = two_prod(lam_h[None, :], Xh)
    Rh, Rl = dd_add(Yh, Yl, -ph, -pe)
    low = lam_h[None, :] * Xl + lam_l[None, :] * Xh
    s, e = two_sum(Rh, -low)
    Rh, Rl = s, Rl + e
    xr = _col_dots(Xh, Rh) + _col_dots(Xh, Rl) + _col_dots(Xl, Rh)
    xx = _col_dots(Xh, Xh) + 2.0 * _col_dots(Xh, Xl)
    # The norm must use the SUM of the words: under the massive y ~ lam*x
    # cancellation the hi word alone carries ~eps*|x|-scale junk that the lo
    # word cancels exactly.
    rfl = Rh + Rl
    rr = _col_dots(rfl, rfl)
    return Rh, Rl, xr / xx, jnp.sqrt(rr / xx)


def _host_rss_gb() -> float:
    """Current process RSS in GiB (stdlib, /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return float("nan")


def refine_eigenpairs_dd_hosted(
    op,
    lam: np.ndarray,
    X64: np.ndarray,
    *,
    tol: float = 1e-8,
    max_rounds: int = 4,
    cg_steps: int = 200,
    col_chunk: int = 16,
    k_report: int = 0,
    verbose: bool = False,
):
    """Memory-lean refinement for north-star scale (M ~ 1e7, k ~ 100).

    ``k_report``: convergence is judged on the first k_report columns only
    (0 = all): the trailing BUFFER pairs guard the deflation window and may
    sit at a cluster edge that never reaches tol — they must not keep the
    loop spinning after the reported pairs are done.

    The authoritative eigenvector block lives on the HOST in fp64 (the
    reference's native precision; M*k*8 bytes of host RAM), while all O(M)
    compute runs on-device in fp32 pairs, ``col_chunk`` columns at a time —
    device peak is one full fp32 block (deflation basis, 5.8 GB at
    M = 13M, k = 110) plus chunk-sized work arrays.  The k x k rotation
    algebra runs in host fp64 BLAS (O(M k^2), seconds).

    Same math as refine_eigenpairs_dd; returns (lam, X64, rel) with X64
    updated in place.

    HOST-MEMORY CONTRACT (the r4 north-star attempt died at 130 GB RSS on
    a 125 GB host — every unbounded temporary is now gone): peak host RSS
    is X64 itself (M*k*8 B) + one fp32 copy of X64 (M*k*4 B, alive only
    during the CG phase) + O(M * col_chunk) chunk temporaries.  At
    M = 13.1e6, k = 114 that is ~12 + ~6 + ~1 GB = ~19 GB.  Concretely:

    * the in-span rotation ``X64 @ Z`` runs IN PLACE over row blocks
      (never a second (M, k) fp64 array);
    * residual chunks are NEVER accumulated across columns; in the
      correction phase each chunk's dd residual stays ON DEVICE and feeds
      the deflated-CG solve directly (no host round-trip of R at all).
    """
    import scipy.linalg

    lam = np.asarray(lam, np.float64).copy()
    X64 = np.asarray(X64, np.float64)
    m, k = X64.shape
    rel = None
    row_block = max(1, (64 << 20) // (8 * k))  # ~64 MB fp64 row blocks

    def _chunk_pair(lo, hi):
        Xc = X64[:, lo:hi]
        Xh32 = Xc.astype(np.float32)
        Xl32 = (Xc - Xh32.astype(np.float64)).astype(np.float32)
        return Xh32, Xl32

    def residual_pass(collect_C):
        """One dd-residual sweep over all columns; optionally C = X^T R.

        Returns (corr, relr, C).  No per-chunk residual is retained."""
        C = np.zeros((k, k)) if collect_C else None
        corr = np.zeros(k)
        relr = np.zeros(k)
        for lo in range(0, k, col_chunk):
            hi = min(lo + col_chunk, k)
            Xh32, Xl32 = _chunk_pair(lo, hi)
            lh, ll = _split_vec(lam[lo:hi])

            Rh, Rl, c_, r_ = _dd_residual_cols(
                op, jnp.asarray(Xh32), jnp.asarray(Xl32), lh, ll
            )
            R32 = np.asarray(Rh + Rl, np.float32) if collect_C else None
            corr[lo:hi] = np.asarray(c_, np.float64)
            relr[lo:hi] = np.asarray(r_, np.float64)
            if collect_C:
                # C = X^T R on the HOST — keeping a device-resident full X
                # block during the dd residual pass was an on-chip OOM at
                # M ~ 13M (R is eps-small, so BLAS accuracy suffices).
                C[:, lo:hi] = X64.T @ R32
            del R32
        return corr, relr, C

    for rnd in range(max_rounds):
        corr, relr, C = residual_pass(True)
        lam_pre = lam.copy()  # the lambda R (and hence C) was computed at
        lam = lam + corr
        rel = relr / np.maximum(np.abs(lam), 1e-30)
        kr = k_report or k
        if verbose:
            print(f"refine_dd_hosted round {rnd}: max rel {rel.max():.3e} "
                  f"(first {kr}: {rel[:kr].max():.3e}) "
                  f"[host RSS {_host_rss_gb():.1f} GB]", flush=True)
        if (rel[:kr] < tol).all():
            break
        # ---- in-span rotation, host fp64 BLAS (S needs the pre-correction
        # lambda: S_ij = C_ij + lam_j G_ij holds at the residual's lambda).
        G = X64.T @ X64
        S = C + G * lam_pre[None, :]
        S = (S + S.T) / 2
        G = (G + G.T) / 2
        try:
            mu, Z = scipy.linalg.eigh(S, G)
        except np.linalg.LinAlgError:
            mu, Z = scipy.linalg.eigh(S)
        # In-place blocked rotation: X64 @ Z without a second (M, k) array.
        for r0 in range(0, m, row_block):
            r1 = min(r0 + row_block, m)
            X64[r0:r1] = X64[r0:r1] @ Z
        lam = mu
        # ---- out-of-span correction: per chunk, the dd residual of the
        # ROTATED block is computed on device and fed straight into the
        # deflated CG (R never visits the host).  The fp32 deflation block
        # is built blockwise into a preallocated array (no .astype double
        # allocation) and lives on device only for this phase.
        X32 = np.empty((m, k), np.float32)
        for r0 in range(0, m, row_block):
            r1 = min(r0 + row_block, m)
            X32[r0:r1] = X64[r0:r1]
        Xh_dev = jnp.asarray(X32)
        del X32
        for lo in range(0, k, col_chunk):
            hi = min(lo + col_chunk, k)
            Xh32, Xl32 = _chunk_pair(lo, hi)
            lh, ll = _split_vec(lam[lo:hi])
            Rh, Rl, c_, _ = _dd_residual_cols(
                op, jnp.asarray(Xh32), jnp.asarray(Xl32), lh, ll
            )
            c_np = np.asarray(c_, np.float64)
            lam_c = (lam[lo:hi] + c_np).astype(np.float32)
            D = np.asarray(
                _deflated_cg(op, Xh_dev, jnp.asarray(lam_c), Rh + Rl,
                             cg_steps),
                np.float64,
            )
            lam[lo:hi] += c_np
            X64[:, lo:hi] += D
            del D
        del Xh_dev
        X64 /= np.linalg.norm(X64, axis=0)[None, :]
    corr, relr, _ = residual_pass(False)
    lam = lam + corr
    rel = relr / np.maximum(np.abs(lam), 1e-30)
    return lam, X64, rel


def refine_eigenpairs_dd_nonsym(
    op,
    lam: np.ndarray,
    X,
    *,
    tol: float = 1e-8,
    max_rounds: int = 6,
    cg_steps: int = 40,
    verbose: bool = False,
):
    """Refine fp32 RIGHT eigenpairs of a NON-SYMMETRIC operator.

    Closes the irregular physics problem's accuracy gap (VERDICT r3 weak
    #4): eigs_nonsym stalls at ~eps32 * ||A|| / |lam| (~4e-4 on the N=120
    deuteron lattice — the fp32 STORAGE floor of applying A, not a solver
    defect), and the symmetric dd refinement refused non-symmetric
    operators.  Same outer loop as refine_eigenpairs_dd with two changes:

    * the in-span Rayleigh-Ritz uses the OBLIQUE projected problem
      S z = mu G z with S = X^T A X unsymmetrized (scipy.linalg.eig);
      complex-conjugate Ritz pairs are realified via their (Re, Im) real
      invariant-subspace basis;
    * the out-of-span correction solves P (A - lam) P d = -r by deflated
      BiCGStab (transpose-free) instead of CG.

    One-sided Rayleigh-quotient eigenvalue updates contract like
    O(theta_left * theta_right) rather than O(theta^2) — hence the higher
    default max_rounds.  Reference parity: the two-sided solver this
    refines beyond is /root/reference/Python/Irregular/IrrLanczos.py:77-187
    (fp64 end-to-end there; fp32+dd here).
    """
    import scipy.linalg

    Xh = jnp.asarray(X, jnp.float32)
    Xl = jnp.zeros_like(Xh)
    lam = np.asarray(lam, np.float64).copy()
    rel = None
    for rnd in range(max_rounds):
        lam_h, lam_l = _split_vec(lam)
        Rh, Rl, corr, relr, C = _dd_residual(op, Xh, Xl, lam_h, lam_l)
        lam_pre = lam.copy()
        lam = lam + np.asarray(corr, np.float64)
        rel = np.asarray(relr, np.float64) / np.maximum(np.abs(lam), 1e-30)
        if verbose:
            print(f"refine_dd_nonsym round {rnd}: max rel resid {rel.max():.3e}")
        if (rel < tol).all():
            break
        # ---- in-span rotation: oblique (non-symmetric) projected problem.
        Gh, Gl = _dd_gram(Xh, Xl)
        G = np.asarray(Gh, np.float64) + np.asarray(Gl, np.float64)
        S = np.asarray(C, np.float64) + G * lam_pre[None, :]
        try:
            mu, Z = scipy.linalg.eig(S, (G + G.T) / 2)
        except np.linalg.LinAlgError:
            mu, Z = scipy.linalg.eig(S)
        order = np.argsort(mu.real)
        mu, Z = mu[order], Z[:, order]
        # Realify conjugate pairs: columns (z, z*) -> (Re z, Im z) span the
        # same real invariant subspace; lone near-real columns take Re.
        Zr = np.empty(Z.shape, np.float64)
        j = 0
        k = Z.shape[1]
        while j < k:
            if (
                j + 1 < k
                and abs(mu[j].imag) > 1e-12 * max(1.0, abs(mu[j].real))
                and abs(mu[j + 1].conj() - mu[j]) <= 1e-8 * max(1.0, abs(mu[j]))
            ):
                Zr[:, j] = Z[:, j].real
                Zr[:, j + 1] = Z[:, j].imag
                j += 2
            else:
                Zr[:, j] = Z[:, j].real
                j += 1
        nrm = np.linalg.norm(Zr, axis=0)
        Zr = Zr / np.where(nrm > 0, nrm, 1.0)
        Zh, Zl = _split_mat(Zr)
        Xh, Xl = _dd_rotate(Xh, Xl, Zh, Zl)
        lam = mu.real
        # ---- out-of-span correction at the rotated block (BiCGStab).
        lam_h, lam_l = _split_vec(lam)
        Rh, Rl, corr, relr, _ = _dd_residual(op, Xh, Xl, lam_h, lam_l)
        lam = lam + np.asarray(corr, np.float64)
        D = _deflated_bicgstab(
            op, Xh, jnp.asarray(lam.astype(np.float32)), Rh + Rl, cg_steps
        )
        Xh, Xl = _dd_update(Xh, Xl, D)
    lam_h, lam_l = _split_vec(lam)
    _, _, corr, relr, _ = _dd_residual(op, Xh, Xl, lam_h, lam_l)
    lam = lam + np.asarray(corr, np.float64)
    rel = np.asarray(relr, np.float64) / np.maximum(np.abs(lam), 1e-30)
    return lam, Xh, Xl, rel


def refine_eigenpairs_fp64_host(
    A,
    lam: np.ndarray,
    X: np.ndarray,
    *,
    tol: float = 1e-10,
    max_rounds: int = 5,
    cg_steps: int = 300,
    verbose: bool = False,
):
    """Plain fp64 HOST refinement against a scipy sparse matrix (symmetric
    or not): oblique Rayleigh-Ritz + deflated BiCGStab per column.

    For problems small enough to afford fp64 on the host (the irregular
    flagship, P ~ 1e5) this removes BOTH error sources the dd path cannot:
    the fp32 subspace error AND the fp32 *coefficient* rounding of the
    stored operator (the deuteron LSQ weights are not fp32-representable,
    so refining against the stored operator floors ~eps32*||A|| away from
    the true physics operator; the reference avoids this by running fp64
    end-to-end, Regular/Lanczos.py:75).  The dd machinery remains the route
    at north-star scale, where the operator is integer/fp32-exact.

    Returns (lam, X, rel) with rel the true fp64 relative residuals.
    """
    import scipy.linalg
    import scipy.sparse.linalg as spla

    X = np.asarray(X, np.float64).copy()
    X /= np.linalg.norm(X, axis=0)[None, :]
    lam = np.asarray(lam, np.float64).copy()
    m, k = X.shape
    rel = None
    for rnd in range(max_rounds):
        W = A @ X
        lam = np.sum(X * W, axis=0) / np.sum(X * X, axis=0)
        R = W - X * lam[None, :]
        rel = np.linalg.norm(R, axis=0) / np.maximum(np.abs(lam), 1.0)
        if verbose:
            print(f"refine_fp64_host round {rnd}: max rel {rel.max():.3e}",
                  flush=True)
        if (rel < tol).all():
            break
        # Oblique Rayleigh-Ritz (no symmetrization), realified.
        S = X.T @ W
        G = X.T @ X
        try:
            mu, Z = scipy.linalg.eig(S, (G + G.T) / 2)
        except np.linalg.LinAlgError:
            mu, Z = scipy.linalg.eig(S)
        order = np.argsort(mu.real)
        mu, Z = mu[order], Z[:, order]
        Zr = np.empty(Z.shape, np.float64)
        j = 0
        while j < k:
            if (
                j + 1 < k
                and abs(mu[j].imag) > 1e-12 * max(1.0, abs(mu[j].real))
                and abs(mu[j + 1].conj() - mu[j]) <= 1e-8 * max(1.0, abs(mu[j]))
            ):
                Zr[:, j] = Z[:, j].real
                Zr[:, j + 1] = Z[:, j].imag
                j += 2
            else:
                Zr[:, j] = Z[:, j].real
                j += 1
        X = X @ Zr
        X /= np.linalg.norm(X, axis=0)[None, :]
        lam = mu.real
        W = A @ X
        lam = np.sum(X * W, axis=0) / np.sum(X * X, axis=0)
        R = W - X * lam[None, :]
        # Deflated BiCGStab correction per column: P (A - lam_i) P d = -r.
        Q, _ = np.linalg.qr(X)

        def proj(v):
            return v - Q @ (Q.T @ v)

        for i in range(k):
            li = lam[i]

            def mv(v):
                return proj(A @ proj(v) - li * proj(v))

            op_i = spla.LinearOperator((m, m), matvec=mv, dtype=np.float64)
            d, _ = spla.bicgstab(
                op_i, proj(-R[:, i]), maxiter=cg_steps,
                rtol=1e-2, atol=0.0,
            )
            X[:, i] += proj(d)
        X /= np.linalg.norm(X, axis=0)[None, :]
    W = A @ X
    lam = np.sum(X * W, axis=0) / np.sum(X * X, axis=0)
    rel = np.linalg.norm(W - X * lam[None, :], axis=0) / np.maximum(
        np.abs(lam), 1.0
    )
    return lam, X, rel


def _split_mat(Z: np.ndarray):
    h = Z.astype(np.float32)
    l = (Z - h.astype(np.float64)).astype(np.float32)
    return jnp.asarray(h), jnp.asarray(l)


def _split_vec(v: np.ndarray):
    h = v.astype(np.float32)
    l = (v - h.astype(np.float64)).astype(np.float32)
    return jnp.asarray(h), jnp.asarray(l)


def refine_eigenpairs_dd(
    op,
    lam: np.ndarray,
    X,
    *,
    tol: float = 1e-8,
    max_rounds: int = 4,
    cg_steps: int = 25,
    verbose: bool = False,
):
    """Refine fp32 Ritz pairs to double-word accuracy.

    op:   operator supporting matmat (fp32) and ops.dd matvec_dd.
    lam:  (k,) eigenvalue estimates (fp64 host array).
    X:    (M, k) fp32 eigenvector estimates, columns ~orthonormal.
    tol:  target TRUE relative residual ||A x - lam x|| / (||x|| |lam|),
          measured in double-word arithmetic.

    Returns (lam_refined (k,) fp64, Xh, Xl, rel_resid (k,) fp64) — the
    refined eigenvectors as a double-word pair (Xh is the fp32 rounding of
    the refined vector; Xh + Xl carries ~2^-48 precision).
    """
    import scipy.linalg

    Xh = jnp.asarray(X, jnp.float32)
    Xl = jnp.zeros_like(Xh)
    lam = np.asarray(lam, np.float64).copy()
    rel = None
    for rnd in range(max_rounds):
        lam_h, lam_l = _split_vec(lam)
        Rh, Rl, corr, relr, C = _dd_residual(op, Xh, Xl, lam_h, lam_l)
        lam_pre = lam.copy()  # the lambda R (and hence C) was computed at
        lam = lam + np.asarray(corr, np.float64)
        rel = np.asarray(relr, np.float64) / np.maximum(np.abs(lam), 1e-30)
        if verbose:
            print(f"refine_dd round {rnd}: max rel resid {rel.max():.3e}")
        if (rel < tol).all():
            break
        # ---- in-span Rayleigh-Ritz rotation (cluster mixing).
        Gh, Gl = _dd_gram(Xh, Xl)
        G = np.asarray(Gh, np.float64) + np.asarray(Gl, np.float64)
        C64 = np.asarray(C, np.float64)
        # S_ij = x_i^T A x_j = C_ij + lam_j G_ij holds for the lambda the
        # residual was computed at; mixing in the corrected lambda leaves an
        # O(residual) error in S that floors the rotation.
        S = C64 + G * lam_pre[None, :]
        S = (S + S.T) / 2
        G = (G + G.T) / 2
        try:
            mu, Z = scipy.linalg.eigh(S, G)
        except np.linalg.LinAlgError:
            mu, Z = scipy.linalg.eigh(S)
        Zh, Zl = _split_mat(Z)
        Xh, Xl = _dd_rotate(Xh, Xl, Zh, Zl)
        lam = mu
        # ---- out-of-span correction at the rotated block.
        lam_h, lam_l = _split_vec(lam)
        Rh, Rl, corr, relr, _ = _dd_residual(op, Xh, Xl, lam_h, lam_l)
        lam = lam + np.asarray(corr, np.float64)
        D = _deflated_cg(op, Xh, jnp.asarray(lam.astype(np.float32)), Rh + Rl, cg_steps)
        Xh, Xl = _dd_update(Xh, Xl, D)
    # Final residual at the refined pairs.
    lam_h, lam_l = _split_vec(lam)
    _, _, corr, relr, _ = _dd_residual(op, Xh, Xl, lam_h, lam_l)
    lam = lam + np.asarray(corr, np.float64)
    rel = np.asarray(relr, np.float64) / np.maximum(np.abs(lam), 1e-30)
    return lam, Xh, Xl, rel
