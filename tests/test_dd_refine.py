"""Double-word operator application and eigenpair refinement (the 1e-8 path).

The fp32 storage floor (~2.4e-7 TRUE relative residual, pinned in
test_compensated.py) is broken by storing eigenvectors as hi+lo fp32 pairs
and computing residuals with error-free tap products (ops.dd), then
correcting through deflated CG (solver.refine).  These tests verify:

1. matvec_dd is fp64-accurate for every supported operator type;
2. refinement takes fp32-floor eigenpairs of a small irregular operator to
   <= 1e-9 against the scipy fp64 oracle;
3. refinement reaches <= 1e-8 TRUE relative residual on a >= 1M-point
   operator in fp32-dominant arithmetic (the BASELINE.md north-star
   accuracy requirement; the reference needs fp64 end-to-end for this,
   /root/reference/Python/Regular/Lanczos.py:75).
"""

import numpy as np
import pytest

import lanczos_tpu as lt
from lanczos_tpu.models.irr_hamiltonian import (
    irregular_laplacian_rows,
)
from lanczos_tpu.models.lattice import build_lattice, find_neighbors
from lanczos_tpu.ops.composite2 import build_composite_v2
from lanczos_tpu.ops.dd import matvec_dd
from lanczos_tpu.solver.refine import refine_eigenpairs_dd


def _graph_laplacian_rows(lat):
    nbrs, rels = find_neighbors(lat, 1)
    p, k = nbrs.shape
    rows = np.repeat(np.arange(p, dtype=np.int64), k)
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    fwd = rows[valid] * p + cols[valid]
    bwd = np.sort(cols[valid] * p + rows[valid])
    pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
    keep = np.zeros(len(rows), dtype=bool)
    keep[valid] = bwd[pos] == fwd
    keep = keep.reshape(p, k)
    nbrs = np.where(keep, nbrs, -1)
    weights = np.where(keep, -1.0, 0.0)
    deg = keep.sum(axis=1).astype(np.float64)
    return nbrs, rels, weights, deg, rows, cols, keep


def _mixed_lattice(n, bd=3):
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    return build_lattice(n, 25.0, bd, spacings=sp)


def test_matvec_dd_accuracy_stencil():
    """matvec_dd applies the operator's STORED (fp32) coefficients exactly:
    the oracle is the same operator promoted entrywise to fp64.  (Operators
    with integer coefficients — e.g. the north-star graph Laplacian — are
    therefore exact end-to-end; physical fp32-rounded weights retain their
    own ~1e-7 representation error, documented in ops/dd.py.)"""
    import dataclasses

    import jax.numpy as jnp

    H = lt.build_regular_hamiltonian(
        16, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    H64 = dataclasses.replace(
        H,
        weights=jnp.asarray(np.asarray(H.weights, np.float64)),
        diag=jnp.asarray(np.asarray(H.diag, np.float64)),
        graded=tuple(float(np.float32(g)) for g in H.graded)
        if H.graded is not None
        else None,
    )
    rng = np.random.default_rng(0)
    x64 = rng.normal(size=H.shape[0])
    xh = x64.astype(np.float32)
    xl = (x64 - xh.astype(np.float64)).astype(np.float32)
    yh, yl = matvec_dd(H, jnp.asarray(xh), jnp.asarray(xl))
    y_dd = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    y64 = np.asarray(H64.matvec(jnp.asarray(x64)))
    scale = np.abs(y64).max()
    err = np.abs(y_dd - y64).max() / scale
    # fp32 matvec error would be ~1e-7; dd must be ~1e-13 class.
    assert err < 5e-12, err


def test_matvec_dd_accuracy_composite2():
    import jax.numpy as jnp

    lat = _mixed_lattice(18)
    nbrs, rels, weights, deg, *_ = _graph_laplacian_rows(lat)
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    comp64, idx64 = build_composite_v2(
        lat, nbrs, rels, weights, deg, scale=1.0, dtype=np.float64,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    np.testing.assert_array_equal(idx_map, idx64)
    rng = np.random.default_rng(1)
    x64 = np.zeros(comp.shape[0])
    x64[idx_map] = rng.normal(size=lat.num_points)
    xh = x64.astype(np.float32)
    xl = (x64 - xh.astype(np.float64)).astype(np.float32)
    yh, yl = matvec_dd(comp, jnp.asarray(xh), jnp.asarray(xl))
    y_dd = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    y64 = np.asarray(comp64.matvec(jnp.asarray(x64)))
    err = np.abs(y_dd - y64).max() / np.abs(y64).max()
    assert err < 5e-12, err


def test_refine_small_irregular_vs_scipy():
    """Full pipeline at small scale: fp32 restarted solve (k + buffer) ->
    dd refinement -> TRUE residuals measured against the scipy fp64 matrix.

    The buffer pairs keep the deflation window clear of the reported pairs;
    this tiny symmetric lattice has 1e-7-gap clusters, so the reported
    eigenvalue-relative threshold is 3e-8 (operator-norm-relative — the
    ARPACK tol semantics — lands near 1e-9).  Production-size spectra are
    less pathological; the 1.12M-point test below reaches 1e-8 lam-relative.
    """
    import jax.numpy as jnp
    import scipy.sparse

    lat = _mixed_lattice(24)
    nbrs, rels, weights, deg, rows, cols, keepm = _graph_laplacian_rows(lat)
    p = lat.num_points
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    from lanczos_tpu.solver.restart import eigsh_restarted

    k, buffer = 6, 6
    rng = np.random.default_rng(5)
    v0 = np.zeros(comp.shape[0], dtype=np.float32)
    v0[idx_map] = rng.normal(size=p).astype(np.float32)
    res = eigsh_restarted(
        comp, k=k + buffer, tol=1e-6, which="SA", dtype="float32",
        v0=jnp.asarray(v0), compensated=True, max_cycles=60,
    )
    lam0 = np.asarray(res.eigenvalues, np.float64)
    X0 = np.asarray(res.eigenvectors, np.float32)

    lam, Xh, Xl, rel = refine_eigenpairs_dd(
        comp, lam0, X0, tol=1e-9, max_rounds=6, cg_steps=60
    )
    assert rel[:k].max() <= 3e-8, rel

    # Oracle: true residual and eigenvalues on the fp64 scipy matrix.
    A = scipy.sparse.csr_matrix(
        (np.ones(keepm.sum()), (rows[keepm.reshape(-1)], cols[keepm.reshape(-1)])),
        shape=(p, p),
    )
    L = scipy.sparse.diags(deg + 1.0) - A
    X = np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)
    Xlat = X[idx_map, :k]
    R = L @ Xlat - Xlat * lam[None, :k]
    true_rel = np.linalg.norm(R, axis=0) / np.linalg.norm(Xlat, axis=0) / lam[:k]
    assert true_rel.max() <= 3e-8, true_rel
    l_norm = float(abs(L).sum(axis=1).max())
    assert (true_rel * lam[:k] / l_norm).max() <= 1e-9  # ARPACK-tol semantics
    # Oracle with k + buffer: ARPACK at k=6 misses a copy of the 2-fold
    # degenerate 1.92240899 (the restarted solver + refinement resolves the
    # multiplicity correctly).
    exact = np.sort(
        scipy.sparse.linalg.eigsh(L, k=k + buffer, which="SA", tol=1e-12)[0]
    )[:k]
    np.testing.assert_allclose(np.sort(lam[:k]), exact, atol=1e-8, rtol=1e-10)


@pytest.mark.slow
def test_refine_million_point_operator():
    """>= 1M-point operator to <= 1e-8 TRUE relative residual with fp32
    pairs (the BASELINE.md north-star accuracy criterion).

    Operator: the periodic 26-neighbour GRAPH Laplacian at N=104^3 = 1.12M
    (+1 shift) — the same bounded-degree structure as the north-star
    problem, so ||A|| ~ 54 and the deflated-CG inner solve genuinely
    converges (the kinetic stencil's ||A||/gap ~ 1e5 would demand a
    preconditioner; see solver/refine.py).  Exact eigenpairs are Fourier
    modes.  Start from the fp32 ROUNDING of exact eigenvectors (exactly the
    fp32 storage floor) plus fp32-scale noise and refine the 6-fold
    degenerate cluster of the lowest nonzero modes.
    """
    import itertools

    import jax.numpy as jnp

    from lanczos_tpu.ops.operators import StencilOperator

    N = 104
    offs = tuple(
        (dz, dy, dx) for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3)
    )
    w27 = np.array([0.0 if off == (0, 0, 0) else -1.0 for off in offs])
    m = N**3
    shift = 1.0
    H = StencilOperator(
        weights=jnp.asarray(w27, jnp.float32),
        diag=jnp.full((m,), 26.0 + shift, jnp.float32),
        grid_shape=(N, N, N),
        offsets=offs,
        graded=(0.0, -1.0, -1.0, -1.0),
    )
    # 6 orthogonal eigenvectors (cos/sin along each axis) sharing one
    # eigenvalue: lam = 26 + shift - (symbol of the 26-tap sum at k=e_a).
    idx = np.arange(N)
    phase = 2 * np.pi * idx / N
    # Column 0: the constant mode (lam = shift) — it sits BELOW the
    # refined cluster and must be in the deflation set or the CG operator
    # P(A - lam)P goes indefinite.
    vecs = [np.ones(m) ]
    for ax in range(3):
        shape = [1, 1, 1]
        shape[ax] = N
        ones = np.ones((N, N, N))
        vecs.append((np.cos(phase).reshape(shape) * ones).reshape(-1))
        vecs.append((np.sin(phase).reshape(shape) * ones).reshape(-1))
    X64 = np.stack(vecs, axis=1)
    X64 /= np.linalg.norm(X64, axis=0)[None, :]
    c = np.cos(2 * np.pi / N)
    # sum over (dx,dy,dz) != 0 of cos(k . d) with k = (2pi/N) e_x:
    # = 3 * 3 * (1 + 2 cos) - 1  (product structure of the cube stencil).
    lam_exact = 26.0 + shift - (9.0 * (1.0 + 2.0 * c) - 1.0)
    lam_all = np.array([shift] + [lam_exact] * 6)

    rng = np.random.default_rng(9)
    Xh = X64.astype(np.float32)
    Xh = Xh + (1e-7 * rng.normal(size=Xh.shape)).astype(np.float32)
    lam0 = lam_all * (1 + 1e-7)

    lam, XhR, XlR, rel = refine_eigenpairs_dd(
        H, lam0, Xh, tol=1e-8, max_rounds=6, cg_steps=160
    )
    assert m >= 1_000_000
    assert rel.max() <= 1e-8, rel
    np.testing.assert_allclose(lam, lam_all, rtol=1e-9)


def test_refine_hosted_matches_device():
    """The host-anchored chunked refinement (north-star scale path) reaches
    the same accuracy class as the pure-device variant."""
    import jax.numpy as jnp

    from lanczos_tpu.solver.refine import refine_eigenpairs_dd_hosted
    from lanczos_tpu.solver.restart import eigsh_restarted

    lat = _mixed_lattice(24)
    nbrs, rels, weights, deg, rows, cols, keepm = _graph_laplacian_rows(lat)
    p = lat.num_points
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    k, buffer = 6, 6
    rng = np.random.default_rng(5)
    v0 = np.zeros(comp.shape[0], dtype=np.float32)
    v0[idx_map] = rng.normal(size=p).astype(np.float32)
    res = eigsh_restarted(
        comp, k=k + buffer, tol=1e-6, which="SA", dtype="float32",
        v0=jnp.asarray(v0), compensated=True, max_cycles=60,
    )
    lam, X64, rel = refine_eigenpairs_dd_hosted(
        comp,
        np.asarray(res.eigenvalues, np.float64),
        np.asarray(res.eigenvectors, np.float64),
        tol=1e-9,
        max_rounds=6,
        cg_steps=60,
        col_chunk=5,  # force uneven chunking
    )
    assert rel[:k].max() <= 3e-8, rel


def test_refine_nonsym_irregular():
    """NON-SYMMETRIC refinement (VERDICT r3 next #5): the irregular LSQ
    deuteron Hamiltonian's fp32 Krylov-Schur pairs stall at the fp32
    storage floor ~eps32*||A||/|lam|; refine_eigenpairs_dd_nonsym (oblique
    Rayleigh-Ritz + deflated BiCGStab) takes them to <= 1e-8 TRUE relative
    residual against the fp64 promotion of the same stored operator.
    Reference parity: Irregular/IrrLanczos.py:77-187 (fp64 end-to-end)."""
    import scipy.linalg

    lat = build_lattice(24, 25.0, 3, overwrite_spacing=True)
    H = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, symmetrize=None, dtype=np.float32
    )
    k = 4
    res = lt.eigs_nonsym(
        H, k=k, tol=1e-6, which="SR", dtype="float32", max_cycles=40
    )
    lam0 = np.asarray(res.eigenvalues, np.float64)
    X0 = np.asarray(res.eigenvectors, np.float32)
    stalled = np.asarray(res.residuals, np.float64).max()

    from lanczos_tpu.solver.refine import refine_eigenpairs_dd_nonsym

    lam, Xh, Xl, rel = refine_eigenpairs_dd_nonsym(
        H, lam0, X0, tol=1e-9, max_rounds=8, cg_steps=60
    )
    assert rel.max() <= 1e-8, (stalled, rel)

    # fp64 oracle on the STORED fp32 coefficients (what dd applies exactly).
    A = H.to_scipy().astype(np.float64)
    X = np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)
    R = A @ X - X * lam[None, :]
    true_rel = (
        np.linalg.norm(R, axis=0)
        / np.linalg.norm(X, axis=0)
        / np.maximum(np.abs(lam), 1.0)
    )
    assert true_rel.max() <= 1e-8, true_rel
    # eigenvalues agree with the dense fp64 oracle
    w = scipy.linalg.eig(A.toarray(), right=False)
    w = np.sort(w.real[np.abs(w.imag) < 1e-8])
    np.testing.assert_allclose(np.sort(lam), w[:k], atol=1e-7, rtol=1e-9)


def test_refine_fp64_host_flagship_flow():
    """The flagship pipeline at test size: fp32 Krylov-Schur on the
    composite v1 operator -> plain fp64 HOST refinement against the TRUE
    fp64 matrix (stored-coefficient rounding removed, unlike the dd path) —
    residuals reach <= 1e-9 vs the physics operator, reference fp64
    parity (Irregular/Irr3Ddeuteron.py:13-41)."""
    from lanczos_tpu.models.irr_hamiltonian import (
        assemble_irregular_hamiltonian_composite,
    )
    from lanczos_tpu.solver.refine import refine_eigenpairs_fp64_host

    lat = build_lattice(24, 25.0, 3, overwrite_spacing=True)
    op, perm = assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype="float32"
    )
    k = 4
    res = lt.eigs_nonsym(
        op, k=k, tol=1e-6, which="SR", dtype="float32", max_cycles=40
    )
    vals = np.asarray(res.eigenvalues, np.float64)
    order = np.argsort(vals)
    X_op = np.asarray(res.eigenvectors, np.float64)[:, order]
    X_lat = np.empty_like(X_op)
    X_lat[np.asarray(perm)] = X_op

    A64 = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, symmetrize=None, dtype=np.float64
    ).to_scipy()
    lam, X, rel = refine_eigenpairs_fp64_host(
        A64, vals[order], X_lat, tol=1e-10, max_rounds=6, cg_steps=200
    )
    assert rel.max() <= 1e-9, rel
    # every refined eigenvalue is a true eigenvalue of the fp64 oracle
    # (nearest-match: a single-vector Krylov run may capture one copy of a
    # degenerate multiplet and the next distinct eigenvalue instead of the
    # second copy — the reference behaves the same; the multiplet-complete
    # solver is the block path, test_block_selective.py)
    import scipy.linalg

    w = scipy.linalg.eig(A64.toarray(), right=False)
    w = np.sort(w.real[np.abs(w.imag) < 1e-8])
    for v in lam:
        assert np.abs(w - v).min() <= 1e-9, (v, w[:k + 2])
    # and the ground state specifically matches
    np.testing.assert_allclose(lam.min(), w[0], atol=1e-9, rtol=1e-11)


@pytest.mark.gpu
def test_dd_jit_vs_eager_consistency_gpu(gpu_device):
    """The compiled dd path — what GPU runs use — must agree with the eager
    path the CPU suite validates.  An XLA version that starts contracting
    a*b+c into FMA across the error-free-transform boundaries (the known
    XLA:CPU hazard, ops/dd.py) would show up here as a ~1e-8-scale
    divergence."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu.solver.refine import _dd_residual, _split_vec

    lat = _mixed_lattice(12)
    nbrs, rels, weights, deg, rows, cols, keepm = _graph_laplacian_rows(lat)
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=np.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    m = comp.shape[0]
    rng_ = np.random.default_rng(3)
    X = rng_.standard_normal((m, 3))
    X *= np.asarray(comp.live, np.float64)[:, None]
    X /= np.linalg.norm(X, axis=0)
    Xh = jnp.asarray(X.astype(np.float32))
    Xl = jnp.asarray((X - np.asarray(Xh, np.float64)).astype(np.float32))
    lam_h, lam_l = _split_vec(np.asarray([1.0, 2.0, 3.0]))

    jit_out = jax.jit(_dd_residual.__wrapped__)(comp, Xh, Xl, lam_h, lam_l)
    eager_out = _dd_residual.__wrapped__(comp, Xh, Xl, lam_h, lam_l)
    for a, b in zip(jit_out, eager_out):
        np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            rtol=0, atol=1e-12,
        )
