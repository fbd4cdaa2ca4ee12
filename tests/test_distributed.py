"""Distributed (row-sharded) Lanczos on the 8-device virtual CPU mesh.

Oracle: the single-device solver — the multi-chip path must reproduce its
factorization and spectra (this is the multi-chip test mechanism the
reference lacks entirely; SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lanczos_tpu import build_regular_hamiltonian, deuteron_potential_3d, lanczos
from lanczos_tpu.ops import ell_from_scipy
from lanczos_tpu.parallel import lanczos_sharded, make_row_mesh, shard_operator
from lanczos_tpu.solver.tridiag import ritz_from_factorization

from conftest import random_sparse_symmetric


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_row_mesh(8)


def test_sharded_stencil_matches_single_device(mesh):
    """3D deuteron Hamiltonian: sharded (halo-exchange) == single-device."""
    n_grid = 16  # 16^3 = 4096 points, leading dim 16 divides 8 devices
    H = build_regular_hamiltonian(
        n_grid, 25.0, deuteron_potential_3d, stencil="27", dtype="float64"
    )
    n = 40
    fac_ref = lanczos(H, n, seed=3, dtype="float64")
    Hs = shard_operator(H, mesh)
    fac_dist = lanczos_sharded(Hs, n, mesh, seed=3, dtype="float64")

    np.testing.assert_allclose(
        np.asarray(fac_dist.alpha), np.asarray(fac_ref.alpha), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(fac_dist.beta), np.asarray(fac_ref.beta), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(fac_dist.V), np.asarray(fac_ref.V), rtol=1e-8, atol=1e-9
    )


def test_sharded_ell_matches_single_device(mesh, rng):
    """Row-sharded ELL (all-gather SpMV) == single-device, random sparse."""
    m = 400  # divides 8
    a = random_sparse_symmetric(rng, m)
    op = ell_from_scipy(a, dtype=np.float64)
    n = 50
    fac_ref = lanczos(op, n, seed=11, dtype="float64")
    op_s = shard_operator(op, mesh)
    fac_dist = lanczos_sharded(op_s, n, mesh, seed=11, dtype="float64")

    np.testing.assert_allclose(
        np.asarray(fac_dist.alpha), np.asarray(fac_ref.alpha), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(fac_dist.beta), np.asarray(fac_ref.beta), rtol=1e-9, atol=1e-9
    )


def test_sharded_spectra_vs_scipy(mesh, rng):
    """End-to-end: sharded factorization -> Ritz values vs scipy oracle."""
    import scipy.sparse.linalg

    m = 320
    a = random_sparse_symmetric(rng, m)
    op = shard_operator(ell_from_scipy(a, dtype=np.float64), mesh)
    fac = lanczos_sharded(op, 120, mesh, dtype="float64")
    theta, X, resid = ritz_from_factorization(fac)
    exact = np.sort(scipy.sparse.linalg.eigsh(a, k=4, which="SA")[0])
    np.testing.assert_allclose(np.asarray(theta)[:4], exact, rtol=1e-8, atol=1e-8)


def test_sharded_ell_halo_matches_and_is_thin(mesh, rng):
    """Halo-compressed sharded ELL (VERDICT r3 next #6): per-device
    exchange is the precomputed export table, not the full vector; the
    factorization matches single-device exactly, and on a lattice-local
    graph the exchanged volume shrinks toward the surface fraction as
    slabs thicken."""
    from lanczos_tpu.parallel import shard_ell_halo

    n_grid = 32  # 4 z-planes per device: 2 of 4 exported
    H = build_regular_hamiltonian(
        n_grid, 25.0, deuteron_potential_3d, stencil="27", dtype="float64"
    )
    ell = H.to_ell()
    n = 30
    fac_ref = lanczos(ell, n, seed=7, dtype="float64")
    hop = shard_ell_halo(ell, mesh)
    fac_dist = lanczos_sharded(hop, n, mesh, seed=7, dtype="float64")
    np.testing.assert_allclose(
        np.asarray(fac_dist.alpha), np.asarray(fac_ref.alpha),
        rtol=1e-9, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(fac_dist.beta), np.asarray(fac_ref.beta),
        rtol=1e-9, atol=1e-9,
    )
    m = ell.shape[0]
    ex32 = hop.exchange_elements / m  # D*E / M
    assert ex32 <= 0.55, ex32

    # thickness scaling: 8 planes per device -> only 2 exported (host-only
    # analysis, no solve)
    H64 = build_regular_hamiltonian(
        64, 25.0, deuteron_potential_3d, stencil="27", dtype="float64"
    )
    hop64 = shard_ell_halo(H64.to_ell(), mesh)
    ex64 = hop64.exchange_elements / H64.shape[0]
    assert ex64 <= 0.30, ex64
    assert ex64 < 0.6 * ex32, (ex32, ex64)


def test_sharded_rejects_indivisible(mesh):
    from lanczos_tpu.ops import ell_from_coo

    op = ell_from_coo([0, 1, 2], [0, 1, 2], [1.0, 2.0, 3.0], 3, dtype=np.float64)
    with pytest.raises(ValueError, match="divide"):
        lanczos_sharded(op, 2, mesh)


@pytest.fixture(scope="module")
def composite_pair():
    from lanczos_tpu.models.irr_hamiltonian import (
        assemble_irregular_hamiltonian_composite,
    )
    from lanczos_tpu.models.lattice import build_lattice

    # Smallest lattice with both levels + interfaces: keeps the Krylov-Schur
    # equivalence test below at ~1 min instead of ~10 (it dominates suite
    # wall time; the physics-scale runs live in test_composite.py).
    lat = build_lattice(12, 25.0, 3, overwrite_spacing=True)
    comp, perm = assemble_irregular_hamiltonian_composite(
        lat, deuteron_potential_3d, dtype=np.float64
    )
    return comp, perm


def test_sharded_composite_matvec_matches(mesh, composite_pair, rng):
    """Device-major sharded composite == level-major single-device matvec
    (face-table halo exchange + per-device interface buckets)."""
    comp, _ = composite_pair
    op = shard_operator(comp, mesh)
    sc = op.host
    p = comp.shape[0]
    x = rng.standard_normal(p)
    y_ref = np.asarray(comp.matvec(jnp.asarray(x)))
    y_sh = np.asarray(jax.jit(op.matvec)(jnp.asarray(sc.to_sharded(x))))
    np.testing.assert_allclose(sc.from_sharded(y_sh), y_ref, atol=1e-12)
    # ghost (box-padding) slots never acquire values
    np.testing.assert_array_equal(y_sh * (1 - sc.live_mask()), 0.0)


@pytest.mark.slow
def test_sharded_composite_solve_matches(mesh, composite_pair):
    """Krylov-Schur on the sharded composite == single-device, to 1e-9."""
    from lanczos_tpu import eigs_nonsym

    comp, _ = composite_pair
    op = shard_operator(comp, mesh)
    res = eigs_nonsym(op, k=3, tol=1e-9, which="SR", dtype="float64")
    res1 = eigs_nonsym(comp, k=3, tol=1e-9, which="SR", dtype="float64")
    np.testing.assert_allclose(
        np.asarray(res.eigenvalues), np.asarray(res1.eigenvalues),
        rtol=1e-9, atol=1e-9,
    )
    assert float(np.max(np.asarray(res.residuals))) < 1e-9


@pytest.fixture(scope="module")
def composite_v2_pair():
    """Symmetric graph Laplacian on the mixed lattice (the north-star
    operator family), sized so every level's z-extent divides 8 devices:
    n=48, bd=3 -> fine region 16^3, coarse region 24^3."""
    from lanczos_tpu.models.lattice import build_lattice, find_neighbors
    from lanczos_tpu.ops.composite2 import build_composite_v2

    bd = 3
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    lat = build_lattice(48, 25.0, bd, spacings=sp)
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
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=np.float64,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    return comp, idx_map


@pytest.mark.slow
def test_sharded_composite_v2_matvec_matches(mesh, composite_v2_pair, rng):
    """z-slab sharded CompositeV2 (ppermute level halos + surface-run
    exchange) == single-device (VERDICT r3 missing #2).  degenerate_frac
    forces the thin-run path (z-run psum + y/x-run all-gathers) even at
    this test size, where the surface fraction would otherwise trip the
    full-gather fallback."""
    from lanczos_tpu.parallel.composite2 import shard_composite_v2

    comp, idx_map = composite_v2_pair
    op = shard_composite_v2(comp, mesh, degenerate_frac=10.0)
    host = op.host
    m = comp.shape[0]
    x = rng.standard_normal(m) * np.asarray(comp.live)
    y_ref = np.asarray(comp.matvec(jnp.asarray(x)))
    y_sh = np.asarray(jax.jit(op.matvec)(jnp.asarray(host.to_sharded(x))))
    np.testing.assert_allclose(host.from_sharded(y_sh), y_ref, atol=1e-11)
    # the thin-run path is actually in play
    for runs, (a, ext, st, sl, nzl) in zip(op.support_runs, op.level_meta):
        assert runs != ((0, 0, ext[0]),), "degenerated to full all-gather"


def test_support_planner_is_surface_proportional():
    """Host-only: at production-like size the planned exchange volume is a
    small (and shrinking) fraction of the operator — per-device traffic
    ~ O(surface), not O(M) (VERDICT r3 missing #3, notes.tex:332)."""
    from lanczos_tpu.models.lattice import build_lattice, find_neighbors
    from lanczos_tpu.ops.composite2 import build_composite_v2
    from lanczos_tpu.parallel.composite2 import _plan_support

    fracs = {}
    for n in (48, 96):
        bd = 3
        sp = np.full(bd**3, 2, dtype=np.int64)
        sp[bd**3 // 2] = 1
        lat = build_lattice(n, 25.0, bd, spacings=sp)
        nbrs, rels = find_neighbors(lat, 1)
        pp = lat.num_points
        weights = np.where(nbrs >= 0, -1.0, 0.0)
        deg = (nbrs >= 0).sum(axis=1).astype(np.float64)
        comp, _ = build_composite_v2(
            lat, nbrs, rels, weights, deg, scale=1.0, dtype=np.float64,
            interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
            min_grid_rows=4,
        )
        runs, stats = _plan_support(comp, degenerate_frac=10.0)
        fracs[n] = stats["run_volume"] / stats["total_volume"]
    assert fracs[96] < 0.5, fracs
    # halving the spacing-to-size ratio shrinks the exchanged fraction
    assert fracs[96] < 0.72 * fracs[48], fracs


def test_sharded_composite_v2_four_devices_matches(rng):
    """Sharded v2 (XLA tap path) on a 4-device mesh == the single-device
    operator."""
    from lanczos_tpu.models.lattice import build_lattice, find_neighbors
    from lanczos_tpu.ops.composite2 import build_composite_v2
    from lanczos_tpu.parallel import make_row_mesh
    from lanczos_tpu.parallel.composite2 import shard_composite_v2

    bd = 3
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    lat = build_lattice(24, 25.0, bd, spacings=sp)
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
    deg = keep.sum(axis=1).astype(np.float64)
    comp, idx_map = build_composite_v2(
        lat, np.where(keep, nbrs, -1), rels, np.where(keep, -1.0, 0.0),
        deg + 1.0, scale=1.0, dtype=np.float64,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=4,
    )
    assert len(comp.grid_meta) > 0
    op = shard_composite_v2(comp, make_row_mesh(4), degenerate_frac=10.0)
    host = op.host
    x = rng.standard_normal(comp.shape[0]) * np.asarray(comp.live)
    y_ref = np.asarray(comp.matvec(jnp.asarray(x)))
    y_sh = np.asarray(jax.jit(op.matvec)(jnp.asarray(host.to_sharded(x))))
    np.testing.assert_allclose(host.from_sharded(y_sh), y_ref, atol=1e-11)


@pytest.mark.slow
def test_sharded_composite_v2_matmat_matches(mesh, composite_v2_pair, rng):
    comp, _ = composite_v2_pair
    op = shard_operator(comp, mesh)
    host = op.host
    m = comp.shape[0]
    X = rng.standard_normal((m, 3))
    Xs = np.stack([host.to_sharded(X[:, j]) for j in range(3)], axis=1)
    Y_ref = np.asarray(comp.matmat(jnp.asarray(X)))
    Y_sh = np.asarray(jax.jit(op.matmat)(jnp.asarray(Xs)))
    for j in range(3):
        np.testing.assert_allclose(
            host.from_sharded(Y_sh[:, j]), Y_ref[:, j], atol=1e-11
        )


@pytest.mark.slow
def test_sharded_composite_v2_restarted_solve_matches(mesh, composite_v2_pair):
    """Thick-restart Lanczos over the sharded CompositeV2 == single-device
    (the actual north-star production pipeline's multi-chip form)."""
    from lanczos_tpu.solver.restart import eigsh_restarted

    comp, idx_map = composite_v2_pair
    op = shard_operator(comp, mesh)
    host = op.host
    m = comp.shape[0]
    rng_ = np.random.default_rng(5)
    v0 = rng_.standard_normal(m) * np.asarray(comp.live)
    v0 /= np.linalg.norm(v0)
    res_1 = eigsh_restarted(
        comp, k=4, tol=1e-9, max_cycles=80, dtype="float64",
        v0=jnp.asarray(v0),
    )
    res_s = eigsh_restarted(
        op, k=4, tol=1e-9, max_cycles=80, dtype="float64",
        v0=jnp.asarray(host.to_sharded(v0)),
    )
    np.testing.assert_allclose(
        np.asarray(res_s.eigenvalues), np.asarray(res_1.eigenvalues),
        rtol=1e-8, atol=1e-8,
    )
    assert float(np.max(np.asarray(res_s.residuals))) < 1e-8


@pytest.mark.parametrize("num_devices", [1, 2, 4, 8])
def test_sharded_stencil_local_matvec_matches(num_devices):
    """The sharded stencil's default local matvec (ring halo planes +
    local taps) == the global operator, on every device count that divides
    the grid."""
    from jax.sharding import PartitionSpec as P

    from lanczos_tpu.parallel.distributed import _stencil_local_matvec

    n_grid = 16
    H = build_regular_hamiltonian(
        n_grid, 25.0, deuteron_potential_3d, stencil="27", dtype="float32"
    )
    m = H.shape[0]
    x = jax.random.uniform(jax.random.PRNGKey(0), (m,), dtype=jnp.float32)
    y_ref = np.asarray(H.matvec(x))

    mesh_d = make_row_mesh(num_devices)
    local_mv = _stencil_local_matvec(H, num_devices, "rows")
    mapped = jax.jit(
        jax.shard_map(
            local_mv, mesh=mesh_d,
            in_specs=(P(), P("rows"), P("rows")), out_specs=P("rows"),
            check_vma=False,
        )
    )
    y = np.asarray(mapped(H.weights, H.diag.reshape(-1), x))
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=2e-5)


def test_sharded_stencil_operator_matvec_matches(mesh):
    """shard_operator(StencilOperator) keeps the mesh, so its matvec runs the
    ring-halo shard_map and its result stays row-sharded."""
    H = build_regular_hamiltonian(
        16, 25.0, deuteron_potential_3d, stencil="27", dtype="float64"
    )
    Hs = shard_operator(H, mesh)
    assert Hs.mesh is mesh and Hs.axis_name == "rows"
    x = jax.random.normal(jax.random.PRNGKey(2), (H.shape[0],), jnp.float64)
    y = jax.jit(lambda o, u: o.matvec(u))(Hs, x)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(H.matvec(x)), rtol=1e-12, atol=1e-10
    )
    X = jnp.stack([x, 2 * x], axis=1)
    np.testing.assert_allclose(
        np.asarray(Hs.matmat(X)), np.asarray(H.matmat(X)),
        rtol=1e-12, atol=1e-10,
    )


@pytest.mark.slow
def test_sharded_eigsh_restarted_matches(mesh):
    """Thick-restart Lanczos on a row-sharded SYMMETRIC operator ==
    single-device (the north-star engine's multi-chip form, SURVEY §7.8).
    The regular stencil Hamiltonian is exactly symmetric; the sharded run
    partitions the basis/vectors over the mesh under GSPMD."""
    import lanczos_tpu as lt
    from lanczos_tpu.solver.restart import eigsh_restarted

    H = lt.build_regular_hamiltonian(
        16, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float64"
    )
    Hs = shard_operator(H, mesh)
    from jax.sharding import NamedSharding, PartitionSpec

    m = H.shape[0]
    v0 = np.random.default_rng(3).standard_normal(m)
    res_1 = eigsh_restarted(
        H, k=3, tol=1e-9, max_cycles=60, dtype="float64",
        v0=jnp.asarray(v0),
    )
    v0_s = jax.device_put(
        jnp.asarray(v0), NamedSharding(mesh, PartitionSpec("rows"))
    )
    res_s = eigsh_restarted(
        Hs, k=3, tol=1e-9, max_cycles=60, dtype="float64", v0=v0_s
    )
    np.testing.assert_allclose(
        np.asarray(res_s.eigenvalues), np.asarray(res_1.eigenvalues),
        rtol=1e-9, atol=1e-9,
    )
    assert float(np.max(np.asarray(res_s.residuals))) < 1e-8


def test_exchange_stats_models(mesh):
    """exchange_stats: the per-matvec inter-device exchange model for each
    sharded SpMV format — stencil ppermute planes, ELL all-gather,
    halo-compressed export table."""
    from lanczos_tpu.parallel import shard_ell_halo
    from lanczos_tpu.utils.metrics import exchange_stats

    H = build_regular_hamiltonian(
        32, 25.0, deuteron_potential_3d, stencil="27", dtype="float32"
    )
    n_dev = 8
    m = H.shape[0]
    st = exchange_stats(H, n_dev)
    # 2 halo planes of 32x32 per device, fp32
    assert st["per_device_recv_elements"] == 2 * 32 * 32
    assert st["per_device_recv_bytes"] == 2 * 32 * 32 * 4
    ell = H.to_ell()
    ag = exchange_stats(ell, n_dev)
    assert ag["per_device_recv_elements"] == m - m // n_dev
    hop = shard_ell_halo(ell, mesh)
    ha = exchange_stats(hop, n_dev)
    # the halo table is strictly thinner than the all-gather
    assert ha["per_device_recv_elements"] < ag["per_device_recv_elements"]
    assert 0 < ha["fraction_of_m"] < 1
