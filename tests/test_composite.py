"""CompositeOperator (stencil-form irregular SpMV) vs the padded-ELL oracle.

The composite multi-level operator must be numerically identical (fp64) to
the EllOperator assembled from the same lattice, for both matvec and
rmatvec, and its spectrum must match through the two-sided solver.
"""

import numpy as np
import pytest

import lanczos_tpu as lt
from lanczos_tpu.models.lattice import build_lattice


def _mixed_lattice(n=24, bd=3):
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    return build_lattice(n, 25.0, bd, spacings=sp)


@pytest.fixture(scope="module")
def ops():
    lat = _mixed_lattice()
    ell = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, dtype=np.float64
    )
    comp, perm = lt.assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype=np.float64
    )
    return lat, ell, comp, perm


def test_matvec_matches_ell(ops):
    import jax.numpy as jnp

    lat, ell, comp, perm = ops
    rng = np.random.default_rng(0)
    x = rng.normal(size=lat.num_points)
    y_ell = np.asarray(ell.matvec(jnp.asarray(x)))
    # Composite works in level-major order: permute in, un-permute out.
    y_comp = np.empty_like(y_ell)
    y_comp[perm] = np.asarray(comp.matvec(jnp.asarray(x[perm])))
    np.testing.assert_allclose(y_comp, y_ell, atol=1e-9, rtol=1e-9)


def test_rmatvec_matches_ell(ops):
    import jax.numpy as jnp

    lat, ell, comp, perm = ops
    rng = np.random.default_rng(1)
    x = rng.normal(size=lat.num_points)
    y_ell = np.asarray(ell.rmatvec(jnp.asarray(x)))
    y_comp = np.empty_like(y_ell)
    y_comp[perm] = np.asarray(comp.rmatvec(jnp.asarray(x[perm])))
    np.testing.assert_allclose(y_comp, y_ell, atol=1e-9, rtol=1e-9)


def test_interface_fraction_is_small(ops):
    lat, ell, comp, perm = ops
    frac = comp.ifc_rows.shape[0] / lat.num_points
    assert 0 < frac < 0.5  # edge fraction; notes.tex:332 quantifies 7-14%


def test_two_sided_spectrum_matches(ops):
    lat, ell, comp, perm = ops
    n = 150
    fac_e = lt.two_sided_lanczos(ell, n, op_transpose=ell.transpose(), dtype=np.float64)
    vals_e, _ = lt.two_sided_eigs(fac_e)
    # Composite provides rmatvec directly, no transpose materialization.
    fac_c = lt.two_sided_lanczos(comp, n, dtype=np.float64)
    vals_c, _ = lt.two_sided_eigs(fac_c)
    lo_e = np.sort(np.real(np.asarray(vals_e)))[:4]
    lo_c = np.sort(np.real(np.asarray(vals_c)))[:4]
    np.testing.assert_allclose(lo_c, lo_e, atol=1e-6, rtol=1e-6)
