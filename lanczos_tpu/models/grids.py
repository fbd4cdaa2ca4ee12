"""Regular-grid geometry, Laplacian stencils, and Hamiltonian assembly.

Matrix-free replacement for the reference's regular operator-assembly layer
(/root/reference/Python/Regular/Hamiltonian.py).  Where the reference builds
an explicit scipy CSR matrix point-by-point in an N^3 Python loop
(Hamiltonian.py:62-67), we represent H = -T + V as a matrix-free
StencilOperator: the Laplacian stencil applied with jnp.roll plus a diagonal
potential — zero assembly cost, zero matrix storage, and an SpMV that streams
x through device memory.

Stencil weights are golden values from the reference:
  7-point:  Hamiltonian.py:20-21  (center -6, faces 1)
  27-point: Hamiltonian.py:116-128 (center -44/3, face 1, edge 1/2,
            corner 1/3, all scaled by 3/13)
Index convention matches Hamiltonian.py:73-84: flat = x + y*N + z*N^2
(x fastest), periodic boundary conditions.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.assemble import ell_from_coo
from ..ops.operators import EllOperator, StencilOperator, make_stencil_operator
from .potentials import (
    DEUTERON_REDUCED_REST_ENERGY_MEV,
    kinetic_prefactor,
)

__all__ = [
    "laplacian_stencil",
    "RegularGrid",
    "build_regular_hamiltonian",
    "build_chain_hamiltonian_1d",
]


def laplacian_stencil(ndim: int, points: str = "auto"):
    """Return (offsets, weights) for the discrete Laplacian (unit spacing).

    points:
      "3"  (1D), "5" (2D), "7" (3D): the (2*ndim+1)-point second-order star.
      "27" (3D only): the reference's 27-point isotropic stencil
           (Hamiltonian.py:116-128).
      "auto": star stencil for the given ndim.
    """
    if points == "auto":
        points = str(2 * ndim + 1)

    if points in ("3", "5", "7"):
        assert int(points) == 2 * ndim + 1, (
            f"{points}-point stencil is for {(int(points) - 1) // 2}D, got ndim={ndim}"
        )
        offsets = [tuple([0] * ndim)]
        weights = [-2.0 * ndim]
        for ax in range(ndim):
            for s in (-1, 1):
                off = [0] * ndim
                off[ax] = s
                offsets.append(tuple(off))
                weights.append(1.0)
        return tuple(offsets), np.asarray(weights)

    if points == "27":
        assert ndim == 3, "27-point stencil is 3D"
        offsets = []
        weights = []
        for off in itertools.product((-1, 0, 1), repeat=3):
            nz = sum(o != 0 for o in off)
            if nz == 0:
                w = -44.0 / 3.0  # center (Hamiltonian.py:120)
            elif nz == 3:
                w = 1.0 / 3.0  # corner (Hamiltonian.py:122)
            elif nz > 1:
                w = 1.0 / 2.0  # edge (Hamiltonian.py:124)
            else:
                w = 1.0  # face (Hamiltonian.py:126)
            offsets.append(off)
            weights.append(w * 3.0 / 13.0)  # overall scale (Hamiltonian.py:127)
        return tuple(offsets), np.asarray(weights)

    raise ValueError(f"unknown stencil: {points!r}")


@dataclasses.dataclass(frozen=True)
class RegularGrid:
    """Uniform periodic grid on [-L/2, L/2]^d with N points per axis.

    Coordinates follow the reference: np.linspace(-L/2, L/2, N)
    (Hamiltonian.py:15-17), so dx = L/(N-1) along the coordinate array but
    the kinetic prefactor uses dx = L/N exactly as the reference does
    (Hamiltonian.py:13 "self.dx = float(L)/N") — both conventions are kept
    to reproduce its spectra bit-for-bit.
    """

    n: int
    length: float
    ndim: int = 3

    @property
    def num_points(self) -> int:
        return self.n**self.ndim

    @property
    def dx(self) -> float:
        # Reference convention (Hamiltonian.py:13)
        return float(self.length) / self.n

    @property
    def shape(self) -> Tuple[int, ...]:
        # slow -> fast: (Nz, Ny, Nx); flat index = x + y*N + z*N^2.
        return (self.n,) * self.ndim

    def axis_coords(self) -> np.ndarray:
        return np.linspace(-self.length / 2, self.length / 2, self.n)

    def coordinate_grids(self):
        """Meshgrid of physical coordinates, shaped like ``self.shape``
        (slow->fast axis order, x fastest)."""
        c = self.axis_coords()
        # shape axes are (z, y, x, ...) reversed: build fastest-last.
        grids = np.meshgrid(*([c] * self.ndim), indexing="ij")
        # grids[a] varies along axis a; we want axis -1 to be x (fastest).
        # With shape (N,)*ndim and flat = x + y*N + ..., axis -1 is x, axis -2
        # is y, ...  So coordinate array for x must vary along last axis:
        return tuple(grids[::-1])  # returns (x_grid, y_grid, z_grid, ...)


def build_regular_hamiltonian(
    n: int,
    length: float,
    potential: Optional[Callable] = None,
    *,
    ndim: int = 3,
    stencil: str = "auto",
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    t_factor: Optional[float] = None,
    dtype=jnp.float32,
) -> StencilOperator:
    """H = -T + V as a matrix-free StencilOperator.

    T = t_factor * Laplacian-stencil (t_factor defaults to the physical
    kinetic prefactor, 3Ddeuteron.py:69-71); V is the diagonal of
    ``potential`` evaluated at the grid coordinates (Hamiltonian.py:35-45).
    Pass ``potential=None`` for the pure (negated, scaled) Laplacian.
    """
    grid = RegularGrid(n=n, length=length, ndim=ndim)
    offsets, lap_weights = laplacian_stencil(ndim, stencil)
    if t_factor is None:
        t_factor = kinetic_prefactor(grid.dx, rest_energy)
    weights = -t_factor * lap_weights  # H = -T + V (3Ddeuteron.py:80)

    diag = None
    if potential is not None:
        coord_grids = tuple(
            np.asarray(g, dtype=np.dtype(dtype)) for g in grid.coordinate_grids()
        )
        # One jitted evaluation: eager jnp ops here would dispatch one device
        # program per arithmetic op.
        vgrid = jax.jit(lambda *cs: potential(*cs).reshape(-1))(*coord_grids)
        diag = jnp.asarray(vgrid, dtype=dtype)

    return make_stencil_operator(
        grid.shape, offsets, weights, diag=diag, dtype=dtype
    )


def build_chain_hamiltonian_1d(
    n: int,
    length: float,
    potential_values: Sequence[float],
    *,
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    t_factor: Optional[float] = None,
    dtype=jnp.float64,
) -> EllOperator:
    """The reference's exact non-periodic 1D radial Hamiltonian as ELL.

    Reproduces 1Ddeuteron.py:23-43 including its quirks, taken as golden
    behavior: end rows of T are [-1, 1] (Neumann-like), and the potential
    diagonal omits the last grid point (the loop at 1Ddeuteron.py:24 runs to
    N-1).
    """
    if t_factor is None:
        dx = float(length) / n
        t_factor = kinetic_prefactor(dx, rest_energy)
    v = np.asarray(potential_values, dtype=np.float64)
    assert v.shape[0] == n

    rows, cols, vals = [], [], []

    def add(r, c, x):
        rows.append(r)
        cols.append(c)
        vals.append(x)

    # -T part (H = -T + V, 1Ddeuteron.py:54)
    add(0, 0, 1 * t_factor)
    add(0, 1, -1 * t_factor)
    add(n - 1, n - 2, -1 * t_factor)
    add(n - 1, n - 1, 1 * t_factor)
    for i in range(1, n - 1):
        add(i, i - 1, -1 * t_factor)
        add(i, i, 2 * t_factor)
        add(i, i + 1, -1 * t_factor)
    # +V part, diagonal over first n-1 points (1Ddeuteron.py:24-26).
    for i in range(n - 1):
        add(i, i, v[i])

    return ell_from_coo(rows, cols, vals, n, dtype=dtype)
