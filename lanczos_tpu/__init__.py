"""lanczos_tpu — a Lanczos eigensolver framework in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``jgslunde/Lanczos`` codebase (see SURVEY.md): sparse/matrix-free Hamiltonian
assembly on regular grids and irregular multi-resolution lattices, the
symmetric and two-sided Lanczos recurrences compiled as single XLA programs,
on-device tridiagonal eigensolves with Ritz back-transform, and row-sharded
multi-chip execution via jax.sharding meshes.
"""

from .ops.operators import (
    DenseOperator,
    EllOperator,
    LinearOperator,
    StencilOperator,
    as_operator,
)
from .ops.assemble import ell_from_coo, ell_from_scipy
from .solver.api import eigsh
from .solver.block import eigsh_block_restarted
from .solver.restart import eigsh_restarted
from .solver.lanczos import LanczosFactorization, lanczos
from .solver.results import EigResult, match_eigs
from .solver.tridiag import (
    cullum_willoughby_mask,
    ritz_from_factorization,
    tridiag_eigh,
)
from .models.grids import (
    RegularGrid,
    build_chain_hamiltonian_1d,
    build_regular_hamiltonian,
    laplacian_stencil,
)
from .models.lattice import (
    IrregularLattice,
    build_lattice,
    potential_spacings,
)
from .models.irrlap import laplacian_weights
from .models.irr_hamiltonian import (
    assemble_irregular_hamiltonian,
    assemble_irregular_hamiltonian_composite,
    assemble_irregular_hamiltonian_composite2,
)
from .solver.two_sided import two_sided_eigs, two_sided_lanczos
from .solver.arnoldi import arnoldi, eigs_nonsym
from .solver.look_ahead import lookahead_eigs, two_sided_lanczos_lookahead
from .models.potentials import (
    DEUTERON_REDUCED_REST_ENERGY_MEV,
    HBAR_C_MEV_FM,
    deuteron_potential_3d,
    deuteron_potential_radial,
    kinetic_prefactor,
    square_well_1d,
)

__version__ = "0.1.0"
