"""Linear-operator abstractions for the Lanczos framework.

The reference code decouples its eigensolver from the matrix format through the
``H*v`` SpMV contract (see /root/reference/Python/Regular/Lanczos.py:19-22,116).
We preserve that decoupling point but make every operator a JAX pytree whose
``matvec`` is jit-traceable, so the whole Krylov recurrence compiles into one
XLA program.

Three operator families:

* :class:`DenseOperator` — small dense matrices (tests, 1D box problems).
* :class:`EllOperator` — padded ELLPACK sparse format, the static-shaped
  replacement for the reference's CSR (scipy / cupyx CSR at
  Regular/Lanczos.py:85-88): every row stores exactly K column indices and
  values, padded with zeros, so the SpMV is a static-shaped gather + multiply
  + row-sum — no data-dependent shapes.
* :class:`StencilOperator` — matrix-free application of a constant-coefficient
  stencil on a periodic regular grid plus a diagonal term.  This covers the
  reference's regular Hamiltonians (Regular/Hamiltonian.py:20-25 builds the
  same 7/27-point stencils as explicit CSR) without storing the matrix at
  all: ``y = sum_k w_k * roll(x, -off_k) + diag * x``, a bandwidth-bound
  elementwise program that XLA fuses.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "EllOperator",
    "StencilOperator",
    "as_operator",
]


class LinearOperator:
    """Protocol: a square linear operator with a jit-traceable matvec.

    Subclasses are registered as pytrees so they can be passed through
    ``jax.jit`` / ``shard_map`` boundaries as arguments.
    """

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self):
        raise NotImplementedError

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x for a vector x of shape (M,)."""
        raise NotImplementedError

    def rmatvec(self, x: jax.Array) -> jax.Array:
        """y = A.T @ x.  Needed by the two-sided (non-Hermitian) Lanczos."""
        raise NotImplementedError

    def matmat(self, X: jax.Array) -> jax.Array:
        """Y = A @ X for a block X of shape (M, b) — block-Lanczos SpMM path."""
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def __call__(self, x: jax.Array) -> jax.Array:
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    # Conveniences -----------------------------------------------------------
    def to_dense(self) -> jax.Array:
        m = self.shape[0]
        return self.matmat(jnp.eye(m, dtype=self.dtype))

    def to_scipy(self):
        """CSR copy for host-side oracle comparisons (tests only)."""
        import scipy.sparse

        return scipy.sparse.csr_matrix(np.asarray(self.to_dense()))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense symmetric-or-not matrix operator (small problems and tests)."""

    A: jax.Array

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def matvec(self, x):
        return self.A @ x

    def rmatvec(self, x):
        return self.A.T @ x

    def matmat(self, X):
        return self.A @ X

    def to_dense(self):
        return self.A


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllOperator(LinearOperator):
    """Padded ELLPACK sparse operator.

    ``cols[i, k]`` / ``vals[i, k]`` hold the k-th nonzero of row i; rows with
    fewer than K nonzeros are padded with ``cols = i`` (a harmless self
    reference) and ``vals = 0``.  The matvec is a static-shaped gather:

        y[i] = sum_k vals[i, k] * x[cols[i, k]]

    This replaces the reference's CSR SpMV (cuSPARSE via cupyx at
    Regular/Lanczos.py:88,116) with a format whose row access pattern is
    uniform — the static shape XLA wants.
    """

    cols: jax.Array  # (M, K) int32
    vals: jax.Array  # (M, K) float

    @property
    def shape(self):
        m = self.cols.shape[0]
        return (m, m)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz_padded(self) -> int:
        return self.cols.shape[0] * self.cols.shape[1]

    def matvec(self, x):
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def matmat(self, X):
        # (M, K, b) gather then contraction over K.
        return jnp.einsum("mk,mkb->mb", self.vals, X[self.cols])

    def rmatvec(self, x):
        # Scatter-add of vals[i,k] * x[i] into cols[i,k].
        m = self.cols.shape[0]
        contrib = (self.vals * x[:, None]).reshape(-1)
        idx = self.cols.reshape(-1)
        return jnp.zeros(m, dtype=self.vals.dtype).at[idx].add(contrib)

    def transpose(self) -> "EllOperator":
        """Materialize A.T as a new EllOperator (host-side; for two-sided Lanczos)."""
        from .assemble import ell_from_coo

        cols = np.asarray(self.cols)
        vals = np.asarray(self.vals)
        m, k = cols.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), k)
        flat_cols = cols.reshape(-1).astype(np.int64)
        flat_vals = vals.reshape(-1)
        mask = flat_vals != 0
        return ell_from_coo(
            flat_cols[mask], rows[mask], flat_vals[mask], m, dtype=vals.dtype
        )

    def to_scipy(self):
        import scipy.sparse

        cols = np.asarray(self.cols)
        vals = np.asarray(self.vals)
        m, k = cols.shape
        rows = np.repeat(np.arange(m), k)
        mat = scipy.sparse.coo_matrix(
            (vals.reshape(-1), (rows, cols.reshape(-1))), shape=(m, m)
        )
        mat.sum_duplicates()
        # Padding entries have val exactly 0 and vanish under eliminate_zeros.
        csr = mat.tocsr()
        csr.eliminate_zeros()
        return csr


def _normalize_offsets(offsets) -> Tuple[Tuple[int, ...], ...]:
    out = []
    for off in offsets:
        out.append(tuple(int(o) for o in np.atleast_1d(off)))
    return tuple(out)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilOperator(LinearOperator):
    """Matrix-free stencil + diagonal operator on a periodic regular grid.

    Represents ``A = S + diag(d)`` where S applies a constant stencil with
    periodic boundary conditions:

        (S x)[c] = sum_k weights[k] * x[(c + offsets[k]) mod N]

    matching the index convention of the reference's regular Hamiltonian
    (Regular/Hamiltonian.py:73-99: idx = x + y*N + z*N**2, periodic wrap), but
    applied matrix-free with ``jnp.roll`` so no sparse matrix is ever stored.

    ``grid_shape`` is ordered slowest-to-fastest axis, i.e. ``(Nz, Ny, Nx)``
    for 3D with x fastest — so ``x.reshape(grid_shape)`` is consistent with
    the flat index ``i = x + y*Nx + z*Nx*Ny``.  ``offsets[k]`` are per-axis
    displacements in the same (slow→fast) order.
    """

    weights: jax.Array  # (k,) stencil weights
    diag: Optional[jax.Array]  # (M,) diagonal or None
    grid_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    offsets: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    # For full {-1,0,1}^3 stencils whose weight depends only on the number of
    # nonzero offset components ("graded" stencils — the 27-point Laplacian
    # is one), the SpMV factorizes per axis into 8 rolls instead of 26;
    # ``graded`` holds the static weight ladder (w0, w1, w2, w3) when
    # detected (see make_stencil_operator).
    graded: Optional[Tuple[float, float, float, float]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def shape(self):
        m = int(np.prod(self.grid_shape))
        return (m, m)

    @property
    def dtype(self):
        return self.weights.dtype

    def _apply_stencil(self, xg: jax.Array) -> jax.Array:
        if self.graded is not None:
            return self._apply_stencil_graded(xg)
        axes = tuple(range(len(self.grid_shape)))
        y = jnp.zeros_like(xg)
        for k, off in enumerate(self.offsets):
            # y[c] += w_k x[c + off]  <=>  y += w_k * roll(x, -off)
            shifted = jnp.roll(xg, shift=tuple(-o for o in off), axis=axes)
            y = y + self.weights[k] * shifted
        return y

    def _apply_stencil_graded(self, xg: jax.Array) -> jax.Array:
        """Graded {-1,0,1}^3 stencils (e.g. the 27-pt Laplacian) in 8 rolls.

        With S_a = shift_+1 + shift_-1 along axis a, a graded stencil is
            y = w0 x + w1 (Sx+Sy+Sz) x + w2 (SxSy+SySz+SzSx) x + w3 SxSySz x
              = w0 x + w1 Sy x + w1 Sz x + w2 Sz Sy x + Sx C,
            C = w1 x + w2 Sy x + w2 Sz x + w3 Sz Sy x,
        which applies each S_a a few times instead of 26 separate rolls.
        """
        w0, w1, w2, w3 = self.graded

        def s(a, axis):
            return jnp.roll(a, 1, axis) + jnp.roll(a, -1, axis)

        sy = s(xg, 1)
        sz = s(xg, 0)
        szsy = s(sy, 0)
        c = w1 * xg + w2 * sy + w2 * sz + w3 * szsy
        return w0 * xg + w1 * sy + w1 * sz + w2 * szsy + s(c, 2)

    def matvec(self, x):
        in_shape = x.shape
        xg = x.reshape(self.grid_shape)
        y = self._apply_stencil(xg)
        if self.diag is not None:
            y = y + self.diag.reshape(self.grid_shape) * xg
        return y.reshape(in_shape)

    def rmatvec(self, x):
        # Transpose of a constant-coefficient periodic stencil is the stencil
        # with negated offsets; the diagonal is symmetric.  Graded stencils
        # are mirror-symmetric, so their transpose equals themselves.
        if self.graded is not None:
            return self.matvec(x)
        in_shape = x.shape
        xg = x.reshape(self.grid_shape)
        axes = tuple(range(len(self.grid_shape)))
        y = jnp.zeros_like(xg)
        for k, off in enumerate(self.offsets):
            shifted = jnp.roll(xg, shift=tuple(o for o in off), axis=axes)
            y = y + self.weights[k] * shifted
        if self.diag is not None:
            y = y + self.diag.reshape(self.grid_shape) * xg
        return y.reshape(in_shape)

    @property
    def is_symmetric_stencil(self) -> bool:
        """True when for every offset its negation appears with equal weight."""
        table = {off: float(w) for off, w in zip(self.offsets, np.asarray(self.weights))}
        for off, w in table.items():
            neg = tuple(-o for o in off)
            if abs(table.get(neg, 0.0) - w) > 1e-12:
                return False
        return True

    def to_ell(self) -> EllOperator:
        """Materialize as an EllOperator (sparse cross-checks and tests)."""
        from .assemble import stencil_to_ell

        return stencil_to_ell(self)


def _detect_graded(grid_shape, offsets, weights_np):
    """Return (w0, w1, w2, w3) if this is a full {-1,0,1}^3 stencil whose
    weight depends only on the count of nonzero offset components."""
    if len(grid_shape) != 3 or len(offsets) != 27:
        return None
    import itertools

    if set(offsets) != set(itertools.product((-1, 0, 1), repeat=3)):
        return None
    ladder = [None] * 4
    for off, w in zip(offsets, weights_np):
        nz = sum(o != 0 for o in off)
        if ladder[nz] is None:
            ladder[nz] = float(w)
        elif abs(ladder[nz] - float(w)) > 1e-14 * max(abs(float(w)), 1.0):
            return None
    return tuple(ladder)


def make_stencil_operator(
    grid_shape: Sequence[int],
    offsets,
    weights,
    diag=None,
    dtype=jnp.float32,
) -> StencilOperator:
    """Convenience constructor validating shapes and normalizing offsets."""
    offsets = _normalize_offsets(offsets)
    weights_np = np.asarray(weights, dtype=np.float64)
    weights = jnp.asarray(weights, dtype=dtype)
    if diag is not None:
        diag = jnp.asarray(diag, dtype=dtype).reshape(-1)
        assert diag.shape[0] == int(np.prod(grid_shape))
    assert len(offsets) == weights.shape[0]
    return StencilOperator(
        weights=weights,
        diag=diag,
        grid_shape=tuple(int(n) for n in grid_shape),
        offsets=offsets,
        graded=_detect_graded(grid_shape, offsets, weights_np),
    )


def as_operator(A) -> LinearOperator:
    """Coerce a dense array / scipy sparse matrix / operator to LinearOperator."""
    if isinstance(A, LinearOperator):
        return A
    try:
        import scipy.sparse

        if scipy.sparse.issparse(A):
            from .assemble import ell_from_scipy

            return ell_from_scipy(A)
    except ImportError:  # pragma: no cover
        pass
    return DenseOperator(jnp.asarray(A))
