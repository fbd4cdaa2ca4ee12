"""Double-word (hi+lo fp32) operator application — the 1e-8 residual path.

The reference reaches 1e-8-class eigenpair residuals trivially by running
everything in fp64 (/root/reference/Python/Regular/Lanczos.py:75).  With an
fp32 basis, fp32-stored eigenvectors hit a hard TRUE-residual floor
of ~2*eps_f32 ~ 2.4e-7 (measured at solve level, tests/test_compensated.py)
no matter how accurate the reductions are, because the vector itself cannot
represent the eigenvector any better.  This module provides the missing
piece: operator application on DOUBLE-WORD vectors x = x_hi + x_lo (two
fp32 arrays, ~2^-48 combined precision) with error-free tap products:

    y_hi + y_lo = A (x_hi + x_lo) + O(eps^2 ||A x||)

Every stencil tap / interface weight multiplies x_hi through Dekker's exact
two_prod and accumulates in double-word arithmetic (Joldes-Muller-Popescu
accurate dd addition, see ops.compensated); the x_lo contribution — already
~eps small — is applied in plain fp32 and folded in.  The result is a
residual computation r = A x - lam x whose own rounding error sits at
~1e-14 relative, far below the 1e-8 target, while every array op remains
fp32 elementwise work (bandwidth ~2x a plain SpMV
per pass; the refinement driver calls this once per outer iteration, so the
cost is negligible against the fp32 solve it polishes).

Supported operators: StencilOperator (roll path), CompositeV2 (region
stencils + strided interface classes + ELL fallback), DenseOperator and
EllOperator (tests / small problems).
"""

from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .compensated import dd_add, two_prod, two_sum
from .operators import DenseOperator, EllOperator, StencilOperator

__all__ = ["matvec_dd", "matmat_dd", "dd_split_scalar"]


def dd_split_scalar(v: float, dtype=jnp.float32):
    """Split a python/fp64 scalar into an (hi, lo) fp32 pair."""
    hi = np.asarray(v, dtype=np.dtype(dtype))
    lo = np.asarray(np.float64(v) - np.float64(hi), dtype=np.dtype(dtype))
    return jnp.asarray(hi), jnp.asarray(lo)


def _acc_tap(acc, w, x_shifted):
    """acc (+)= w * x_shifted with an exact product, in double-word.
    ``w`` may be a traced scalar (jit-safe)."""
    hi, lo = acc
    p, e = two_prod(jnp.asarray(w, x_shifted.dtype), x_shifted)
    if hi is None:
        return p, e
    return dd_add(hi, lo, p, e)


def _acc_plain(acc, v):
    """acc (+)= v (already ~eps-small: plain-rounded add into the dd pair)."""
    hi, lo = acc
    s, e = two_sum(hi, v)
    return s, lo + e


def _dd_tree_lastaxis(p, e):
    """Reduce (..., L) double-word pairs over the last axis by a vectorized
    binary tree: log2(L) dd_adds instead of L (keeps the XLA graph small —
    a serial loop over L ~ 1500 bucket lanes made CPU compiles hang)."""
    L = p.shape[-1]
    while L > 1:
        half = (L + 1) // 2
        pad = 2 * half - L
        if pad:
            z = jnp.zeros((*p.shape[:-1], pad), p.dtype)
            p = jnp.concatenate([p, z], axis=-1)
            e = jnp.concatenate([e, z], axis=-1)
        p, e = dd_add(p[..., :half], e[..., :half], p[..., half:], e[..., half:])
        L = half
    return p[..., 0], e[..., 0]


def _stencil_dd(op: StencilOperator, x_hi, x_lo):
    """Roll-path stencil in dd.  x arrives flat (M,); returns flat pair."""
    gs = op.grid_shape
    xg_hi = x_hi.reshape(gs)
    xg_lo = x_lo.reshape(gs)
    axes = tuple(range(len(gs)))
    acc = (None, None)
    lo_plain = None
    for k, off in enumerate(op.offsets):
        # Zero-weight taps (e.g. the centre slot of composite level
        # stencils) cost one harmless pass; skipping would need concrete
        # weights, which jit tracing forbids.
        sh = tuple(-o for o in off)
        acc = _acc_tap(acc, op.weights[k], jnp.roll(xg_hi, sh, axes))
        term = op.weights[k].astype(x_lo.dtype) * jnp.roll(xg_lo, sh, axes)
        lo_plain = term if lo_plain is None else lo_plain + term
    hi, lo = acc
    if hi is None:
        hi = jnp.zeros(gs, x_hi.dtype)
        lo = jnp.zeros(gs, x_hi.dtype)
    if lo_plain is not None:
        hi, lo = _acc_plain((hi, lo), lo_plain)
    if op.diag is not None:
        d = op.diag.reshape(gs)
        hi, lo = dd_add(hi, lo, *two_prod(d, xg_hi))
        hi, lo = _acc_plain((hi, lo), d * xg_lo)
    return hi.reshape(-1), lo.reshape(-1)


def _composite2_dd(op, x_hi, x_lo):
    from .composite2 import IFC_W

    x3h, x3l = [], []
    yh, yl = [], []
    for (a, gshape, start), lop in zip(op.level_meta, op.level_ops):
        vol = gshape[0] * gshape[1] * gshape[2]
        xh = jax.lax.slice(x_hi, (start,), (start + vol,))
        xl = jax.lax.slice(x_lo, (start,), (start + vol,))
        x3h.append(xh.reshape(gshape))
        x3l.append(xl.reshape(gshape))
        h, l = _stencil_dd(lop, xh, xl)
        k = jax.lax.slice(op.keep, (start,), (start + vol,))
        # keep is exactly 0/1: masking is exact in both words.
        yh.append((h * k).reshape(gshape))
        yl.append((l * k).reshape(gshape))
    for (row_level, out_start, interior, acc_shape, taps), w in zip(
        op.grid_meta, op.grid_w
    ):
        acc = (None, None)
        lo_plain = None
        for t, (src_level, start, limit, stride) in enumerate(taps):
            sh = jax.lax.slice(x3h[src_level], start, limit, stride)
            sl = jax.lax.slice(x3l[src_level], start, limit, stride)
            acc = _acc_tap(acc, w[t], sh)
            term = w[t].astype(sl.dtype) * sl
            lo_plain = term if lo_plain is None else lo_plain + term
        hi, lo = acc
        if lo_plain is not None:
            hi, lo = _acc_plain((hi, lo), lo_plain)
        cfg = [(0, 0, i) for i in interior]
        ph = jax.lax.pad(hi, jnp.zeros((), hi.dtype), cfg)
        pl = jax.lax.pad(lo, jnp.zeros((), lo.dtype), cfg)
        z0, y0, x0 = out_start
        pz, py, px = ph.shape
        # Interface rows were zeroed by keep, so this add is exact (no
        # double-word merge needed at disjoint positions).
        yh[row_level] = (
            yh[row_level].at[z0 : z0 + pz, y0 : y0 + py, x0 : x0 + px].add(ph)
        )
        yl[row_level] = (
            yl[row_level].at[z0 : z0 + pz, y0 : y0 + py, x0 : x0 + px].add(pl)
        )
    hi = jnp.concatenate([v.reshape(-1) for v in yh])
    lo = jnp.concatenate([v.reshape(-1) for v in yl])
    # diagonal
    hi, lo = dd_add(hi, lo, *two_prod(op.diag, x_hi))
    hi, lo = _acc_plain((hi, lo), op.diag * x_lo)
    if op.ifc_buckets:
        m = op.diag.shape[0]
        pad = (-m) % IFC_W
        xph = jnp.pad(x_hi, (0, pad)) if pad else x_hi
        xpl = jnp.pad(x_lo, (0, pad)) if pad else x_lo
        xbh = xph.reshape(-1, IFC_W)
        xbl = xpl.reshape(-1, IFC_W)
        for rows, blk_ids, blk_w in op.ifc_buckets:
            gh = xbh[blk_ids]  # (R, B, W)
            gl = xbl[blk_ids]
            p, e = two_prod(blk_w, gh)
            # dd tree over the (B, W) axes, vectorized per row.
            ah, al = _dd_tree_lastaxis(
                p.reshape(p.shape[0], -1), e.reshape(p.shape[0], -1)
            )
            contrib_lo = jnp.sum(blk_w * gl, axis=(1, 2))
            ch, cl = two_sum(ah, contrib_lo)
            cl = cl + al
            # Error-free merge into (hi, lo) at these rows: a plain .add
            # would re-round against the O(1) diagonal term already there.
            nh, nl = dd_add(hi[rows], lo[rows], ch, cl)
            hi = hi.at[rows].set(nh)
            lo = lo.at[rows].set(nl)
    return hi, lo


def _dense_dd(op: DenseOperator, x_hi, x_lo):
    p, e = two_prod(op.A, x_hi[None, :])
    hi, lo = _dd_tree_lastaxis(p, e)
    return _acc_plain((hi, lo), op.A @ x_lo)


def _ell_dd(op: EllOperator, x_hi, x_lo):
    g_hi = x_hi[op.cols]  # (M, K)
    g_lo = x_lo[op.cols]
    p, e = two_prod(op.vals, g_hi)
    hi, lo = _dd_tree_lastaxis(p, e)
    return _acc_plain((hi, lo), jnp.sum(op.vals * g_lo, axis=1))


def matvec_dd(op, x_hi: jax.Array, x_lo: jax.Array):
    """(y_hi, y_lo) = A (x_hi + x_lo) with error-free tap products."""
    from .composite2 import CompositeV2

    if isinstance(op, StencilOperator):
        return _stencil_dd(op, x_hi, x_lo)
    if isinstance(op, CompositeV2):
        return _composite2_dd(op, x_hi, x_lo)
    if isinstance(op, DenseOperator):
        return _dense_dd(op, x_hi, x_lo)
    if isinstance(op, EllOperator):
        return _ell_dd(op, x_hi, x_lo)
    raise NotImplementedError(f"matvec_dd: unsupported operator {type(op)}")


def matmat_dd(op, X_hi: jax.Array, X_lo: jax.Array):
    """Column-wise dd matmat: (Y_hi, Y_lo) for (M, k) blocks.

    On CPU the columns run EAGERLY (lax.map would compile its body, and the
    XLA:CPU backend contracts ``a*b + c`` into FMA across the error-free-
    transform boundaries — measured to break double-word accuracy; neither
    optimization_barrier nor --xla_allow_excess_precision stops it).
    XLA:GPU keeps the arithmetic exact (measured by chip_smoke.py's
    dd_compile_probe), so the GPU runs the compiled path.
    """
    if jax.default_backend() == "cpu":
        cols = [
            matvec_dd(op, X_hi[:, j], X_lo[:, j])
            for j in range(X_hi.shape[1])
        ]
        Yh = jnp.stack([c[0] for c in cols], axis=1)
        Yl = jnp.stack([c[1] for c in cols], axis=1)
        return Yh, Yl

    def one(cols):
        return matvec_dd(op, cols[0], cols[1])

    Yh, Yl = jax.lax.map(one, (X_hi.T, X_lo.T))
    return Yh.T, Yl.T
