"""Error-free-transform (double-word) reductions for fp32 Lanczos.

The reference runs everything in fp64 on CPU/GPU (e.g.
/root/reference/Python/Regular/Lanczos.py:75 ``dtype=np.float64``).  The
fp32 recurrence halves the basis memory and bandwidth, but its plain dot
products over
M ~ 10^6..10^7 elements carry ~log2(M)*eps ≈ 1e-6 relative rounding, putting a
~3e-5 floor on achievable Ritz residuals.  This module restores fp64-class
*reduction* accuracy at fp32 storage/bandwidth cost using classical
error-free transformations (Ogita, Rump & Oishi, "Accurate Sum and Dot
Product", SISC 2005; Dekker 1971 splitting — no FMA required, so the result
is exact on any IEEE backend):

* ``two_sum`` / ``two_prod`` — exact a+b = s+e and a*b = p+e decompositions.
* ``dd_sum_tree`` — vectorized binary-tree reduction in double-word (hi, lo)
  arithmetic: each level is one elementwise pass over a halving array, so the
  whole reduction is ~2 extra memory passes and stays bandwidth-bound.
* ``dot2`` / ``norm2`` — correctly-rounded-to-working-precision dot products
  and norms, returned as (hi, lo) pairs whose sum carries ~2^-48 relative
  error in fp32 — the alpha/beta entries of the Lanczos tridiagonal can then
  be consumed in fp64 on the host for the (tiny) tridiagonal eigensolve.

Everything is elementwise work — no matmuls — and safe under jit/scan.
XLA does not apply unsafe floating-point reassociation by default, which the
transformations rely on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "two_sum",
    "quick_two_sum",
    "two_prod",
    "dd_add",
    "dd_sum_tree",
    "dot2",
    "norm2",
    "dot2_rounded",
]


def _bar(*xs):
    """Optimization barrier around error-free-transform intermediates.

    XLA:CPU's expression-level simplifier rewrites patterns like
    ``(a + b) - a`` across fused producer/consumer chains, silently
    destroying the EFT cancellation (measured: a jitted dd residual chain
    degraded from 1e-14 to 2e-8 on CPU; XLA:GPU preserves it).
    Barriers pin the evaluation order at each primitive boundary at
    negligible cost — these ops are bandwidth-bound either way.
    """
    out = jax.lax.optimization_barrier(xs)
    return out if len(xs) > 1 else out[0]


def two_sum(a, b):
    """Knuth's branch-free exact addition: a + b = s + e, exactly."""
    s = _bar(a + b)
    bp = _bar(s - a)
    t = _bar(s - bp)
    e = _bar(a - t) + _bar(b - bp)
    return s, e


def quick_two_sum(a, b):
    """Exact addition assuming |a| >= |b| (3 flops)."""
    s = _bar(a + b)
    e = b - _bar(s - a)
    return s, e


def _splitter(dtype):
    # 2^ceil(p/2) + 1 with p the significand width: fp32 p=24 -> 2^12+1,
    # fp64 p=53 -> 2^27+1 (Dekker 1971).
    p = np.finfo(np.dtype(dtype)).nmant + 1
    return float(2 ** ((p + 1) // 2) + 1)


def two_prod(a, b):
    """Dekker's exact multiplication: a * b = p + e, exactly (17 flops, no FMA)."""
    c = jnp.asarray(_splitter(a.dtype), a.dtype)
    p = _bar(a * b)
    a_big = _bar(c * a)
    a_hi = _bar(a_big - (a_big - a))
    a_lo = a - a_hi
    b_big = _bar(c * b)
    b_hi = _bar(b_big - (b_big - b))
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def dd_add(a_hi, a_lo, b_hi, b_lo):
    """Double-word + double-word addition, ACCURATE variant (AccurateDWPlusDW,
    Joldes, Muller & Popescu 2017, Algorithm 6): both the hi and lo pairs go
    through exact two_sum before renormalization, so the low-order word
    survives even under heavy hi-word cancellation at a tree node (the sloppy
    variant — a single two_sum with the lo parts added in plain fp — loses it
    there, weakening the worst-case bound)."""
    s, e = two_sum(a_hi, b_hi)
    t, f = two_sum(a_lo, b_lo)
    c = e + t
    v, w = quick_two_sum(s, c)
    z = w + f
    return quick_two_sum(v, z)


def dd_sum_tree(hi, lo):
    """Sum a vector of double-word numbers by a vectorized binary tree.

    Each level pairs the first and second halves with one double-word add —
    fully elementwise, log2(n) unrolled levels, total traffic ~2x the input.
    Returns scalars (hi, lo).
    """
    n = hi.shape[0]
    while n > 1:
        half = (n + 1) // 2
        pad = 2 * half - n
        if pad:
            z = jnp.zeros((pad,), hi.dtype)
            hi = jnp.concatenate([hi, z])
            lo = jnp.concatenate([lo, z])
        hi, lo = dd_add(hi[:half], lo[:half], hi[half:], lo[half:])
        n = half
    return hi[0], lo[0]


def dot2(a, b):
    """Correctly-rounded dot product: returns (hi, lo) with a.b = hi + lo + O(eps^2).

    Ogita-Rump-Oishi Dot2: elementwise exact products, then a double-word
    reduction of (product, product-error) pairs.  Relative error ~ n * eps^2 —
    i.e. fp64-class accuracy for fp32 inputs at any realistic n.
    """
    a = a.reshape(-1)
    b = b.reshape(-1)
    p, e = two_prod(a, b)
    return dd_sum_tree(p, e)


def dot2_rounded(a, b):
    """Dot2 rounded back to the working dtype (drop-in for jnp.dot on vectors)."""
    hi, lo = dot2(a, b)
    return hi + lo


def norm2(x):
    """Correctly-rounded 2-norm of x as a double-word (hi, lo) pair.

    The sum of squares is computed with Dot2; the square root is one
    double-word Newton step around the fp32 sqrt, preserving ~eps^2 accuracy.
    """
    s_hi, s_lo = dot2(x, x)
    r = jnp.sqrt(s_hi)
    safe = r > 0
    r_ = jnp.where(safe, r, 1.0)
    # Newton: sqrt(s) ≈ r + (s - r^2) / (2r), with s - r^2 in double-word.
    rr_hi, rr_e = two_prod(r_, r_)
    d_hi, d_lo = dd_add(s_hi, s_lo, -rr_hi, -rr_e)
    corr = (d_hi + d_lo) / (2.0 * r_)
    hi, lo = quick_two_sum(r_, corr)
    return jnp.where(safe, hi, 0.0), jnp.where(safe, lo, 0.0)
