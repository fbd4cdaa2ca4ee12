"""Throughput measurement and profiling hooks.

Replaces the reference's tqdm bars and ad-hoc time.time() deltas
(SURVEY.md §5.1) with quantitative GB/s / nnz/s measurement and
jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import EllOperator, LinearOperator, StencilOperator

__all__ = [
    "MatvecStats",
    "benchmark_matvec",
    "exchange_stats",
    "profile_trace",
    "operator_nnz",
    "time_loop",
]


def exchange_stats(op, num_devices: int) -> dict:
    """Per-matvec interconnect exchange volume of a SHARDED operator.

    Returns a dict with per-device received element count, bytes, and the
    fraction of the operator dimension M — the quantity the reference's
    writeup bounds at 7-14% surface points for 40-point boxes
    (/root/reference/Writeup/notes.tex:332).  Covers every sharded SpMV
    format in ``lanczos_tpu.parallel``:

    * z-slab StencilOperator: 2*halo boundary planes via ppermute;
    * row-sharded EllOperator: tiled all-gather of x (M - M/D received);
    * EllHaloOperator: the (D, E) export table ((D-1)*E received);
    * ShardedCompositeV2: per-level halo planes + planned surface runs
      (delegates to its own ``exchange_elements``).
    """
    from ..parallel.distributed import EllHaloOperator as _Halo

    itemsize = np.dtype(op.dtype).itemsize
    m = int(op.shape[0])
    if isinstance(op, StencilOperator):
        halo = max(abs(off[0]) for off in op.offsets)
        planes = int(np.prod(op.grid_shape[1:]))
        recv = 2 * halo * planes
        kind = "stencil-zslab-ppermute"
    elif isinstance(op, _Halo):
        e = int(op.export_ids.shape[1])
        recv = (num_devices - 1) * e
        kind = "ell-halo-table"
    elif isinstance(op, EllOperator):
        recv = m - m // num_devices
        kind = "ell-allgather"
    elif hasattr(op, "exchange_elements") and callable(op.exchange_elements):
        ex = op.exchange_elements()
        recv = int(ex["total"])
        kind = "composite-v2-surface-runs"
    else:
        raise TypeError(f"no exchange model for {type(op).__name__}")
    return {
        "kind": kind,
        "per_device_recv_elements": int(recv),
        "per_device_recv_bytes": int(recv) * itemsize,
        "fraction_of_m": recv / m,
        "num_devices": int(num_devices),
        "operator_dim": m,
    }


def operator_nnz(op: LinearOperator) -> int:
    """Nonzero count of the operator (stencil taps count once per point)."""
    if isinstance(op, EllOperator):
        return int(np.count_nonzero(np.asarray(op.vals)))
    if isinstance(op, StencilOperator):
        m = op.shape[0]
        k = len(op.offsets)
        has_sep_diag = op.diag is not None and not any(
            not any(o) for o in op.offsets
        )
        return m * (k + (1 if has_sep_diag else 0))
    from ..ops.composite import CompositeOperator

    if isinstance(op, CompositeOperator):
        interior = sum(
            lv.nbox * lv.m**3 * 27 for lv in op.levels
        )  # stencil taps incl. center
        ifc = int(np.count_nonzero(np.asarray(op.ifc_vals)))
        return interior + ifc
    raise TypeError(type(op).__name__)


@dataclasses.dataclass
class MatvecStats:
    seconds_per_matvec: float
    effective_gbps: float
    nnz_per_s: float
    m: int
    nnz: int

    def __str__(self):
        return (
            f"SpMV: {self.seconds_per_matvec*1e3:.3f} ms, "
            f"{self.effective_gbps:.1f} GB/s effective, "
            f"{self.nnz_per_s/1e9:.2f} Gnnz/s (M={self.m}, nnz={self.nnz})"
        )


def time_loop(step, x, iters: int = 100, repeats: int = 5) -> dict:
    """Per-call time of ``step`` from a jitted fori_loop of ``iters`` calls.

    The loop is compiled and run once before timing; each repeat ends in
    ``block_until_ready``.  Returns the median, min and max seconds per call
    over ``repeats`` and ``n_samples``.
    """

    @jax.jit
    def loop(v):
        return jax.lax.fori_loop(0, iters, lambda _, u: step(u), v)

    loop(x).block_until_ready()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        loop(x).block_until_ready()
        samples.append((time.perf_counter() - t0) / iters)
    samples = np.asarray(samples)
    return {
        "median_s": float(np.median(samples)),
        "min_s": float(samples.min()),
        "max_s": float(samples.max()),
        "n_samples": int(len(samples)),
    }


def benchmark_matvec(op: LinearOperator, iters: int = 50) -> MatvecStats:
    """Time back-to-back SpMVs (see :func:`time_loop`).

    Effective bandwidth counts the minimum memory traffic of a matrix-free
    stencil apply (read x, write y, read diag); for ELL operators it counts
    the matrix stream too (cols + vals), the dominant term.
    """
    m = op.shape[0]
    dtype = op.dtype
    itemsize = jnp.dtype(dtype).itemsize
    scale = jnp.asarray(1e-2, dtype)
    x = jnp.ones(m, dtype=dtype) / np.sqrt(m)
    per = time_loop(lambda v: op.matvec(v) * scale, x, iters=iters)["median_s"]

    nnz = operator_nnz(op)
    if isinstance(op, EllOperator):
        k = op.cols.shape[1]
        bytes_per = m * k * (itemsize + 4) + 2 * m * itemsize
    else:
        bytes_per = 3 * m * itemsize
    return MatvecStats(
        seconds_per_matvec=per,
        effective_gbps=bytes_per / per / 1e9,
        nnz_per_s=nnz / per,
        m=m,
        nnz=nnz,
    )


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace around a block: view with tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
