"""Benchmark implementation: flagship SpMV (3D deuteron Hamiltonian, 27-point stencil).

Runs on a GPU only: on any other device it exits with an error instead of
timing the CPU.  Prints the device (JAX's platform, kind and count, and the
card's name and power limit from nvidia-smi), then ONE JSON line:
  metric       spmv_effective_bandwidth — effective device-memory traffic of
               the stencil SpMV (read x + write y + read diag = 12 B/point in
               fp32) on the reference's flagship problem size
               (N=160^3 = 4.096M points, ~110M stencil taps;
               /root/reference/Python/Regular/3Ddeuteron.py:63-65).
  vs_baseline  speedup in nnz/s over the reference's own compute path for
               this exact problem: scipy.sparse CSR SpMV on the host CPU
               (3Ddeuteron.py:95 runs use_cuda=False), measured here on the
               same matrix.

Timing: a jitted fori_loop of SpMVs, compiled and warmed first, each repeat
ending in block_until_ready (utils.metrics.time_loop); the median over the
repeats is reported with the spread.
"""

import json
import time

import numpy as np


def bench_gpu_spmv(n_grid=160, dtype="float32"):
    import jax.numpy as jnp

    import lanczos_tpu as lt
    from lanczos_tpu.utils.metrics import time_loop

    H = lt.build_regular_hamiltonian(
        n_grid, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=dtype
    )
    m = H.shape[0]
    # Scale instead of normalize: keeps the loop finite without adding a
    # reduction to it.
    scale = jnp.asarray(1e-2, dtype)
    x = jnp.ones(m, dtype=dtype) / np.sqrt(m)
    stats = time_loop(lambda v: H.matvec(v) * scale, x, iters=500, repeats=7)
    per_spmv = stats["median_s"]
    itemsize = jnp.dtype(dtype).itemsize
    bytes_per = 3 * m * itemsize  # read x, write y, read diag
    nnz_per = 27 * m  # stencil taps (diagonal merged into the center tap)
    return {
        "m": m,
        "spmv_s": per_spmv,
        "gbps": bytes_per / per_spmv / 1e9,
        "gbps_best": bytes_per / stats["min_s"] / 1e9,
        "gbps_worst": bytes_per / stats["max_s"] / 1e9,
        "n_samples": stats["n_samples"],
        "nnz_per_s": nnz_per / per_spmv,
    }


def bench_scipy_baseline(n_grid=160, iters=3, dtype="float64"):
    """The reference's compute path: scipy CSR SpMV of the same H on host CPU."""
    import scipy.sparse

    import lanczos_tpu as lt
    from lanczos_tpu.ops.assemble import stencil_to_ell

    H = lt.build_regular_hamiltonian(
        n_grid, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float32"
    )
    ell = stencil_to_ell(H)
    m = H.shape[0]
    k = ell.cols.shape[1]
    # Uniform rows: CSR arrays directly from ELL, no COO round-trip.
    indices = np.asarray(ell.cols).reshape(-1)
    data = np.asarray(ell.vals, dtype=dtype).reshape(-1)
    indptr = np.arange(m + 1, dtype=np.int64) * k
    csr = scipy.sparse.csr_matrix((data, indices, indptr), shape=(m, m))
    x = np.ones(m, dtype=dtype) / np.sqrt(m)
    csr @ x  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        y = csr @ x
    dt = (time.perf_counter() - t0) / iters
    return {"spmv_s": dt, "nnz_per_s": csr.nnz / dt}


def main():
    from lanczos_tpu.utils.compile_cache import enable_compile_cache
    from lanczos_tpu.utils.device import card_name_and_power_limit, require_gpu

    device = require_gpu("bench")
    card = card_name_and_power_limit()
    print(f"# device {device['kind']} x{device['count']} "
          f"({device['platform']}); nvidia-smi name, power.limit: {card}")
    enable_compile_cache()
    gpu = bench_gpu_spmv()
    ref = bench_scipy_baseline()
    vs = gpu["nnz_per_s"] / ref["nnz_per_s"]
    print(
        json.dumps(
            {
                "metric": "spmv_effective_bandwidth",
                "value": gpu["gbps"],
                "unit": "GB/s",
                "vs_baseline": vs,
                "device": device,
                "detail": {
                    "problem": "3D deuteron, 27pt stencil, N=160^3, fp32",
                    "card": card,
                    "statistic": "median over repeats",
                    "gbps_spread": [gpu["gbps_worst"], gpu["gbps_best"]],
                    "n_samples": gpu["n_samples"],
                    "spmv_time_s": gpu["spmv_s"],
                    "nnz_per_s": gpu["nnz_per_s"],
                    "baseline": "scipy CSR SpMV, host CPU (reference path)",
                    "baseline_spmv_time_s": ref["spmv_s"],
                },
            }
        )
    )


if __name__ == "__main__":
    main()
