"""Benchmark entry point: flagship SpMV on the GPU (exits on any other device).

Prints the device and ONE JSON line (see lanczos_tpu/utils/bench_impl.py for
details and the baseline definition)."""

from lanczos_tpu.utils.bench_impl import main

if __name__ == "__main__":
    main()
