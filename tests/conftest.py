"""Test configuration: CPU backend with 8 virtual devices, fp64 enabled.

The reference has no test harness at all (SURVEY.md §4); this suite runs the
whole framework on the JAX CPU backend with a virtual 8-device mesh so that
single-device numerics AND multi-device sharding are exercised on any
machine — the fake-backend mechanism the reference lacks.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them unless JAX's first device is a GPU.
They run on a machine with a card with

    LANCZOS_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu

which leaves JAX's default backend alone (and runs only the gpu tests).
"""

import os

ON_GPU = os.environ.get("LANCZOS_TESTS_ON_GPU") == "1"

if not ON_GPU:
    # Forced (not setdefault): the suite must run on the virtual CPU mesh
    # whatever the environment says.  NOTE: `import pytest` already imports
    # jax (via the jaxtyping pytest plugin), so env vars alone are too late —
    # use jax.config, which works until a backend is initialized.
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8, (
        "test suite requires the 8-device virtual CPU mesh; backend was "
        "initialized before conftest could configure it"
    )

import numpy as np
import pytest


@pytest.fixture()
def gpu_device():
    """JAX's first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with LANCZOS_TESTS_ON_GPU=1 "
                    "on a machine with a card)")
    return dev


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it.
    return np.random.default_rng(1234)


def random_sparse_symmetric(rng, m, density=0.05, dtype=np.float64):
    """Random symmetric sparse matrix with a well-spread spectrum."""
    import scipy.sparse

    a = scipy.sparse.random(
        m, m, density=density, random_state=np.random.RandomState(rng.integers(2**31)),
        dtype=dtype,
    )
    a = (a + a.T) * 0.5
    a = a + scipy.sparse.diags(np.linspace(-1.0, 1.0, m).astype(dtype))
    return a.tocsr()
