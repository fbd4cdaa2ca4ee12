"""Two-process distributed smoke test (SURVEY.md §2.2/§5.8).

The reference has no distributed story at all; this verifies the
jax.distributed wiring end-to-end with REAL separate processes on the CPU
backend: two workers join through a local coordinator, build one global
"rows" mesh spanning both, and reduce a row-sharded vector whose shards
live in different processes.  The same entry point
(parallel.mesh.initialize_distributed) wires several GPU hosts — only the
environment variables change.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from lanczos_tpu.parallel.mesh import ROWS, initialize_distributed, make_row_mesh

nproc = initialize_distributed()
assert nproc == 2, nproc
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

devs = jax.devices()
assert len(devs) == 2, devs  # global device list spans both processes
mesh = make_row_mesh()
pid = jax.process_index()
local = np.arange(8.0) + 8 * pid
arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(ROWS)), local, (16,)
)
s = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
print(f"RESULT {pid} {float(s)}", flush=True)
"""


_SOLVER_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from lanczos_tpu.parallel.mesh import ROWS, initialize_distributed, make_row_mesh

nproc = initialize_distributed()
assert nproc == 2, nproc
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import lanczos_tpu as lt
from lanczos_tpu.parallel import lanczos_sharded
from lanczos_tpu.ops.operators import StencilOperator

mesh = make_row_mesh()
pid = jax.process_index()

# Single-process oracle on this process's own device.
H = lt.build_regular_hamiltonian(
    16, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float64"
)
n = 25
m = H.shape[0]
rng = np.random.default_rng(42)
v0 = rng.standard_normal(m)
fac_ref = lt.lanczos(H, n, v0=jnp.asarray(v0), dtype="float64")
a_ref = np.asarray(fac_ref.alpha)
b_ref = np.asarray(fac_ref.beta)

# Cross-process run: operator arrays as GLOBAL jax.Arrays over the
# two-process mesh (weights replicated, diagonal and v0 row-sharded), the
# whole recurrence (psum dots + ppermute halos inside lax.scan) spanning
# the process boundary.
rep = NamedSharding(mesh, P())
row = NamedSharding(mesh, P(ROWS))
Hg = StencilOperator(
    weights=jax.device_put(np.asarray(H.weights), rep),
    diag=jax.device_put(np.asarray(H.diag).reshape(-1), row),
    grid_shape=H.grid_shape,
    offsets=H.offsets,
)
v0_g = jax.device_put(v0, row)
fac = lanczos_sharded(Hg, n, mesh, v0=v0_g, dtype="float64")
a = np.asarray(fac.alpha)
b = np.asarray(fac.beta)
np.testing.assert_allclose(a, a_ref, rtol=1e-9, atol=1e-9)
np.testing.assert_allclose(b, b_ref, rtol=1e-9, atol=1e-9)
print(f"SOLVED {pid} {a[0]:.12g} {b[0]:.12g}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.timeout(240)
def test_two_process_rows_mesh(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            REPO_ROOT=repo,
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        env.pop("XLA_FLAGS", None)  # no virtual device multiplication
        # Only the repository on the path: the workers import nothing else.
        env["PYTHONPATH"] = repo
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=210)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out
    # Each process reports the GLOBAL sum of the row-sharded vector.
    for pid, out in enumerate(outs):
        line = [l for l in out.splitlines() if l.startswith("RESULT")][-1]
        _, got_pid, val = line.split()
        assert int(got_pid) == pid
        assert float(val) == float(sum(range(16)))


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_two_process_lanczos_solver():
    """Full row-sharded Lanczos across a REAL process boundary: psum'd
    dots/Gram-Schmidt and ppermute halo exchange inside the jitted scan,
    alpha/beta asserted equal to the single-process factorization inside
    each worker (VERDICT r3 weak #5 / next #7)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            REPO_ROOT=repo,
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = repo
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _SOLVER_WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=270)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out
    lines = []
    for pid, out in enumerate(outs):
        line = [l for l in out.splitlines() if l.startswith("SOLVED")][-1]
        assert int(line.split()[1]) == pid
        lines.append(line.split()[2:])
    # both processes saw the identical (replicated) alpha/beta
    assert lines[0] == lines[1]
