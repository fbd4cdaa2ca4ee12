"""Device-mesh helpers for row-partitioned execution.

The reference is single-process/single-GPU (SURVEY.md §2.2); this module is
new capability: a 1D "rows" mesh over which the Krylov vectors and the
operator's rows are sharded.  The mesh follows the algorithm alone (the
cards of one host are joined all to all by NVLink); in tests it maps onto 8
virtual CPU devices.

Multi-host (SURVEY.md §2.2/§5.8): :func:`initialize_distributed` wires
``jax.distributed`` so every process sees the GLOBAL device list, and
:func:`make_row_mesh` then builds the mesh over all of them.  Row
partitioning keeps each device's slice local; the recurrence's psum'd
dots/norms are NCCL all-reduces, and since the mesh is 1D the collective
layout needs no further tuning.  A two-process CPU
smoke test lives in tests/test_multihost.py (subprocess launch against a
local coordinator, the fake-backend mechanism the reference lacks).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np

__all__ = ["ROWS", "make_row_mesh", "initialize_distributed"]

#: Canonical axis name for the row-partitioned dimension.
ROWS = "rows"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> int:
    """Join a multi-process JAX job (no-op when single-process).

    Arguments default from the standard environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
    ``JAX_LOCAL_DEVICE_IDS``), so launchers only need to export those and
    call this once before any other jax API.  Returns the number of
    processes in the job.

    After initialization, ``jax.devices()`` is the GLOBAL device list and
    :func:`make_row_mesh` spans hosts transparently; per-host shards are
    addressable via the standard ``jax.Array`` machinery.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if local_device_ids is None:
        env = os.environ.get("JAX_LOCAL_DEVICE_IDS")
        local_device_ids = (
            [int(v) for v in env.split(",")] if env else None
        )
    if not coordinator_address and (not num_processes or num_processes <= 1):
        return 1  # fully unset: single-process mode
    if num_processes and num_processes > 1 and not coordinator_address:
        raise ValueError(
            f"JAX_NUM_PROCESSES={num_processes} but no coordinator address: "
            "a misconfigured multi-host launch would silently solve on one "
            "host's shard. Set JAX_COORDINATOR_ADDRESS (host:port)."
        )
    if coordinator_address and (not num_processes or num_processes <= 1):
        raise ValueError(
            "JAX_COORDINATOR_ADDRESS is set but JAX_NUM_PROCESSES is "
            f"{num_processes!r}: set both (>=2) for a multi-host launch or "
            "neither for single-process mode."
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return num_processes


def make_row_mesh(num_devices: Optional[int] = None, devices=None) -> jax.sharding.Mesh:
    """1D mesh over the first ``num_devices`` devices, axis name "rows".

    After :func:`initialize_distributed`, ``jax.devices()`` enumerates every
    process's devices, so the returned mesh spans hosts."""
    if devices is None:
        devices = jax.devices()
    if num_devices is None:
        num_devices = len(devices)
    devices = np.asarray(devices[:num_devices])
    return jax.sharding.Mesh(devices, (ROWS,))
