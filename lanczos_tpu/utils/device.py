"""The device a measurement runs on, as JAX and nvidia-smi report it.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
:func:`require_gpu` first: a timing taken on any other backend is not a
device number, so they stop instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess

__all__ = ["card_name_and_power_limit", "device_info", "require_gpu"]


def device_info() -> dict:
    """Platform, kind and count of JAX's devices."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu(prog: str) -> dict:
    """``device_info()`` when JAX's first device is a GPU; else exit."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"{prog}: no GPU found (JAX's first device is {info['platform']!r})"
        )
    return info


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``, read by a child process
    that does not import JAX (one line per card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()
