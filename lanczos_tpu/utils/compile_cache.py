"""JAX's persistent compilation cache, kept at one fixed directory.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``, ``scripts/*``) call
:func:`enable_compile_cache` once, before their first compilation; importing
the package changes nothing.  The cache key includes the directory, so a
directory that moves never hits: ``JAX_COMPILATION_CACHE_DIR`` wins when it
is set, and otherwise the cache lives at ``.jax_cache/`` in the checkout
(listed in ``.gitignore``).
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
