"""Native (C++) runtime components, loaded via ctypes.

The reference leans on scipy/cuSPARSE C code for its host-side sparse
machinery (SURVEY.md §2.3); this package provides the framework's own native
layer: the lattice graph-builder (neighbor search + mirror filter) and the
ELL packer.  The shared library is compiled lazily with g++ on first use
for the generic target of the host's architecture (no -march=native), and
cached next to the source keyed by the source hash and the host's machine
type and compiler, so a library built on another kind of host is never
loaded.  Every entry point has a pure-numpy fallback, so the framework works
(slower) without a toolchain.

Public surface:
    available()            -> bool: native engine present (compiles on demand)
    find_neighbors_native  -> drop-in backend for models.lattice.find_neighbors
    pack_ell_native        -> drop-in inner loop for ops.assemble.ell_from_coo
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "find_neighbors_native",
    "pack_ell_native",
    "reciprocal_mask_native",
]

_SRC = os.path.join(os.path.dirname(__file__), "neighbor_engine.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F64 = ctypes.POINTER(ctypes.c_double)


def _compiler_version() -> str:
    try:
        out = subprocess.run(
            ["g++", "--version"], check=True, capture_output=True, text=True,
            timeout=30,
        )
    except (subprocess.SubprocessError, OSError):
        return ""
    return out.stdout.splitlines()[0] if out.stdout else ""


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        src = f.read()
    host = f"{platform.system()}-{platform.machine()}-{_compiler_version()}"
    tag = hashlib.sha256(src + host.encode()).hexdigest()[:16]
    cache_dir = os.environ.get(
        "LANCZOS_NATIVE_CACHE", os.path.join(os.path.dirname(_SRC), "_build")
    )
    so_path = os.path.join(cache_dir, f"neighbor_engine_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache_dir, exist_ok=True)
        # Build into a temp file then atomically rename, so concurrent
        # processes never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache_dir)
        os.close(fd)
        cmd = [
            "g++", "-O3", "-std=c++17", "-fopenmp",
            "-shared", "-fPIC", _SRC, "-o", tmp,
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.count_neighbors.argtypes = [
        _I64, _I64, _I32, _I64,
        ctypes.c_int64, ctypes.c_int64,
        _I64, ctypes.c_int64, ctypes.c_int64,
        _I64,
    ]
    lib.count_neighbors.restype = None
    lib.fill_neighbors.argtypes = [
        _I64, _I64, _I32, _I64,
        ctypes.c_int64, ctypes.c_int64,
        _I64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64,
    ]
    lib.fill_neighbors.restype = None
    lib.pack_ell.argtypes = [
        _I64, _I64, _F64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32, _F64,
    ]
    lib.pack_ell.restype = None
    lib.reciprocal_mask.argtypes = [
        _I64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.reciprocal_mask.restype = None
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def available() -> bool:
    """True when the native engine can be (or has been) built and loaded."""
    return _lib() is not None


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def find_neighbors_native(
    lat, d: int, idx: Optional[np.ndarray] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native neighbor search; None when the engine is unavailable.

    Same contract as models.lattice.find_neighbors: (nbrs (Q, K) padded -1,
    rels (Q, K, 3)), K = the true max degree over the query.
    """
    lib = _lib()
    if lib is None or lat.occupancy is None:
        # The engine indexes a dense occupancy array; huge fine grids carry
        # only the sorted table (models.lattice.DENSE_OCCUPANCY_LIMIT).
        return None
    if idx is None:
        idx = np.arange(lat.num_points, dtype=np.int64)
    idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    occ = np.ascontiguousarray(lat.occupancy, dtype=np.int64)
    coords = np.ascontiguousarray(lat.coords, dtype=np.int64)
    bop = np.ascontiguousarray(lat.box_of_point, dtype=np.int32)
    spc = np.ascontiguousarray(lat.spacings, dtype=np.int64)
    nq = len(idx)

    counts = np.empty(nq, dtype=np.int64)
    args = (
        _ptr(occ, _I64), _ptr(coords, _I64), _ptr(bop, _I32), _ptr(spc, _I64),
        ctypes.c_int64(lat.n_fine), ctypes.c_int64(lat.box_depth),
        _ptr(idx, _I64), ctypes.c_int64(nq), ctypes.c_int64(d),
    )
    lib.count_neighbors(*args, _ptr(counts, _I64))
    k = int(counts.max()) if nq else 0

    nbrs = np.empty((nq, k), dtype=np.int64)
    rels = np.empty((nq, k, 3), dtype=np.int64)
    lib.fill_neighbors(
        *args, ctypes.c_int64(k), _ptr(nbrs, _I64), _ptr(rels, _I64)
    )
    return nbrs, rels


def reciprocal_mask_native(nbrs: np.ndarray) -> Optional[np.ndarray]:
    """keep[i, j] = True iff edge (i -> nbrs[i, j]) has its reverse edge.

    Native counterpart of the sort+searchsorted reciprocity pass of
    scripts/northstar.py (246 s -> seconds at 341M edges); None when the
    engine is unavailable.
    """
    lib = _lib()
    if lib is None:
        return None
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int64)
    p, k = nbrs.shape
    keep = np.empty((p, k), dtype=np.uint8)
    lib.reciprocal_mask(
        _ptr(nbrs, _I64), ctypes.c_int64(p), ctypes.c_int64(k),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)


def pack_ell_native(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, m: int, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native COO(row-sorted, deduped) -> padded ELL; None when unavailable."""
    lib = _lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    out_cols = np.empty((m, k), dtype=np.int32)
    out_vals = np.empty((m, k), dtype=np.float64)
    lib.pack_ell(
        _ptr(rows, _I64), _ptr(cols, _I64), _ptr(vals, _F64),
        ctypes.c_int64(len(rows)), ctypes.c_int64(m), ctypes.c_int64(k),
        _ptr(out_cols, _I32), _ptr(out_vals, _F64),
    )
    return out_cols, out_vals
