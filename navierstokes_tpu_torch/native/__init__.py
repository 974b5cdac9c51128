"""Native (C++) host-side mesh kernels, loaded with ctypes (counterpart of
``navierstokes_tpu/native/__init__.py``).

``fastmesh.cpp`` holds the setup-time topology kernels: the row
deduplication of facet and edge extraction (``unique_rows``) and the ELL
transpose tables of the cell-loop operators (``build_transpose``).

The library is compiled at first use with ``$CXX`` (default ``g++``,
``-O3 -shared -fPIC -std=c++17``) into ``navierstokes_tpu_torch/_build/``;
the file name carries a hash of the source, the compiler and the flags,
so an edited source rebuilds.  Nothing is built at import time.  A failed
build raises ``RuntimeError`` with the compiler's output: there is no
silent fallback.  ``NS_TPU_NO_NATIVE=1`` (the JAX package's variable)
selects the NumPy versions, which stay in the package as the plain
versions: ``mesh/core.py::unique_rows`` and
``parallel/sharded.py::_numpy_scatter_transpose``.  Both give the same
arrays as the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fastmesh.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the build of the current source, compiler and flags goes."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_compiler(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libns_fastmesh_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``fastmesh.cpp`` unless this source was built already.

    The compiler writes a file of its own, which is then renamed into
    place, so processes that build at once never load a half-written
    library.  Raises ``RuntimeError`` with the compiler's output on
    failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    hint = ("set NS_TPU_NO_NATIVE=1 to use the NumPy versions instead")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} could not run ({exc}); "
                           f"{hint}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}\n{hint}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    LL = ctypes.c_longlong
    lib.unique_rows_i32.restype = LL
    lib.unique_rows_i32.argtypes = [i32p, LL, ctypes.c_int, i32p, i64p,
                                    i64p]
    lib.build_transpose_i32.restype = LL
    lib.build_transpose_i32.argtypes = [i32p, LL, LL, LL, i32p]
    return lib


def get_library():
    """The loaded library (built first if needed), or None when
    ``NS_TPU_NO_NATIVE=1`` selects the NumPy versions."""
    if os.environ.get("NS_TPU_NO_NATIVE", "") == "1":
        return None
    return _load(str(build_library()))


def _i32ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def unique_rows(rows: np.ndarray):
    """``np.unique(rows, axis=0, return_inverse=True, return_counts=True)``
    of an (n, w) int array: the unique rows (int32) in lexicographic
    order, the inverse map and the counts (int64)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[1] < 1:
        raise ValueError(f"rows must be (n, w >= 1), got {rows.shape}")
    n, w = rows.shape
    lib = get_library()
    if lib is None:
        from navierstokes_tpu_torch.mesh.core import \
            unique_rows as numpy_unique_rows

        return numpy_unique_rows(rows)
    out_unique = np.empty_like(rows)
    out_inverse = np.empty(n, dtype=np.int64)
    out_counts = np.empty(n, dtype=np.int64)
    n_unique = lib.unique_rows_i32(_i32ptr(rows), n, w, _i32ptr(out_unique),
                                   _i64ptr(out_inverse),
                                   _i64ptr(out_counts))
    return (out_unique[:n_unique].copy(), out_inverse,
            out_counts[:n_unique].copy())


def build_transpose(flat_nodes: np.ndarray, n_nodes: int, k_pad=None):
    """ELL transpose table of a flat node list: ``(table (n_nodes, K)
    int32, K)``, row ``i`` the flat slots holding node ``i`` in increasing
    order, padded with ``len(flat_nodes)``; the semantics of
    ``parallel.sharded.build_scatter_transpose``."""
    flat_nodes = np.ascontiguousarray(flat_nodes, dtype=np.int32).ravel()
    n_flat = len(flat_nodes)
    lib = get_library()
    if lib is None:
        from navierstokes_tpu_torch.parallel.sharded import \
            _numpy_scatter_transpose

        return _numpy_scatter_transpose(flat_nodes, n_nodes, k_pad)
    if n_flat and (int(flat_nodes.min()) < 0
                   or int(flat_nodes.max()) >= n_nodes):
        raise ValueError(f"flat_nodes must lie in [0, {n_nodes})")
    K = lib.build_transpose_i32(_i32ptr(flat_nodes), n_flat, n_nodes, 0,
                                None)
    if k_pad is not None:
        K = max(K, int(k_pad))
    K = max(K, 1)
    table = np.empty((n_nodes, K), dtype=np.int32)
    res = lib.build_transpose_i32(_i32ptr(flat_nodes), n_flat, n_nodes, K,
                                  _i32ptr(table))
    if res < 0:
        raise RuntimeError("build_transpose_i32: table narrower than the "
                           "largest valence")
    return table, int(K)
