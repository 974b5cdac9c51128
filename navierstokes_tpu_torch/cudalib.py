"""The library of the port's hand-written CUDA kernels.

Each kernel family is a source ``csrc/<family>.cu`` with a plain C
interface and a wrapper that declares and calls it
(``assembly/cuda_band.py``, ``assembly/cuda_amg.py``,
``structured/cuda_conv.py``, ``structured/cuda_modal.py``); device helpers
that several sources use are in ``csrc/common.cuh``.  This module owns what the families share:

* the build: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
  into one library under ``navierstokes_tpu_torch/_build/`` when a wrapper
  first meets a CUDA tensor, and loaded with ``ctypes``; the file name
  hashes every ``*.cu`` and ``*.cuh`` there and the flags, so an edit
  rebuilds.  A missing ``nvcc`` or a failed build raises;
* :func:`entry`, the launch plumbing and the operand checks that several
  families use;
* :data:`LAUNCHES`, the launches per family, incremented where a wrapper
  launches a kernel and nowhere else: the counter group
  ``"cuda_band.launches"`` of ``utils/monitor.py``.

A new family adds its ``.cu``, its wrapper and one key of :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from navierstokes_tpu_torch.utils import monitor

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_PER_BLOCK = 232_448  # the opt-in shared memory of one sm_90 block

LAUNCHES = monitor.counters("cuda_band.launches",
                            ("circulant_apply", "circulant_pcg", "amg_pcg",
                             "structured_convection", "spectral_modal"))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launched() -> dict:
    """The families that launched since the last reset, with their counts
    (those at zero left out)."""
    return {name: n for name, n in LAUNCHES.items() if n}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def sources() -> list[Path]:
    """Every source of the library: ``csrc/*.cu``."""
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    /usr/local/cuda); raises when neither exists."""
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for cand in (shutil.which("nvcc"), cuda_home / "bin" / "nvcc"):
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
        f"compiled from {CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the build of the current sources, headers and flags goes."""
    h = hashlib.sha256()
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libns_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile :func:`sources` unless these sources were built already.

    Returns ``(path, log)``; ``log`` holds nvcc's report (registers,
    shared memory, spills per kernel) or is empty when the build existed.
    """
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _find_nvcc()
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in srcs]
    # one nvcc per source, all at once (each takes 10-15 s), then the link
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    link = None
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    codes = [proc.returncode for proc in procs] + \
        [link.returncode if link is not None else None]
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed {codes}:\n" + "\n".join(logs))
    os.replace(tmp, out)
    return out, "".join(logs)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.ns_error_string.argtypes = [ctypes.c_int]
    lib.ns_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, dtype: torch.dtype, argtypes: tuple):
    """The entry point ``ns_<name>_<f32|f64>``, resolved once, taking
    ``argtypes`` and returning a CUDA error code."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(load_library(), f"ns_{name}_{suffix}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_error(err: int, what: str) -> None:
    """Raises on a library entry point's non-zero CUDA error code."""
    if err != 0:
        msg = load_library().ns_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` unless it is the current device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device) -> int:
    """The handle of ``device``'s current stream, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# operand checks shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _checked_offsets(offsets: tuple, n: int, cap: int):
    if not 1 <= len(offsets) <= cap:
        raise ValueError(f"{len(offsets)} offsets: the band kernels take "
                         f"1 to {cap}")
    if not all(0 <= o < n for o in offsets):
        raise ValueError(f"offsets must lie in [0, {n})")
    return offsets, (ctypes.c_int * len(offsets))(*offsets)


def check_offsets(offsets, n: int, cap: int):
    """``offsets`` of a circulant band of ``n`` rows, validated once per
    distinct band shape: 1 to ``cap`` of them, each in [0, n).  Returns
    ``(offsets, ctypes int array)`` for the kernels' parameters."""
    return _checked_offsets(tuple(int(o) for o in offsets), int(n), int(cap))


def check_index_range(K: int, n: int, batch: int) -> None:
    """The kernels index with 32-bit integers."""
    if n >= 1 << 30 or batch * n >= 1 << 31 or K * n >= 1 << 31:
        raise ValueError(f"band {K}x{n} on {batch} planes: the CUDA kernels "
                         "take N < 2^30, B*N < 2^31 and K*N < 2^31")


def check_tensors(named: dict, device, dtype) -> None:
    """Each of ``named``'s tensors is float32 or float64 of ``dtype``, on
    ``device`` and contiguous."""
    for name, t in named.items():
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take "
                            "float32 or float64")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype} differs from {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
