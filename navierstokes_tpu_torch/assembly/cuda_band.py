"""CUDA kernels for the CirculantBand matvec and the whole-solve PCG.

Counterpart of ``navierstokes_tpu/assembly/pallas_band.py``.  Four
functions:

* :func:`circulant_apply` / :func:`circulant_pcg` -- the wrappers.  On a
  CUDA tensor they launch the hand-written kernels of ``csrc/band.cu`` (or
  raise); on a CPU tensor they run the plain versions.  The tensor's
  device is the only thing that decides.
* :func:`circulant_apply_plain` / :func:`circulant_pcg_plain` -- the same
  semantics in plain torch.  The apply is a stack of rolled windows (the
  JAX ``stack`` lowering, ``fastop.py:192-201``); the PCG is ``_pcg`` with
  a fixed iteration count.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``navierstokes_tpu_torch/_build/`` the
first time a CUDA tensor reaches a wrapper (the file name carries a hash
of the source and flags, so an edited ``band.cu`` rebuilds), and loaded
with ``ctypes``.  A missing ``nvcc`` or a failed build raises.

``LAUNCHES`` counts kernel launches per wrapper; it is incremented where a
kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "band.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_OFFSETS = 96          # kMaxOffsets in band.cu (build_operator's cap)

LAUNCHES = {"circulant_apply": 0, "circulant_pcg": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    /usr/local/cuda); raises when neither exists."""
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for cand in (shutil.which("nvcc"), cuda_home / "bin" / "nvcc"):
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA band kernels are "
        f"compiled from {SOURCE} at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the build of the current source and flags goes."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libns_band_{h.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile ``band.cu`` unless this source was built already.

    Returns ``(path, log)``; ``log`` holds nvcc's report (registers,
    shared memory, spills per kernel) or is empty when the build existed.
    """
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its API."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ns_error_string.argtypes = [I]
    lib.ns_error_string.restype = ctypes.c_char_p
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"ns_circulant_apply_{suffix}")
        fn.argtypes = [P, P, I, P, P, LL, LL, P]
        fn.restype = I
        fn = getattr(lib, f"ns_circulant_pcg_grid_{suffix}")
        fn.argtypes = [LL, ctypes.POINTER(I)]
        fn.restype = I
        fn = getattr(lib, f"ns_circulant_pcg_{suffix}")
        fn.argtypes = [P, P, I, LL, LL, P, P, P, LL, P, LL, I, I,
                       P, P, P, P, P, I, P]
        fn.restype = I
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ns_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# validation shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

def _check_offsets(offsets, n: int) -> tuple:
    offsets = tuple(int(o) for o in offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets: the band kernels take "
                         f"1 to {MAX_OFFSETS}")
    if not all(0 <= o < n for o in offsets):
        raise ValueError(f"offsets must lie in [0, {n})")
    return offsets


def _check_tensors(named: dict, device, dtype) -> None:
    for name, t in named.items():
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {t.dtype}; the band kernels "
                            "take float32 or float64")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype} differs from {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _validate_apply(band, offsets, x):
    if band.ndim != 2:
        raise ValueError(f"band must be (K, N), got {tuple(band.shape)}")
    n = band.shape[1]
    offsets = _check_offsets(offsets, n)
    if band.shape[0] != len(offsets):
        raise ValueError(f"band has {band.shape[0]} rows for "
                         f"{len(offsets)} offsets")
    if x.ndim < 1 or x.shape[-1] != n:
        raise ValueError(f"x must be (..., {n}), got {tuple(x.shape)}")
    _check_tensors({"band": band, "x": x}, x.device, x.dtype)
    return offsets


# ---------------------------------------------------------------------------
# A. circulant_apply
# ---------------------------------------------------------------------------

def circulant_apply_plain(band, offsets, x):
    """y[..., i] = sum_k band[k, i] * x[..., (i + off_k) mod N] (torch)."""
    offsets = _validate_apply(band, offsets, x)
    n = band.shape[1]
    x2 = torch.cat([x, x], dim=-1)
    wins = torch.stack([x2[..., o:o + n] for o in offsets], dim=0)
    b = band.reshape((len(offsets),) + (1,) * (x.ndim - 1) + (n,))
    return (b * wins).sum(dim=0)


def circulant_apply(band, offsets, x):
    """y[..., i] = sum_k band[k, i] * x[..., (i + off_k) mod N].

    CUDA tensors launch ``circulant_apply_kernel``; CPU tensors take
    :func:`circulant_apply_plain`.
    """
    if not x.is_cuda:
        return circulant_apply_plain(band, offsets, x)
    offsets = _validate_apply(band, offsets, x)
    lib = load_library()
    n = band.shape[1]
    y = torch.empty_like(x)
    offs = _device_offsets(offsets, x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"ns_circulant_apply_{_suffix(x.dtype)}")(
            band.data_ptr(), offs.data_ptr(), len(offsets), x.data_ptr(),
            y.data_ptr(), n, x.numel() // n, _stream(x.device))
    _check(lib, err, "circulant_apply")
    LAUNCHES["circulant_apply"] += 1
    return y


# ---------------------------------------------------------------------------
# B. circulant_pcg
# ---------------------------------------------------------------------------

def _validate_pcg(band, offsets, b, x0, inv_diag, maskv, iters, meanfree):
    """Checks and normalises the PCG operands.

    Returns ``(offsets, batch, mask)`` with ``mask`` None for an unmasked
    solve (``maskv`` None or the scalar 1.0).
    """
    offsets = _validate_apply(band, offsets, b)
    n = band.shape[1]
    if b.ndim not in (1, 2):
        raise ValueError(f"b must be (N,) or (B, N), got {tuple(b.shape)}")
    batch = 1 if b.ndim == 1 else b.shape[0]
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    if tuple(inv_diag.shape) not in ((n,), tuple(b.shape)):
        raise ValueError(f"inv_diag must be ({n},) or {tuple(b.shape)}")
    if maskv is None or (not torch.is_tensor(maskv) and float(maskv) == 1.0):
        mask = None
    elif torch.is_tensor(maskv):
        if tuple(maskv.shape) not in ((n,), tuple(b.shape)):
            raise ValueError(f"maskv must be ({n},) or {tuple(b.shape)}")
        mask = maskv
    else:
        raise ValueError(f"a scalar maskv must be 1.0, got {maskv}")
    named = {"b": b, "x0": x0, "inv_diag": inv_diag}
    if mask is not None:
        named["maskv"] = mask
    _check_tensors(named, b.device, b.dtype)
    if int(iters) < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if meanfree and batch != 1:
        # the TPU kernel takes the mean over all planes jointly; the port
        # refuses that case instead of reproducing it
        raise ValueError("meanfree needs a single plane (B == 1), got "
                         f"B = {batch}")
    return offsets, batch, mask


def circulant_pcg_plain(band, offsets, b, x0, inv_diag, maskv, iters,
                        meanfree):
    """(x, r) after ``iters`` Jacobi-PCG steps, in plain torch.

    The system is A'v = m*A(m*v) + (1-m)*v (A' = A without a mask); the
    residual is projected as r <- m*r and, with ``meanfree``, made mean
    free.  Dot products run over all planes jointly.
    """
    from navierstokes_tpu_torch.solvers.planar_step import _pcg

    offsets, _, mask = _validate_pcg(band, offsets, b, x0, inv_diag, maskv,
                                     iters, meanfree)

    def A(v):
        return circulant_apply_plain(band, offsets, v)

    if mask is None:
        matvec = A
    else:
        def matvec(v):
            return mask * A(mask * v) + (1.0 - mask) * v

    project = None
    if mask is not None or meanfree:
        def project(r):
            if mask is not None:
                r = mask * r
            return r - r.mean() if meanfree else r

    return _pcg(matvec, b, x0, int(iters), inv_diag=inv_diag,
                project=project)


def circulant_pcg(band, offsets, b, x0, inv_diag, maskv, iters, meanfree):
    """(x, r) after ``iters`` Jacobi-PCG steps.

    CUDA tensors run the whole solve in one cooperative launch of
    ``circulant_pcg_kernel``; CPU tensors take :func:`circulant_pcg_plain`.
    """
    if not b.is_cuda:
        return circulant_pcg_plain(band, offsets, b, x0, inv_diag, maskv,
                                   iters, meanfree)
    offsets, batch, mask = _validate_pcg(band, offsets, b, x0, inv_diag,
                                         maskv, iters, meanfree)
    lib = load_library()
    sfx = _suffix(b.dtype)
    n = band.shape[1]
    total = b.numel()
    with torch.cuda.device(b.device):
        grid = ctypes.c_int(0)
        _check(lib, getattr(lib, f"ns_circulant_pcg_grid_{sfx}")(
            total, ctypes.byref(grid)), "circulant_pcg occupancy query")
        x = torch.empty_like(b)
        r = torch.empty_like(b)
        work = torch.empty((2,) + tuple(b.shape), dtype=b.dtype,
                           device=b.device)           # p, Ap
        partial = torch.empty(3 * grid.value, dtype=b.dtype, device=b.device)
        offs = _device_offsets(offsets, b.device)
        err = getattr(lib, f"ns_circulant_pcg_{sfx}")(
            band.data_ptr(), offs.data_ptr(), len(offsets), n, batch,
            b.data_ptr(), x0.data_ptr(), inv_diag.data_ptr(),
            0 if inv_diag.ndim == 1 else n,
            None if mask is None else mask.data_ptr(),
            0 if mask is None or mask.ndim == 1 else n,
            int(iters), int(bool(meanfree)), x.data_ptr(), r.data_ptr(),
            work[0].data_ptr(), work[1].data_ptr(), partial.data_ptr(),
            grid.value, _stream(b.device))
    _check(lib, err, "circulant_pcg")
    LAUNCHES["circulant_pcg"] += 1
    return x, r
