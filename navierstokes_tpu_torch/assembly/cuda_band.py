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

The PCG has two kernels; :func:`pcg_plan`, a pure function of the shapes
and dtype, picks one: route ``"cluster"`` (A) keeps a system that fits in
one thread-block cluster's shared memory there for the whole solve, route
``"grid"`` (B) runs one cooperative grid of at most one CTA per SM.  A
launch that fails raises; the wrapper never tries the other route.

``LAUNCHES`` counts kernel launches per wrapper; it is incremented where a
kernel is launched and nowhere else.  It is the counter group
``"cuda_band.launches"`` of the tracing registry (``utils/monitor.py``).
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
from typing import NamedTuple

import torch

from navierstokes_tpu_torch.utils import monitor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "band.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_OFFSETS = 96          # kMaxOffsets in band.cu (build_operator's cap)
GRID_THREADS = 1024       # kGridThreads in band.cu (route B)
CLUSTER_THREADS = 512     # kClusterThreads in band.cu (route A, pinned)
CLUSTER_SIZE = 16         # route A: CTAs of the (non-portable) cluster
H100_SMS = 132            # route B: at most one CTA per SM
SMEM_PER_BLOCK = 232_448  # the opt-in shared memory of one sm_90 block
SMEM_STATIC = 8_192       # reserved for the PCG kernels' static arrays

LAUNCHES = monitor.counters("cuda_band.launches",
                            ("circulant_apply", "circulant_pcg"))


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
        fn = getattr(lib, f"ns_circulant_pcg_prepare_{suffix}")
        fn.argtypes = [I, I, I, I]
        fn.restype = I
        fn = getattr(lib, f"ns_circulant_pcg_{suffix}")
        fn.argtypes = [I, I, I, I, I, P, P, I, LL, LL, P, P, P, I, P, I, I,
                       I, P, P, P, P]
        fn.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, dtype: torch.dtype):
    """The ctypes function ``ns_<name>_<f32|f64>``, resolved once."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(load_library(), f"ns_{name}_{suffix}")


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().ns_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _on(device: torch.device):
    """``torch.cuda.device(device)`` unless it is the current device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# validation shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _checked_offsets(offsets: tuple, n: int):
    """``offsets`` validated against ``n``, once per distinct band shape:
    ``(offsets, ctypes int array)`` for the kernels' parameters."""
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets: the band kernels take "
                         f"1 to {MAX_OFFSETS}")
    if not all(0 <= o < n for o in offsets):
        raise ValueError(f"offsets must lie in [0, {n})")
    return offsets, (ctypes.c_int * len(offsets))(*offsets)


def _check_offsets(offsets, n: int):
    return _checked_offsets(tuple(int(o) for o in offsets), int(n))


def _check_index_range(K: int, n: int, batch: int) -> None:
    """The kernels index with 32-bit integers."""
    if n >= 1 << 30 or batch * n >= 1 << 31 or K * n >= 1 << 31:
        raise ValueError(f"band {K}x{n} on {batch} planes: the CUDA kernels "
                         "take N < 2^30, B*N < 2^31 and K*N < 2^31")


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
    offsets, offs_c = _check_offsets(offsets, n)
    if band.shape[0] != len(offsets):
        raise ValueError(f"band has {band.shape[0]} rows for "
                         f"{len(offsets)} offsets")
    if x.ndim < 1 or x.shape[-1] != n:
        raise ValueError(f"x must be (..., {n}), got {tuple(x.shape)}")
    _check_tensors({"band": band, "x": x}, x.device, x.dtype)
    return offsets, offs_c


# ---------------------------------------------------------------------------
# A. circulant_apply
# ---------------------------------------------------------------------------

def circulant_apply_plain(band, offsets, x):
    """y[..., i] = sum_k band[k, i] * x[..., (i + off_k) mod N] (torch)."""
    offsets, _ = _validate_apply(band, offsets, x)
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
    offsets, offs_c = _validate_apply(band, offsets, x)
    n = band.shape[1]
    batch = x.numel() // n
    _check_index_range(len(offsets), n, batch)
    fn = _kernel_fn("circulant_apply", x.dtype)
    y = torch.empty_like(x)
    with _on(x.device):
        err = fn(band.data_ptr(), offs_c, len(offsets), x.data_ptr(),
                 y.data_ptr(), n, batch, _stream(x.device))
    _check(err, "circulant_apply")
    LAUNCHES["circulant_apply"] += 1
    return y


# ---------------------------------------------------------------------------
# B. circulant_pcg
# ---------------------------------------------------------------------------

class PcgPlan(NamedTuple):
    """How :func:`circulant_pcg` runs one solve on the card."""
    route: str         # "cluster" (route A) or "grid" (route B)
    ctas: int          # CTAs of the cluster or of the cooperative grid
    smem_bytes: int    # dynamic shared memory per CTA
    rows: int          # rows of N owned by one CTA
    resident: bool     # the band slice sits in shared memory


_ROUTE_CODE = {"cluster": 0, "grid": 1}


@functools.lru_cache(maxsize=256)
def pcg_plan(n: int, K: int, batch: int, dtype: torch.dtype,
             has_mask: bool) -> PcgPlan:
    """The route, CTA count and shared memory of one PCG solve.

    Route A (``"cluster"``) when the band and the state of every row --
    the (z, p) pairs of two p buffers, x, r, Ap, the inverse diagonal and,
    masked, the mask, one of each per plane -- fit in the shared memory of
    a cluster of ``CLUSTER_SIZE`` CTAs, each owning a power-of-two row
    range (16 CTAs beat 8 on the 128^2 Poisson solve in f32 and f64: the
    matvec and item loops halve and the barrier costs about the same).  Otherwise route B (``"grid"``): one CTA of ``GRID_THREADS``
    threads per ``GRID_THREADS`` (plane, row) items, at most one per SM of
    an H100, each owning ``ceil(n / ctas)`` rows of every plane, with its
    band slice resident in shared memory when it fits and streamed from
    global memory when not.
    """
    esize = 4 if dtype == torch.float32 else 8
    budget = SMEM_PER_BLOCK - SMEM_STATIC
    vectors = 8 + bool(has_mask)
    rows = 1 << (-(-n // CLUSTER_SIZE) - 1).bit_length()
    smem = rows * (K + batch * vectors) * esize
    if smem <= budget:
        return PcgPlan("cluster", CLUSTER_SIZE, smem, rows, True)
    ctas = min(H100_SMS, -(-(batch * n) // GRID_THREADS))
    rows = -(-n // ctas)
    band = K * rows * esize
    resident = band <= budget
    return PcgPlan("grid", ctas, band if resident else 0, rows, resident)


@functools.lru_cache(maxsize=64)
def _prepared(plan: PcgPlan, dtype: torch.dtype, device: torch.device,
              masked: bool):
    """Opt the plan's kernel into its shared memory and check that its
    CTAs can be co-resident, once per plan and device; raises if not."""
    with _on(device):
        _check(_kernel_fn("circulant_pcg_prepare", dtype)(
            _ROUTE_CODE[plan.route], plan.ctas, plan.smem_bytes,
            int(masked)),
            f"circulant_pcg {plan.route} route ({plan.ctas} CTAs, "
            f"{plan.smem_bytes} B shared memory each)")
    return plan


@functools.lru_cache(maxsize=32)
def _grid_scratch(plan: PcgPlan, n: int, batch: int, dtype: torch.dtype,
                  device: torch.device, stream: int) -> torch.Tensor:
    """Route B's scratch ((z, p) pairs of two p buffers, Ap, three rows of
    block partials), allocated once per plan and reused by every solve on
    ``stream`` (the current stream when it is made)."""
    return torch.empty(5 * batch * n + 3 * plan.ctas, dtype=dtype,
                       device=device)


def _validate_pcg(band, offsets, b, x0, inv_diag, maskv, iters, meanfree):
    """Checks and normalises the PCG operands.

    Returns ``(offsets, batch, mask)`` with ``mask`` None for an unmasked
    solve (``maskv`` None or the scalar 1.0).
    """
    offsets, _ = _validate_apply(band, offsets, b)
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

    CUDA tensors run the whole solve in one launch of the kernel that
    :func:`pcg_plan` picks; CPU tensors take :func:`circulant_pcg_plain`.
    """
    if not b.is_cuda:
        return circulant_pcg_plain(band, offsets, b, x0, inv_diag, maskv,
                                   iters, meanfree)
    offsets, batch, mask = _validate_pcg(band, offsets, b, x0, inv_diag,
                                         maskv, iters, meanfree)
    _, offs_c = _check_offsets(offsets, band.shape[1])
    n, dtype, dev = band.shape[1], b.dtype, b.device
    _check_index_range(len(offsets), n, batch)
    masked = mask is not None
    plan = _prepared(pcg_plan(n, len(offsets), batch, dtype, masked), dtype,
                     dev, masked)
    with _on(dev):
        stream = _stream(dev)
        scratch = None
        if plan.route == "grid":
            if torch.cuda.is_current_stream_capturing():
                # a CUDA graph bakes the pointer in: take the scratch from
                # the graph's private pool, which lives as long as the
                # graph, not from the cache, which may free it
                scratch = _grid_scratch.__wrapped__(plan, n, batch, dtype,
                                                    dev, stream)
            else:
                scratch = _grid_scratch(plan, n, batch, dtype, dev, stream)
        x = torch.empty_like(b)
        r = torch.empty_like(b)
        err = _kernel_fn("circulant_pcg", dtype)(
            _ROUTE_CODE[plan.route], plan.ctas, plan.rows, plan.smem_bytes,
            int(plan.resident), band.data_ptr(), offs_c, len(offsets), n,
            batch, b.data_ptr(), x0.data_ptr(), inv_diag.data_ptr(),
            0 if inv_diag.ndim == 1 else n,
            None if mask is None else mask.data_ptr(),
            0 if mask is None or mask.ndim == 1 else n,
            int(iters), int(bool(meanfree)), x.data_ptr(), r.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    _check(err, f"circulant_pcg ({plan.route} route)")
    LAUNCHES["circulant_pcg"] += 1
    return x, r
