"""CUDA kernels for the CirculantBand matvec and the whole-solve PCG.

Counterpart of ``navierstokes_tpu/assembly/pallas_band.py``.  Four
functions:

* :func:`circulant_apply` / :func:`circulant_pcg` -- the wrappers.  On a
  CUDA tensor they launch the hand-written kernels of ``csrc/band.cu``
  (built into the kernel library, ``cudalib.py``) or raise; on a CPU
  tensor they run the plain versions.  The tensor's device is the only
  thing that decides.
* :func:`circulant_apply_plain` / :func:`circulant_pcg_plain` -- the same
  semantics in plain torch.  The apply is a stack of rolled windows (the
  JAX ``stack`` lowering, ``fastop.py:192-201``); the PCG is
  ``linalg/pcg.pcg`` with a fixed iteration count.

The PCG has two kernels; :func:`pcg_plan`, a pure function of the shapes
and dtype, picks one: route ``"cluster"`` (A) keeps a system that fits in
one thread-block cluster's shared memory there for the whole solve, route
``"grid"`` (B) runs one cooperative grid of at most one CTA per SM.  A
launch that fails raises; the wrapper never tries the other route.

Launches count under ``cudalib.LAUNCHES["circulant_apply"]`` and
``["circulant_pcg"]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.linalg.pcg import pcg

MAX_OFFSETS = 96          # kMaxOffsets in band.cu (build_operator's cap)
GRID_THREADS = 1024       # kGridThreads in band.cu (route B)
CLUSTER_THREADS = 512     # kClusterThreads in band.cu (route A, pinned)
CLUSTER_SIZE = 16         # route A: CTAs of the (non-portable) cluster
H100_SMS = 132            # route B: at most one CTA per SM
SMEM_STATIC = 8_192       # reserved for the PCG kernels' static arrays

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# A. circulant_apply
# ---------------------------------------------------------------------------

# ns_circulant_apply_<f32|f64>(band, offs, K, x, y, n, batch, stream)
APPLY_ARGS = (_P, _P, _I, _P, _P, _LL, _LL, _P)


def _validate_apply(band, offsets, x):
    if band.ndim != 2:
        raise ValueError(f"band must be (K, N), got {tuple(band.shape)}")
    n = band.shape[1]
    offsets, offs_c = cudalib.check_offsets(offsets, n, MAX_OFFSETS)
    if band.shape[0] != len(offsets):
        raise ValueError(f"band has {band.shape[0]} rows for "
                         f"{len(offsets)} offsets")
    if x.ndim < 1 or x.shape[-1] != n:
        raise ValueError(f"x must be (..., {n}), got {tuple(x.shape)}")
    cudalib.check_tensors({"band": band, "x": x}, x.device, x.dtype)
    return offsets, offs_c


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
    cudalib.check_index_range(len(offsets), n, batch)
    fn = cudalib.entry("circulant_apply", x.dtype, APPLY_ARGS)
    y = torch.empty_like(x)
    with cudalib.on_device(x.device):
        err = fn(band.data_ptr(), offs_c, len(offsets), x.data_ptr(),
                 y.data_ptr(), n, batch, cudalib.current_stream(x.device))
    cudalib.check_error(err, "circulant_apply")
    cudalib.LAUNCHES["circulant_apply"] += 1
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
# ns_circulant_pcg_prepare_<f32|f64>(route, ctas, smem, masked)
PREPARE_ARGS = (_I,) * 4
# ns_circulant_pcg_<f32|f64>(route, ctas, rows, smem, resident, band, offs,
# K, n, batch, b, x0, invd, invd_stride, mask, mask_stride, iters,
# meanfree, x, r, scratch, stream)
PCG_ARGS = (_I, _I, _I, _I, _I, _P, _P, _I, _LL, _LL, _P, _P, _P, _I, _P,
            _I, _I, _I, _P, _P, _P, _P)


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
    budget = cudalib.SMEM_PER_BLOCK - SMEM_STATIC
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
    prepare = cudalib.entry("circulant_pcg_prepare", dtype, PREPARE_ARGS)
    with cudalib.on_device(device):
        cudalib.check_error(prepare(
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
    cudalib.check_tensors(named, b.device, b.dtype)
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

    return pcg(matvec, b, x0, int(iters), inv_diag=inv_diag,
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
    _, offs_c = cudalib.check_offsets(offsets, band.shape[1], MAX_OFFSETS)
    n, dtype, dev = band.shape[1], b.dtype, b.device
    cudalib.check_index_range(len(offsets), n, batch)
    masked = mask is not None
    plan = _prepared(pcg_plan(n, len(offsets), batch, dtype, masked), dtype,
                     dev, masked)
    with cudalib.on_device(dev):
        stream = cudalib.current_stream(dev)
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
        err = cudalib.entry("circulant_pcg", dtype, PCG_ARGS)(
            _ROUTE_CODE[plan.route], plan.ctas, plan.rows, plan.smem_bytes,
            int(plan.resident), band.data_ptr(), offs_c, len(offsets), n,
            batch, b.data_ptr(), x0.data_ptr(), inv_diag.data_ptr(),
            0 if inv_diag.ndim == 1 else n,
            None if mask is None else mask.data_ptr(),
            0 if mask is None or mask.ndim == 1 else n,
            int(iters), int(bool(meanfree)), x.data_ptr(), r.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    cudalib.check_error(err, f"circulant_pcg ({plan.route} route)")
    cudalib.LAUNCHES["circulant_pcg"] += 1
    return x, r
