"""Work and bound of the band kernels' operations, from their operands.

Copied from ``chip_smoke.py`` (``bound``, ``apply_work``, ``pcg_work`` and
the peaks), so that a later change to that script cannot move the
benchmark's rooflines.  Each input is counted once and each output once,
whatever a kernel reads again; the count is the operation's and does not
depend on what implements it.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit: HBM3
3.35 TB/s; 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the
tensor cores.  The card's power limit is printed beside every run
(``device.power_limit``); a card set below 700 W reads lower shares."""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by): the least time for the work at the card's
    peak memory rate and peak rate for ``dtype``."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def apply_work(K, n, batch, esize):
    """Bytes (band, x and y once each) and FLOPs of one band apply."""
    return (K * n + 2 * batch * n) * esize, 2 * K * n * batch


def pcg_work(case):
    """Bytes (each input read once, x and r written once) and FLOPs of one
    whole solve with these arguments, counted per row as _pcg does the
    work: each iteration a matvec (2K; masked 5 more: m*v before, and
    m*w + (1-m)*v after), two dot products and the x, r, z and p updates
    (11; masked 1 more, mean-free 2 more); the setup counts as one more
    iteration."""
    band, _, b, x0, invd, maskv, iters, meanfree = case
    K, n = band.shape
    rows = b.numel()
    masked = torch.is_tensor(maskv)
    esize = b.element_size()
    nbytes = band.numel() + 4 * rows + invd.numel() + \
        (maskv.numel() if masked else 0)
    matvec = 2 * K + (5 if masked else 0)
    per_iter = matvec + 11 + (1 if masked else 0) + (2 if meanfree else 0)
    flops = rows * ((iters + 1) * per_iter)
    return nbytes * esize, flops


def roofline_share(records, kernel_s, kernel_names):
    """Percent of the least time: the sum of each recorded call's bound
    over the device time of the kernels whose names hold one of
    ``kernel_names``; None when either is missing."""
    least_ms = sum(bound(b, f, dt)[0] for b, f, dt in records)
    seconds = sum(t for name, t in kernel_s.items()
                  if any(k in name for k in kernel_names))
    if least_ms <= 0.0 or seconds <= 0.0:
        return None
    return 100.0 * least_ms / 1e3 / seconds
