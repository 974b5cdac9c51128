"""The traced segment of a ``--trace 1`` run and what is read from it.

After the measured window the harness runs one block with the profiler
warming up (CUPTI's start-up lands there and is dropped), then
``trace_blocks`` more blocks under ``torch.profiler`` (CPU and CUDA
activities; kernels inside a CUDA graph replay are recorded one by one).
``trace_blocks`` is set per workload so that the segment lasts about a
second: its two ends, the first launch and the last synchronisation, are
then a small part of it.  ``window_s`` is the segment's host-clock length
less the device's idle gaps that fall inside the profiler's own overhead
records (CUPTI flushing or requesting its activity buffers), which an
untraced run does not pay; those seconds are reported apart
(``profiler_stall_s``).  From the trace it keeps the device
intervals (kernels, copies, sets), their union (``busy_s``), the device
time by kernel name, the device operations and the host's scalar reads
(``aten::_local_scalar_dense``), each traced block's device time by CUDA
events (``block_ms``), and the breakdown: the device operations that took
most time, and the idle gaps by the innermost host operation running at
their middle, over every gap.

``LaunchLog`` records the work of every call to the band kernels'
wrappers (``assembly/cuda_band.circulant_apply``, ``circulant_pcg``) while
it is active; nothing is recorded, and the wrappers are untouched, outside
a traced run."""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

from harness.spec import load_module
from harness.window import sync

NAME_CHARS = 160    # a kernel's templated name is cut to this in the line
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request", "Resource",
                     "Command Buffer Full", "Instrumentation")


class LaunchLog:
    """The work of each band kernel call made inside :meth:`active`, as
    ``(name, bytes, flops, dtype)`` by ``metrics/work.py``."""

    def __init__(self):
        self.records = []
        self.work = load_module("metrics", "work")

    @contextlib.contextmanager
    def active(self):
        from navierstokes_tpu_torch.assembly import cuda_band

        apply_fn, pcg_fn = cuda_band.circulant_apply, cuda_band.circulant_pcg

        def circulant_apply(band, offsets, x):
            K, n = band.shape
            self.records.append(("circulant_apply", *self.work.apply_work(
                K, n, x.numel() // n, x.element_size()), x.dtype))
            return apply_fn(band, offsets, x)

        def circulant_pcg(*case):
            self.records.append(("circulant_pcg", *self.work.pcg_work(case),
                                 case[2].dtype))
            return pcg_fn(*case)

        cuda_band.circulant_apply = circulant_apply
        cuda_band.circulant_pcg = circulant_pcg
        try:
            yield self
        finally:
            cuda_band.circulant_apply = apply_fn
            cuda_band.circulant_pcg = pcg_fn


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _times(event):
    """``(start, end)`` of a profiler event in microseconds."""
    if hasattr(event, "start_ns"):
        return event.start_ns() / 1e3, event.end_ns() / 1e3
    return event.start_us(), event.start_us() + event.duration_us()


def _annotation(event):
    """Whether a profiler event marks a span (``ProfilerStep#1`` and
    other ``record_function`` ranges, also as drawn on the device's
    timeline) rather than a host operation or a device operation."""
    if hasattr(event, "is_user_annotation") and event.is_user_annotation():
        return True
    kind = event.activity_type() if hasattr(event, "activity_type") else ""
    return "annotation" in kind or event.name().startswith("ProfilerStep#")


def _profiler_overhead(event):
    """Whether a host-side event is the profiler's own work (CUPTI's
    overhead records: flushing and requesting activity buffers, its
    resources, a full command buffer under instrumentation).  The device
    waits through these only because it is traced."""
    kind = event.activity_type() if hasattr(event, "activity_type") else ""
    return kind == "overhead" or event.name() in PROFILER_OVERHEAD


def profile_blocks(stepper, blocks, device, log=None):
    """Run one warm-up block and ``blocks`` traced blocks under the
    profiler; returns the summary dict (times in seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        stepper.begin_block()
        stepper.advance()
        sync(device)
        prof.step()
        steps0 = stepper.steps
        ctx = log.active() if (log is not None and not stepper.graph) \
            else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            for _ in range(blocks):
                stepper.begin_block()
                if cuda:
                    marks.append((torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)))
                    marks[-1][0].record()
                stepper.advance()
                if cuda:
                    marks[-1][1].record()
            sync(device)
            window_s = time.perf_counter() - t0
    steps = stepper.steps - steps0

    device_iv, host, kernel_us, counts, stalls = [], [], {}, {}, set()
    for e in prof.profiler.kineto_results.events():
        if _annotation(e):
            continue
        start, end = _times(e)
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            device_iv.append((start, end))
            kernel_us[name] = kernel_us.get(name, 0.0) + (end - start)
        else:
            host.append((start, end, name))
            counts[name] = counts.get(name, 0) + 1
            if _profiler_overhead(e):
                stalls.add(name)
    merged = _merge(device_iv)
    busy_us = sum(end - start for start, end in merged)
    gaps = _idle_by_host_op(merged, host)
    stall_s = sum(v for k, v in gaps.items() if k in stalls)
    return {
        "steps": steps, "window_s": window_s - stall_s,
        "host_window_s": window_s, "profiler_stall_s": stall_s,
        "busy_s": busy_us / 1e6,
        "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
        "device_ops": len(device_iv),
        "host_reads": counts.get("aten::_local_scalar_dense", 0),
        "block_ms": [a.elapsed_time(b) for a, b in marks],
        "breakdown": {
            "device_ops": [[k[:NAME_CHARS], v / 1e6] for k, v in sorted(
                kernel_us.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def _idle_by_host_op(merged, host, reach=64):
    """``{name: seconds}``: idle seconds between device intervals, summed
    by the innermost host operation running at each gap's middle (looked
    for among the ``reach`` host operations that started last before
    it)."""
    if len(merged) < 2 or not host:
        return {}
    host.sort()
    starts = [h[0] for h in host]
    by_name = {}
    for i in range(len(merged) - 1):
        start, end = merged[i][1], merged[i + 1][0]
        if end <= start:
            continue
        mid = 0.5 * (start + end)
        k = bisect.bisect_right(starts, mid)
        best = None
        for h_start, h_end, name in host[max(0, k - reach):k]:
            if h_end >= mid and (best is None
                                 or h_end - h_start < best[1] - best[0]):
                best = (h_start, h_end, name)
        name = best[2] if best else "no host operation recorded"
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    return by_name
