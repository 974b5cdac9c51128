"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the reading of the device's peak memory, then the check
against the reference.  ``run.py`` calls :func:`run_cell` after it has
found the cards; the tests call it on the CPU."""

from __future__ import annotations

import contextlib
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from harness import check
from harness.spec import load_module, load_problem
from harness.trace import LaunchLog, profile_blocks
from harness.window import block_quartiles, run_window, sync


def card(device):
    """``device`` object of the result line (without the trace's keys),
    with the card's power limit, clocks, draw and temperature as
    nvidia-smi reads them just after the window."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    fields = ("power.limit", "clocks.sm", "clocks.max.sm", "power.draw",
              "temperature.gpu")
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        out["nvidia_smi"] = dict(zip(fields, (v.strip() for v in
                                              line.split(","))))
    except (OSError, IndexError, subprocess.SubprocessError):
        out["nvidia_smi"] = "unavailable"
    return out


class _Context:
    """What a driver gets: the cell's data, its problem's module
    (``problems/<problem>.py``), the reference's node numbering, the
    seeded initial fields, the harness's set-up spans and the launch log
    of a traced run."""

    def __init__(self, cell, seed, device, log):
        self.config, self.workload = cell.config, cell.workload
        self.device = torch.device(device)
        self.problem = load_problem(self.config)
        self.lattice = self.problem.lattice(self.config)
        self.initial = self.problem.initial_fields(self.config, seed)
        self.spans = {}
        self._log = log

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + \
                time.perf_counter() - t0

    def recording(self):
        """Records the band kernels' work of a graph driver's last eager
        warm-up step (a traced run only)."""
        if self._log is None:
            return contextlib.nullcontext()
        return self._log.active()

    def sync(self):
        sync(self.device)


def run_cell(cell, seed, seconds, trace, device, start, stages=None,
             fault=None, readings=False, control=False):
    """The result dict of one run.  ``stages``: set-up seconds the
    caller timed before it called.  ``fault(stepper)``, for the tests,
    breaks the path under the harness after set-up.  ``readings``: both
    of the program's gaps, compared or not, under ``"readings"`` (and
    per kept block, ``[block, trajectory, du_gap, dp_gap]``, under
    ``"reading_blocks"``); ``control``: the control's under ``"control"``
    and ``"control_blocks"``."""
    log = LaunchLog() if trace else None
    ctx = _Context(cell, seed, device, log)
    ctx.spans.update(stages or {})
    wl = cell.workload
    with ctx.span("imports"):
        import navierstokes_tpu_torch  # noqa: F401
        driver = load_module("drivers", wl["driver"])
    with ctx.span("device_context"):
        torch.zeros(1, device=device)
        ctx.sync()
    stepper = driver.build(ctx)
    if fault is not None:
        fault(stepper)
    setup_s = time.perf_counter() - start

    steps, elapsed, pairs, block_ms = run_window(
        stepper, seconds, seed, int(wl["check_blocks"]), device)
    metrics = {
        "dof_steps_per_s": {"value": stepper.n_dofs * steps / elapsed,
                            "unit": "DoF-steps/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    result_trace = None
    if trace:
        result_trace = profile_blocks(stepper, int(wl["trace_blocks"]),
                                      device, log)
    device_info = card(device)

    t_check = time.perf_counter()
    values, limits = check.compare(cell.config, wl, stepper, pairs,
                                   device)
    check_s = time.perf_counter() - t_check
    correct = check.passed(values, limits)
    result = {"correct": correct, "attempted": steps,
              "failed": 0 if correct else steps}
    if trace:
        launches = log.records
        if stepper.graph:
            # recorded over one eager warm-up step; a replay runs the same
            launches = launches * result_trace["steps"]
        run = SimpleNamespace(spans=ctx.spans, stepper=stepper,
                              trace=result_trace, launches=launches)
        per_layer = {}
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None and math.isfinite(value):
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = per_layer
        device_info.update(busy_s=result_trace["busy_s"],
                           window_s=result_trace["window_s"])
        result["device"] = device_info
        result["breakdown"] = result_trace["breakdown"]
        result["trace"] = {
            "blocks": len(result_trace["block_ms"]),
            "block_ms": result_trace["block_ms"],
            "device_ops": result_trace["device_ops"],
            "host_window_s": result_trace["host_window_s"],
            "profiler_stall_s": result_trace["profiler_stall_s"]}
    else:
        result["metrics"] = metrics
        result["device"] = device_info
    result["setup_stages"] = dict(ctx.spans, total=setup_s)
    result["window"] = {"steps": steps, "seconds": elapsed,
                        "blocks_compared": [p[0] for p in pairs],
                        "block_ms_quartiles": block_quartiles(block_ms),
                        "check_seconds": check_s}
    if readings:
        rows = []
        result["readings"] = check.program_gaps(cell.config, wl, stepper,
                                                pairs, device, rows)
        result["reading_blocks"] = rows
    if control:
        rows = []
        result["control"] = check.control_gaps(cell.config, wl, stepper,
                                               pairs, device, rows)
        result["control_blocks"] = rows
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in values.items()}
    return result


def report_checks(result, stream=sys.stderr):
    """Each compared number beside its limit, one per line."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
