"""The check decides ``correct`` as it should, on the CPU at a size a test
run holds: a sound run of every cell passes, the same run with its timed
path broken underneath fails (a step that returns its state unchanged; an
answer altered where it is produced), and so does each cell's control.
The harness's look for a card (``run.py``) is skipped; everything after
it runs."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import check, trace
from harness.cell_run import run_cell
from harness.spec import load_cell

CELLS = ["tgv2d_128.banded_graph", "tgv2d_128.spectral_graph",
         "cavity2d_128.march_graph"]
SIZES = {"tgv2d_128": 16, "cavity2d_128": 16}


def small(name):
    cell = load_cell(name)
    cell.config["n_cells"] = SIZES[cell.config["name"]]
    # blocks keep the cell's length: the gaps are relative to the change
    # over a block, so a shorter block reads larger gaps
    if cell.workload.get("segment_steps"):
        # a few restarts of the flow inside the short window
        cell.workload["segment_steps"] = 3 * cell.workload["chunk"]
    cell.workload["trace_blocks"] = 1
    return cell


def run(cell, fault=None, control=False, device="cpu", trace=False):
    return run_cell(cell, 2 ** 31 + 11, 0.5, trace, device,
                    time.perf_counter(), fault=fault, control=control)


def unchanged(stepper):
    """Every block returns its input state (the step count still grows)."""
    def advance():
        stepper.steps += stepper.block_steps
    stepper.advance = advance


def altered(stepper):
    """After every block the largest velocity value has its sign
    flipped."""
    advance = stepper.advance

    def flip(u):
        flat = u.view(-1)
        flat[flat.abs().argmax()] *= -1.0

    def flipped():
        advance()
        flip(stepper.loop.state[0])
    stepper.advance = flipped


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(small(name))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [unchanged, altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(name, fault):
    result = run(small(name), fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    cell, device = small(name), "cpu"
    if cell.workload["control"] == "tf32":
        if not torch.cuda.is_available():
            pytest.skip("TF32 matmuls exist on a CUDA device only")
        # at the cell's own size: TF32's error grows with the DFT's length
        cell, device = load_cell(name), "cuda"
    result = run(cell, control=True, device=device)
    limits = cell.workload["limits"]
    assert set(limits) <= set(result["control"])
    assert any(result["control"][k] > limits[k] for k in limits), \
        result["control"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_trace(name):
    """The traced segment runs after a profiler warm-up block, every
    reader of the cell runs, and the line carries the trace's keys.  The
    CPU has no device time: the readers of device time find nothing, and
    their metrics are left out of the line."""
    cell = small(name)
    result = run(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["setup.build_s"]["value"] > 0.0
    for metric in ("spectral.device_ms_per_step", "circulant_pcg_roofline",
                   "circulant_apply_roofline"):
        assert metric not in result["metrics"]
    assert result["trace"]["blocks"] == 0       # no CUDA events on the CPU
    assert result["device"]["window_s"] > 0.0
    assert list(result)[-1] == "checks"


def test_unknown_problem_raises():
    cell = small(CELLS[0])
    cell.config["problem"] = "no_such_problem"
    with pytest.raises(ValueError, match="no_such_problem"):
        run(cell)


def test_passed_reads_every_number():
    limits = {"du_gap": 1e-3, "dp_gap": 1e-3, "finite": 1.0}
    assert check.passed({"du_gap": 1e-4, "dp_gap": 1e-4, "finite": 1.0},
                        limits)
    assert not check.passed({"du_gap": 1e-4, "dp_gap": float("nan"),
                             "finite": 1.0}, limits)
    assert not check.passed({"du_gap": 1e-4, "dp_gap": 1e-4,
                             "finite": 0.0}, limits)


def test_run_py_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    bench = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(bench / "run.py"), "--workload", CELLS[1],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=bench.parent, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


class _Event:
    def __init__(self, name, kind):
        self._name, self._kind = name, kind

    def name(self):
        return self._name

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._kind.endswith("user_annotation")


@pytest.mark.parametrize("name,kind,marks", [
    ("ProfilerStep#1", "gpu_user_annotation", True),
    ("ProfilerStep#1", "user_annotation", True),
    ("circulant_apply_kernel", "kernel", False),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", False),
    ("aten::add", "cpu_op", False),
])
def test_trace_leaves_out_annotations(name, kind, marks):
    """A span drawn on the device's timeline by the profiler's step mark
    is neither busy time nor a device operation."""
    assert trace._annotation(_Event(name, kind)) is marks


@pytest.mark.parametrize("name,kind,stall", [
    ("Buffer Flush", "overhead", True),
    ("Activity Buffer Request", "", True),
    ("cudaGraphLaunch", "cuda_runtime", False),
    ("aten::copy_", "cpu_op", False),
])
def test_trace_knows_the_profilers_own_stalls(name, kind, stall):
    assert trace._profiler_overhead(_Event(name, kind)) is stall


def test_idle_gaps_go_to_the_innermost_host_operation():
    merged = [[0.0, 10.0], [20.0, 30.0], [34.0, 40.0]]
    host = [(0.0, 40.0, "outer"), (12.0, 18.0, "Buffer Flush")]
    gaps = trace._idle_by_host_op(merged, host)
    assert gaps == {"Buffer Flush": 10.0 / 1e6, "outer": 4.0 / 1e6}
