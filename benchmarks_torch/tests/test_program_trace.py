"""The readers of the program's own tracing on the CPU: a traced run of
each cell at 16^2 carries every new metric the CPU can give (the set-up
spans, the step phases by the host clock, the V-cycle in the march) in
the cells that list it, and leaves out ``graph.*``, since a loop on the
CPU captures no graph."""

import time

import pytest

from harness.cell_run import run_cell
from harness.spec import load_cell

CELLS = ["tgv2d_128.banded_graph", "tgv2d_128.spectral_graph",
         "cavity2d_128.march_graph"]
PROGRAM = ("setup.engine_s", "setup.amg_s", "step.convection_ms",
           "step.helmholtz_ms", "step.poisson_ms", "step.correction_ms",
           "amg.vcycle_ms")
GRAPH = ("graph.record_s", "graph.instantiate_s", "graph.nodes_per_step")


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_program_trace(name):
    cell = load_cell(name)
    cell.config["n_cells"] = 16
    if cell.workload.get("segment_steps"):
        cell.workload["segment_steps"] = 3 * cell.workload["chunk"]
    cell.workload["trace_blocks"] = 1
    listed = {m["name"] for m in cell.per_layer}
    assert set(GRAPH) <= listed
    result = run_cell(cell, 2 ** 31 + 5, 0.5, True, "cpu",
                      time.perf_counter())
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    want = listed & set(PROGRAM)
    assert {"setup.engine_s", "step.poisson_ms"} <= want
    assert ("amg.vcycle_ms" in want) == (name == "cavity2d_128.march_graph")
    assert want <= set(metrics)
    for metric in want:
        assert metrics[metric]["value"] > 0.0, metric
    assert not set(GRAPH) & set(metrics)
    if "amg.vcycle_ms" in want:
        assert metrics["amg.vcycle_ms"]["value"] < \
            metrics["step.poisson_ms"]["value"]
