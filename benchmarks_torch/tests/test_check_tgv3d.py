"""The check of ``tgv3d_48.spectral_graph`` decides ``correct`` as it
should, on the CPU at 4^3: a sound run passes; an unchanged step, an
altered answer and the bfloat16 reference fail; a step whose viscosity has
the wrong sign fails ``ke_growth``.  A traced run reads the structured
convection's phases, and ``structured_work.py`` counts the convection's
bytes at the two spectral cells' sizes."""

import pytest

from harness.spec import load_cell, load_module
from test_check import altered, run, unchanged

CELL = "tgv3d_48.spectral_graph"


def small():
    cell = load_cell(CELL)
    cell.config["n_cells"] = 4
    # blocks keep the cell's length; a few restarts of the flow inside the
    # short window
    cell.workload["segment_steps"] = 3 * cell.workload["chunk"]
    cell.workload["trace_blocks"] = 1
    return cell


def test_sound_run_is_correct():
    result = run(small())
    assert result["correct"], result["checks"]
    assert result["checks"]["ke_growth"]["value"] < 0.0


@pytest.mark.parametrize("fault", [unchanged, altered])
def test_broken_step_is_not_correct(fault):
    result = run(small(), fault=fault)
    assert not result["correct"], result["checks"]


def test_bfloat16_control_fails_the_check():
    cell = small()
    cell.workload["control"] = "bfloat16"
    result = run(cell, control=True)
    limits = cell.workload["limits"]
    assert any(result["control"][k] > limits[k] for k in limits), \
        result["control"]


def test_wrong_sign_viscosity_fails_ke_growth():
    """The step with -nu in place of nu from its first step on (the
    configuration's Reynolds number negated, which the driver and the
    reference read alike) feeds energy in.  The viscosity is a hundred
    times the cell's: at 4^3 its work over the window's first block is
    then +3e-2 to +0.15 of the energy (a scratch run of the port's step),
    where at Re 1600 it is +3e-4 to +1e-3, too close to the limit to show
    anything."""
    cell = small()
    cell.config["re"] = -cell.config["re"] / 100.0
    result = run(cell)
    growth = result["checks"]["ke_growth"]
    assert growth["value"] > growth["limit"], result["checks"]
    assert not result["correct"]


def test_traced_run_reads_the_convection_phases():
    """On the CPU the phases are host time: the four ms metrics read a
    number, the roofline (a device metric) nothing."""
    result = run(small(), trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("convection.gather_ms", "convection.quadrature_ms",
                 "convection.scatter_ms", "spectral.dft_ms"):
        assert metrics[name]["value"] > 0.0, name
    assert "structured_convection_roofline" not in metrics


def test_structured_work_counts_the_class_grids_once():
    """Class grids read once and written once, f32: 8 classes x 48^3 x 3
    components is 21.2 MB and 6.34 us at 3.35 TB/s; 4 classes x 128^2 x 2
    is 1.05 MB and 0.31 us."""
    work = load_module("metrics", "structured_work")
    assert work.convection_bytes((8, 48, 48, 48, 3), 4) == 21_233_664
    assert work.convection_bytes((4, 128, 128, 2), 4) == 1_048_576
    assert work.convection_least_ms((8, 48, 48, 48, 3), 4) * 1e3 == \
        pytest.approx(6.34, abs=0.005)
    assert work.convection_least_ms((4, 128, 128, 2), 4) * 1e3 == \
        pytest.approx(0.31, abs=0.005)
