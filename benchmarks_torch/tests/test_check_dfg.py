"""The DFG 2D-2 cell ``dfg2d2_res3.projection_graph`` on the CPU at
resolution 1 (10,144 DoFs): the plain unstructured reference against the
program's operators and steps, and the check deciding ``correct`` as it
should.  Blocks are 3 steps (the loop runs eagerly here, under a dispatch
mode that refuses host reads, about a second a step) and the program runs
in float64: in float32 the pressure's change over 3 steps is too small
against float32's rounding of p for a limit set on the cell's 50-step
blocks (dp_gap 0.077 here).  The cell's own state is of the mesh at
resolution 3; these runs start from it interpolated onto the resolution-1
nodes (linear in each triangle of the resolution-3 nodes), which the
warm-up steps project."""

import numpy as np
import pytest
import torch

from harness.spec import load_cell, load_problem
from test_check import altered, run, unchanged

CELL = "dfg2d2_res3.projection_graph"
RESOLUTION = 1.0


@pytest.fixture(scope="module")
def state_file(tmp_path_factory):
    from scipy.interpolate import LinearNDInterpolator

    cell = load_cell(CELL)
    fine = load_problem(cell.config)._program_mesh(3.0)[3]
    coarse = load_problem(cell.config)._program_mesh(RESOLUTION)[3]
    with np.load(load_problem(cell.config).ROOT
                 / cell.config["initial"]["state"]) as data:
        fields = {k: data[k] for k in ("u", "u_old", "p")}
    out = {}
    for k in ("u", "u_old"):
        f = LinearNDInterpolator(fine.u_coords, fields[k].reshape(-1, 2),
                                 fill_value=0.0)
        out[k] = f(coarse.u_coords).reshape(-1)
    out["p"] = LinearNDInterpolator(fine.p_coords, fields["p"],
                                    fill_value=0.0)(coarse.p_coords)
    path = tmp_path_factory.mktemp("dfg") / "state_res1.npz"
    np.savez(path, **out)
    return str(path)


def small(state_file):
    cell = load_cell(CELL)
    cell.config["resolution"] = RESOLUTION
    cell.config["initial"]["state"] = state_file
    cell.config["dtype"] = "float64"
    cell.workload["chunk"] = 3
    cell.workload["segment_steps"] = cell.workload["warmup_steps"] + 9
    cell.workload["trace_blocks"] = 1
    # the cell's force_gap limit (5e-6) is set on the saturated cycle at
    # resolution 3, where SBDF-2's acceleration and backward Euler's differ
    # by at most 3.2e-7; here the flow leaves an interpolated state and they
    # differ by 2.5e-4, and a force without its acceleration reads 4.4e-3
    cell.config["guards"]["force_gap"] = 1e-3
    return cell


def test_operators_equal_the_programs():
    """Mass, stiffness, pressure Laplacian, gradient and divergence of the
    reference's own assembly on the curved mesh, against the program's
    element matrices assembled by ``fastop.assemble_csr``, float64."""
    from navierstokes_tpu_torch.assembly.fastop import (
        assemble_csr, scalar_element_matrices)

    cfg = dict(load_cell(CELL).config, resolution=RESOLUTION)
    problem = load_problem(cfg)
    space = problem._program_mesh(RESOLUTION)[3]
    grid = problem.reference_grid(cfg)
    # the cylinder's cells are curved: their mid-edge nodes left the chord
    X = np.asarray(space.cell_ucoords)
    chord = 0.5 * (X[:, [1, 0, 0]] + X[:, [2, 2, 1]])
    assert np.abs(X[:, 3:] - chord).max() > 1e-4
    em = scalar_element_matrices(space)
    cu, cp = np.asarray(space.cell_unodes), np.asarray(space.cell_pnodes)
    nu, npn = space.n_unodes, space.n_pnodes
    iu = grid.u_index(space.u_coords).numpy()
    ip = grid.p_index(space.p_coords).numpy()
    assert sorted(iu) == list(range(grid.nu))
    assert sorted(ip) == list(range(grid.np))

    def same(csr, ell, rows, cols):
        want = np.zeros(ell.shape)
        want[np.ix_(rows, cols)] = csr.toarray()
        got = ell.dense().numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()

    same(assemble_csr(em["M2"], cu, cu, (nu, nu)), grid.M, iu, iu)
    same(assemble_csr(em["K2"], cu, cu, (nu, nu)), grid.K, iu, iu)
    same(assemble_csr(em["L1"], cp, cp, (npn, npn)), grid.L, ip, ip)
    for d in range(2):
        G = assemble_csr(em["G"][:, :, d, :], cu, cp, (nu, npn))
        same(G, grid.G[d], iu, ip)
        same(G.T.tocsr(), grid.D[d], ip, iu)


def test_reaction_equals_the_programs_after_a_first_step(state_file):
    """After the solver's first step (SBDF-1: the acceleration of two
    levels, as the reference's) its ``boundary_reaction_force`` equals the
    reference's own nodal reaction of the same state, float64."""
    from harness.common import lex_maps
    from navierstokes_tpu_torch.solvers import ProjectionSolver
    from navierstokes_tpu_torch.timestepping import BDFTimeStepping
    from reference.taylor_hood_unstructured import reaction_force

    cfg = small(state_file).config
    problem = load_problem(cfg)
    mesh, markers, bcs, (body, scale) = problem.setup(cfg)
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=cfg["dt"])
    solver = ProjectionSolver(mesh, markers, "standard", ts, cg_rtol=None,
                              cg_iters=(40, 40, 20), device="cpu",
                              dtype=torch.float64)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / cfg["re"],
         "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    u, _, p = problem.initial_fields(cfg, 7)(solver.space)
    solver._u = solver._u_old = solver._u_old2 = torch.tensor(u)
    solver._p = torch.tensor(p)
    ts.update_coefficients()
    solver.solve()
    want = scale * solver.boundary_reaction_force(body)
    lat = problem.lattice(cfg)
    iu, ip = lex_maps(lat, solver.space)

    def velocity(flat):
        out = torch.zeros((2, lat.nu), dtype=torch.float64)
        out[:, iu] = flat.reshape(-1, 2).T
        return out

    pressure = torch.zeros(lat.np, dtype=torch.float64)
    pressure[ip] = solver._p
    got = scale * reaction_force(problem.reference_grid(cfg),
                                 velocity(solver._u), velocity(solver._u_old),
                                 pressure, [body], visc=1.0 / cfg["re"],
                                 dt=cfg["dt"])
    assert torch.allclose(got, want, rtol=0.0, atol=1e-12 * float(
        want.abs().max()))


def test_sound_run_is_correct_at_roundoff(state_file):
    """The program's step in float64 against the reference's: a 3-step
    block's gaps read roundoff, and the flow stays inside the envelope.
    dp_gap is the larger: the program's Poisson solve is 40 AMG-PCG
    iterations (about 1e-10 of the block's pressure change), the
    reference's exact."""
    result = run(small(state_file))
    checks = result["checks"]
    assert result["correct"], checks
    assert checks["du_gap"]["value"] < 1e-11
    assert checks["dp_gap"]["value"] < 1e-9
    for name in ("cd_envelope", "cl_envelope"):
        assert checks[name]["value"] < 0.0
    # the program's force (SBDF-2's acceleration) against the reference's
    # (backward Euler's, the state holding two levels): about 2.5e-4
    assert 0.0 < checks["force_gap"]["value"] < 5e-4


@pytest.mark.parametrize("fault", [unchanged, altered])
def test_broken_step_is_not_correct(state_file, fault):
    result = run(small(state_file), fault=fault)
    assert not result["correct"], result["checks"]


def test_force_without_its_acceleration_is_not_correct(state_file,
                                                       monkeypatch):
    """The program's drag and lift are held to the reference's nodal
    reaction of the same state: a force that leaves out the acceleration
    term (about 4e-3 of c_D here) fails ``force_gap`` alone."""
    from navierstokes_tpu_torch.solvers import ProjectionSolver

    reaction = ProjectionSolver._reaction
    monkeypatch.setattr(
        ProjectionSolver, "_reaction",
        lambda self, bndry, alpha, k: reaction(self, bndry, (0.0,) * 3, k))
    cell = small(state_file)
    result = run(cell)
    checks = result["checks"]
    assert not result["correct"]
    assert [k for k, c in checks.items() if k != "finite"
            and not c["value"] <= c["limit"]] == ["force_gap"], checks


def test_bfloat16_control_fails_the_check(state_file):
    """The reference in bfloat16 in the program's place (the cell's own
    control, TF32 matmuls, exists on a CUDA device only)."""
    cell = small(state_file)
    cell.workload["control"] = "bfloat16"
    result = run(cell, control=True)
    limits = cell.workload["limits"]
    assert any(result["control"][k] > limits[k] for k in limits), \
        result["control"]


def test_traced_run_reads_the_reaction_phase(state_file):
    """On the CPU the phase is host time; the counters read what a capture
    counted, and the CPU captures nothing."""
    result = run(small(state_file), trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["reaction.force_ms"]["value"] > 0.0
    for name in ("amg.vcycles_per_step",
                 "fastop.unstructured_applies_per_step"):
        assert name not in metrics
