"""The plain reference against the program at small sizes, in float64 on
the CPU: the same operators, and the same step on each of the program's
three paths (banded, spectral, masked banded)."""

import numpy as np
import pytest
import torch

from harness.common import BDF2
from harness.spec import load_problem
from reference.taylor_hood import ReferenceStep

EXACT = {"helmholtz": ("exact",), "poisson": ("exact",), "mass": ("exact",)}
CFG = {"taylor_green": {"problem": "taylor_green", "n_cells": 0},
       "lid_driven_cavity": {"problem": "lid_driven_cavity", "n_cells": 0}}


def setup(problem, n):
    cfg = dict(CFG[problem], n_cells=n)
    module = load_problem(cfg)
    space, vel_bc = module.setup(cfg)
    return space, vel_bc, module.reference_grid(cfg)


@pytest.mark.parametrize("problem", sorted(CFG))
def test_operators_equal_the_programs(problem):
    from navierstokes_tpu_torch.assembly.fastop import (
        assemble_csr, scalar_element_matrices)

    space, _, grid = setup(problem, 4)
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
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()

    same(assemble_csr(em["M2"], cu, cu, (nu, nu)), grid.M, iu, iu)
    same(assemble_csr(em["K2"], cu, cu, (nu, nu)), grid.K, iu, iu)
    same(assemble_csr(em["L1"], cp, cp, (npn, npn)), grid.L, ip, ip)
    for d in range(2):
        G = assemble_csr(em["G"][:, :, d, :], cu, cp, (nu, npn))
        same(G, grid.G[d], iu, ip)
        same(G.T.tocsr(), grid.D[d], ip, iu)


def _planar_case(problem, n, cg_iters, solves):
    from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
    from navierstokes_tpu_torch.solvers.planar_step import \
        build_planar_projection_step

    space, vel_bc, grid = setup(problem, n)
    fast = FastTaylorHood(space, device="cpu")

    def planar(flat):
        return np.asarray(flat).reshape(space.n_unodes, 2).T[:, fast.permU]

    step = build_planar_projection_step(
        fast, visc=1e-3, dt=1e-3, cg_iters=cg_iters,
        vel_bc=None if vel_bc is None else tuple(planar(a) for a in vel_bc))
    iu = grid.u_index(space.u_coords)[torch.as_tensor(fast.permU)]
    ip = grid.p_index(space.p_coords)[torch.as_tensor(fast.permP)]
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal((2, space.n_unodes))) * 0.3
    u_old = u + 1e-2 * torch.tensor(rng.standard_normal(u.shape))
    if vel_bc is not None:
        m, v = (torch.tensor(planar(a)) for a in vel_bc)
        u, u_old = (torch.where(m, v, w) for w in (u, u_old))
    p = torch.tensor(rng.standard_normal(space.n_pnodes))
    p -= p.mean()
    phi = 1e-2 * torch.tensor(rng.standard_normal(space.n_pnodes))
    phi -= phi.mean()
    got = step(u, u_old, p, phi, *BDF2)

    def ref_u(x):
        out = torch.zeros((2, grid.nu), dtype=torch.float64)
        out[:, iu] = x
        return out

    def ref_p(x):
        out = torch.zeros(grid.np, dtype=torch.float64)
        out[ip] = x
        return out

    dirichlet = None if vel_bc is None else grid.boundary_values(True)
    ref = ReferenceStep(grid, visc=1e-3, dt=1e-3, solves=solves,
                        dirichlet=dirichlet)
    want = ref(ref_u(u), ref_u(u_old), ref_p(p), ref_p(phi))
    return ((ref_u(got[0]), want[0], ref_u(u)),
            (ref_p(got[1]), want[1], ref_p(p)))


def _rel(got, want, start):
    return float((got - want).norm() / (want - start).norm())


@pytest.mark.parametrize("problem,cg_iters,solves", [
    ("taylor_green", (10, 60, 6),
     {"helmholtz": ("jacobi", 10), "poisson": ("jacobi", 60),
      "mass": ("jacobi", 6)}),
    ("lid_driven_cavity", (18, 30, 10),
     {"helmholtz": ("jacobi", 18), "poisson": ("jacobi", 30),
      "mass": ("jacobi", 10)}),
])
def test_fixed_iteration_step_equals_the_programs(problem, cg_iters, solves):
    for got, want, start in _planar_case(problem, 8, cg_iters, solves):
        assert _rel(got, want, start) <= 1e-11


def test_exact_solves_equal_the_spectral_step():
    from navierstokes_tpu_torch.structured import (
        PeriodicStructuredTH, build_spectral_projection_step)

    space, _, grid = setup("taylor_green", 8)
    step, init_state, read_state = build_spectral_projection_step(
        PeriodicStructuredTH(space), visc=1e-2, dt=1e-3, device="cpu")
    rng = np.random.default_rng(4)
    u = rng.standard_normal((space.n_unodes, 2))
    u_old = u + 1e-2 * rng.standard_normal(u.shape)
    p = rng.standard_normal(space.n_pnodes)
    p -= p.mean()
    u_new, p_new = read_state(step(init_state(u.reshape(-1),
                                              u_old.reshape(-1), p), *BDF2))
    iu = grid.u_index(space.u_coords)
    ip = grid.p_index(space.p_coords)

    def ref_u(x):
        out = torch.zeros((2, grid.nu), dtype=torch.float64)
        out[:, iu] = torch.as_tensor(np.asarray(x).reshape(-1, 2).T)
        return out

    def ref_p(x):
        out = torch.zeros(grid.np, dtype=torch.float64)
        out[ip] = torch.as_tensor(np.asarray(x))
        return out

    ref = ReferenceStep(grid, visc=1e-2, dt=1e-3, solves=EXACT)
    want_u, want_p, _ = ref(ref_u(u), ref_u(u_old), ref_p(p),
                            torch.zeros(grid.np, dtype=torch.float64))
    assert _rel(ref_u(u_new), want_u, ref_u(u)) <= 1e-10
    assert _rel(ref_p(p_new), want_p, ref_p(p)) <= 1e-10
