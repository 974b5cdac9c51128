"""The 3D Taylor-Green vortex on the port's periodic-box spectral path, and
the benchmark's plain 3D reference (``benchmarks_torch/reference/
taylor_hood_3d.py``, loaded by its path) held against the port on the CPU
in float64 at 4^3: the same operators, the same exact-solve step, an
exact quadrature, the Brachet initial state; and the step's nested phases
(``convection.gather``, ``convection.quadrature``, ``convection.scatter``,
``spectral.dft``) with their shared boundary marks."""

import importlib.util
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import torch

from navierstokes_tpu_torch.assembly.fastop import (assemble_csr,
                                                    scalar_element_matrices)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.graph import ChunkLoop

BENCH = Path(__file__).resolve().parents[1] / "benchmarks_torch"
# the reference imports its 2D sibling as ``reference.taylor_hood``
sys.path.insert(0, str(BENCH))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref3d = _load("_tgv3d_reference", BENCH / "reference" / "taylor_hood_3d.py")
problem = _load("_tgv3d_problem", BENCH / "problems" / "taylor_green_3d.py")

BDF2 = ((1.5, -2.0, 0.5), (2.0, -1.0))
EXACT = {"helmholtz": ("exact",), "poisson": ("exact",), "mass": ("exact",)}
NESTED = ("convection.gather", "convection.quadrature",
          "convection.scatter", "spectral.dft")
_cases = {}


def case():
    """The port's space and spectral step and the reference's grid at
    4^3, built once per process."""
    if not _cases:
        mesh, _ = hyper_cube(3, 4)
        space = TaylorHoodSpace(mesh, periodic=[axis_periodic(a)
                                                for a in range(3)])
        step, init_state, read_state = build_spectral_projection_step(
            PeriodicStructuredTH(space), visc=1e-2, dt=1e-3, device="cpu")
        _cases.update(space=space, step=step, init_state=init_state,
                      read_state=read_state, grid=ref3d.Grid(4))
    return _cases


def test_operators_equal_the_programs():
    """M, K, L, G and D of the reference equal the port's assembled
    operators, entry by entry: both integrate exactly (degree <= 4), so
    they differ by summation order, a few ulps of the largest entry."""
    c = case()
    space, grid = c["space"], c["grid"]
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
    for d in range(3):
        G = assemble_csr(em["G"][:, :, d, :], cu, cp, (nu, npn))
        same(G, grid.G[d], iu, ip)
        same(G.T.tocsr(), grid.D[d], ip, iu)


def test_exact_solves_equal_the_spectral_step():
    """One step of the reference with exact sub-solves equals the port's
    spectral step from seeded random u, u_old and p: both solve exactly
    (the reference's CG to 1e-13), so the difference is roundoff relative
    to the step's change, 1e-14 measured; 1e-10 leaves room for the CG's
    stopping point."""
    c = case()
    space, grid = c["space"], c["grid"]
    rng = np.random.default_rng(4)
    u = rng.standard_normal((space.n_unodes, 3))
    u_old = u + 1e-2 * rng.standard_normal(u.shape)
    p = rng.standard_normal(space.n_pnodes)
    p -= p.mean()
    u_new, p_new = c["read_state"](c["step"](
        c["init_state"](u.reshape(-1), u_old.reshape(-1), p), *BDF2))
    iu = grid.u_index(space.u_coords)
    ip = grid.p_index(space.p_coords)

    def ref_u(x):
        out = torch.zeros((3, grid.nu), dtype=torch.float64)
        out[:, iu] = torch.as_tensor(np.asarray(x).reshape(-1, 3).T)
        return out

    def ref_p(x):
        out = torch.zeros(grid.np, dtype=torch.float64)
        out[ip] = torch.as_tensor(np.asarray(x))
        return out

    ref = ref3d.ReferenceStep(grid, visc=1e-2, dt=1e-3, solves=EXACT)
    want_u, want_p, _ = ref(ref_u(u), ref_u(u_old), ref_p(p),
                            torch.zeros(grid.np, dtype=torch.float64))

    def rel(got, want, start):
        return float((got - want).norm() / (want - start).norm())

    assert rel(ref_u(u_new), want_u, ref_u(u)) <= 1e-10
    assert rel(ref_p(p_new), want_p, ref_p(p)) <= 1e-10


def test_quadrature_is_exact_to_degree_5():
    """The 14-point rule integrates every monomial of the barycentric
    coordinates of degree <= 5 over the unit tetrahedron: the integral of
    l1^a l2^b l3^c l4^d is a! b! c! d! 3! / (a + b + c + d + 3)! of the
    volume.  Its parameters carry 16 digits, so 1e-15 of the volume; a
    degree-6 monomial it does not integrate."""
    lam = torch.tensor(ref3d.QUAD_BARY, dtype=torch.float64)
    w = torch.tensor(ref3d.QUAD_W, dtype=torch.float64)
    assert lam.shape == (14, 4)

    def error(e):
        exact = math.prod(math.factorial(k) for k in e) * 6 / \
            math.factorial(sum(e) + 3)
        return abs(float((w * torch.prod(lam ** torch.tensor(e), dim=1))
                         .sum()) - exact)

    for e in itertools.product(range(6), repeat=4):
        if sum(e) <= 5:
            assert error(e) <= 1e-15, e
    assert error((6, 0, 0, 0)) > 1e-6


def test_brachet_state_is_discretely_divergence_free():
    """The interpolated Brachet velocity: its discrete divergence D u is
    roundoff against the parts D_d u_d (the field is divergence free and
    its symmetries carry over to the lattice), and its energy 1/2 u^T M u
    tends to the exact 1/8 at fourth order in h: off by 8.5e-3 at 8^3 and
    5.8e-4 at 16^3 (a ratio of 14.7), so within 1e-2 and 1e-3 there, at
    a ratio above 12."""
    velocity, _ = problem.initial_fields({}, 2 ** 31 + 7)
    gaps = []
    for n in (8, 16):
        grid = ref3d.Grid(n)
        u0 = torch.as_tensor(velocity(grid.u_coords().numpy()).T)
        parts = [grid.D[d](u0[d]) for d in range(3)]
        assert float(sum(parts).norm()) <= \
            1e-13 * float(sum(p.norm() for p in parts))
        gaps.append(abs(8.0 * problem.energy(grid, u0) - 1.0))
    assert gaps[0] <= 1e-2 and gaps[1] <= 1e-3
    assert gaps[0] / gaps[1] >= 12.0


def _loop():
    c = case()
    space = c["space"]
    velocity, pressure = problem.initial_fields({}, 3)
    u0 = space.interpolate_velocity(velocity).reshape(-1)
    state = c["init_state"](u0, u0, space.interpolate_pressure(pressure))
    step = c["step"]
    return ChunkLoop(lambda s: step(s, *BDF2), state, 1, device="cpu")


def test_nested_phases_sum_to_no_more_than_their_parents():
    """``phase_ms`` of the 3D step holds the four phases and the nested
    ones; the convection's three lie inside ``convection``, and the two
    transforms inside ``convection`` and ``correction``."""
    got = _loop().phase_ms(replays=1, steps=1).phases
    assert set(got) == {"convection", "helmholtz", "poisson",
                        "correction"} | set(NESTED)
    assert all(got[name] > 0.0 for name in NESTED)
    assert sum(got[name] for name in NESTED[:3]) <= got["convection"]
    assert got["spectral.dft"] <= got["convection"] + got["correction"]


def test_sibling_phases_share_a_mark():
    """A phase entered right after a sibling ended starts at that one's
    end mark, at any depth; the first of a parent's children, and a phase
    entered with ``joined=False``, mark their own start."""
    loop = _loop()
    with monitor.device_marks("cpu") as marks:
        loop.step_fn(loop.state)
    by_name = {}
    for name, start, end in marks.marks:
        by_name.setdefault(name, []).append((start, end))
    gather, quad, scatter = (by_name[n] for n in NESTED[:3])
    assert quad[0][0] is gather[0][1] and scatter[0][0] is quad[0][1]
    fwd, inv = by_name["spectral.dft"]
    assert fwd[0] is scatter[0][1]           # the forward DFT follows
    conv, = by_name["convection"]
    assert gather[0][0] is not conv[0]
    helm, = by_name["helmholtz"]
    assert helm[0] is conv[1]
    assert inv[0] is not by_name["correction"][1][0]

    with monitor.device_marks("cpu") as marks:
        with monitor.phase("outer"):
            with monitor.phase("a"):
                pass
            with monitor.phase("a", joined=False):
                pass
            with monitor.phase("b"):
                pass
    (a1, a2, b, outer) = [m[1:] for m in marks.marks]
    assert a2[0] is not a1[1] and b[0] is a2[1] and a1[0] is not outer[0]
