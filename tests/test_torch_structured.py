"""Port parity: the structured spectral path (structured/grid, ops, spectral).

The same seeded NumPy inputs go through each JAX function and its torch
counterpart on the CPU in float64, in 2D (``hyper_cube(2, 8)``) and 3D
(``hyper_cube(3, 4)``).  The host tables are NumPy on both sides with the
same operations in the same order, so they must be equal; the device
functions differ in summation order only (torch vs XLA, batched products
in place of einsums), so they agree to the tolerances stated per test,
relative to the largest reference entry.  The eigenbasis ``P`` is unique
only up to a phase per vector, so solves are compared on data, never on
``P``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.structured import grid as jgrid
from navierstokes_tpu.structured import ops as jops
from navierstokes_tpu.structured import spectral as jspec
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.structured import (NotStructured,
                                               PeriodicStructuredTH,
                                               SpectralOperators,
                                               StructuredConvection,
                                               apply_pp, apply_pu, apply_up,
                                               apply_uu,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.structured import spectral as tspec

N_POINTS = {2: 8, 3: 4}
ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]
VISC, DT = 0.01, 1e-2
DIMS = pytest.mark.parametrize("dim", [2, 3])


class Case:
    """Both packages' class grids and spectral operators on one mesh."""

    def __init__(self, dim):
        n = N_POINTS[dim]
        self.dim = dim
        jm, _ = jax_hyper_cube(dim, n)
        self.jspace = JaxSpace(jm, periodic=[jax_axis_periodic(a)
                                             for a in range(dim)])
        self.jsg = jgrid.PeriodicStructuredTH(self.jspace)
        tm, _ = hyper_cube(dim, n)
        self.space = TaylorHoodSpace(tm, periodic=[axis_periodic(a)
                                                   for a in range(dim)])
        self.sg = PeriodicStructuredTH(self.space)
        self.jops = jspec.SpectralOperators(self.jsg, jnp.float64)
        self.ops = SpectralOperators(self.sg, device="cpu")

    def random(self, seed):
        """Seeded class grids (U, P) as NumPy arrays."""
        rng = np.random.default_rng(seed)
        u = rng.standard_normal(self.space.n_velocity_dofs)
        p = rng.standard_normal(self.space.n_pnodes)
        return self.sg.u_to_grids(u), self.sg.p_to_grid(p)

    def flow(self):
        """A smooth divergence-free initial velocity (flat) and p = 0."""
        g = 2.0 * np.pi
        if self.dim == 2:
            fn = lambda x: np.stack(
                [np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                 -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])], axis=1)
        else:
            fn = lambda x: np.stack(
                [np.sin(g * x[:, 1]) * np.cos(g * x[:, 2]),
                 np.sin(g * x[:, 2]) * np.cos(g * x[:, 0]),
                 np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])], axis=1)
        u0 = self.space.interpolate_velocity(fn).reshape(-1)
        return u0, np.zeros(self.space.n_pnodes)


_CASES = {}


def _case(dim):
    """The Case of ``dim``, built once per process."""
    if dim not in _CASES:
        _CASES[dim] = Case(dim)
    return _CASES[dim]


@pytest.fixture
def case(dim):
    return _case(dim)


def _close(got, want, tol):
    """max|got - want| <= tol * max|want| (a scale of 1 if want is 0)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _pair(Z):
    """A SplitC of either package as two NumPy arrays."""
    return tuple(a.numpy() if torch.is_tensor(a) else np.asarray(a)
                 for a in Z)


def _both(Zt, Zj, tol):
    for got, want in zip(_pair(Zt), _pair(Zj)):
        _close(got, want, tol)


def _tsplit(re, im):
    return tspec.SplitC(torch.tensor(re), torch.tensor(im))


def _jsplit(re, im):
    return jspec.SplitC(jnp.asarray(re), jnp.asarray(im))


# ---------------------------------------------------------------------------
# grid.py: host tables and the flat <-> grid transforms
# ---------------------------------------------------------------------------

@DIMS
def test_class_grid_tables_equal_jax(case):
    sg, jsg = case.sg, case.jsg
    assert sg.shape == jsg.shape and sg.n_tau == jsg.n_tau
    assert sg.n_uclass == jsg.n_uclass == 2 ** case.dim
    for name in ("u_rank", "p_rank", "u_class", "u_shift", "p_shift",
                 "cell_tau", "cell_base", "parity"):
        assert np.array_equal(getattr(sg, name), getattr(jsg, name)), name
    for name in ("M_tau", "K_tau", "G_tau", "L_tau", "W_tau", "Jinv_tau",
                 "h", "origin"):
        np.testing.assert_allclose(getattr(sg, name), getattr(jsg, name),
                                   rtol=0, atol=1e-14, err_msg=name)


@DIMS
def test_taps_equal_jax(case):
    sg, jsg = case.sg, case.jsg
    for name, tau in (("taps_uu", "M_tau"), ("taps_uu", "K_tau"),
                      ("taps_up", "G_tau"), ("taps_pu", "G_tau"),
                      ("taps_pp", "L_tau")):
        got = getattr(sg, name)(getattr(sg, tau))
        want = getattr(jsg, name)(getattr(jsg, tau))
        assert got.keys() == want.keys(), name
        for key in want:
            assert [s for s, _ in got[key]] == [s for s, _ in want[key]]
            np.testing.assert_allclose(
                np.array([w for _, w in got[key]]),
                np.array([w for _, w in want[key]]), rtol=0, atol=1e-14)


@DIMS
def test_flat_grid_transforms_numpy_and_torch(case):
    """The torch branches of the four transforms equal the NumPy ones, and
    both round-trip exactly."""
    sg = case.sg
    rng = np.random.default_rng(1)
    u = rng.standard_normal(case.space.n_velocity_dofs)
    p = rng.standard_normal(case.space.n_pnodes)
    U, P = sg.u_to_grids(u), sg.p_to_grid(p)
    assert U.shape == (2 ** case.dim,) + sg.shape + (case.dim,)
    assert np.array_equal(U, case.jsg.u_to_grids(u))
    assert np.array_equal(P, case.jsg.p_to_grid(p))
    assert np.array_equal(sg.grids_to_u(U), u)
    assert np.array_equal(sg.grid_to_p(P), p)
    Ut, Pt = sg.u_to_grids(torch.tensor(u)), sg.p_to_grid(torch.tensor(p))
    assert np.array_equal(Ut.numpy(), U) and np.array_equal(Pt.numpy(), P)
    assert np.array_equal(sg.grids_to_u(Ut).numpy(), u)
    assert np.array_equal(sg.grid_to_p(Pt).numpy(), p)


def test_not_structured_rejected():
    mesh, _ = hyper_cube(2, 4)
    with pytest.raises(NotStructured):
        PeriodicStructuredTH(TaylorHoodSpace(mesh))   # no periodicity
    with pytest.raises(NotStructured):                # periodic in x only
        PeriodicStructuredTH(TaylorHoodSpace(mesh,
                                             periodic=[axis_periodic(0)]))


# ---------------------------------------------------------------------------
# ops.py: stencil applies and the convection
# ---------------------------------------------------------------------------

@DIMS
@pytest.mark.parametrize("name", ["mass", "stiffness", "gradient",
                                  "divergence", "laplacian"])
def test_stencil_apply_matches_jax(case, name):
    """Each tap apply against the JAX function: 1e-12."""
    sg, jsg = case.sg, case.jsg
    U, P = case.random(seed=2)
    Ut, Pt, Uj, Pj = (torch.tensor(U), torch.tensor(P), jnp.asarray(U),
                      jnp.asarray(P))
    if name == "mass":
        got = apply_uu(sg.taps_uu(sg.M_tau), Ut)
        want = jops.apply_uu(jsg.taps_uu(jsg.M_tau), Uj)
    elif name == "stiffness":
        got = apply_uu(sg.taps_uu(sg.K_tau), Ut)
        want = jops.apply_uu(jsg.taps_uu(jsg.K_tau), Uj)
    elif name == "gradient":
        got = apply_up(sg.taps_up(sg.G_tau), Pt)
        want = jops.apply_up(jsg.taps_up(jsg.G_tau), Pj)
    elif name == "divergence":
        got = apply_pu(sg.taps_pu(sg.G_tau), Ut)
        want = jops.apply_pu(jsg.taps_pu(jsg.G_tau), Uj)
    else:
        got = apply_pp(sg.taps_pp(sg.L_tau), Pt)
        want = jops.apply_pp(jsg.taps_pp(jsg.L_tau), Pj)
    _close(got, want, 1e-12)


@DIMS
def test_convection_matches_jax(case):
    """StructuredConvection, and its gather and scatter halves: 1e-12."""
    U, _ = case.random(seed=3)
    conv = StructuredConvection(case.sg, device="cpu")
    jconv = jops.StructuredConvection(case.jsg, jnp.float64)
    assert conv.dtype == torch.float64
    loc = conv.gather_local(torch.tensor(U))
    jloc = jconv.gather_local(jnp.asarray(U))
    assert np.array_equal(loc.numpy(), np.asarray(jloc))
    _close(conv.scatter_local(loc), jconv.scatter_local(jloc), 1e-12)
    _close(conv(torch.tensor(U)), jconv(jnp.asarray(U)), 1e-12)


# ---------------------------------------------------------------------------
# spectral.py: the DFT, the block applies, the operators and solves
# ---------------------------------------------------------------------------

@DIMS
def test_matmul_dft_matches_jax_and_numpy(case):
    """fwd / inv_real against the JAX class and against np.fft: 1e-11."""
    U, _ = case.random(seed=4)
    axes = tuple(range(1, 1 + case.dim))
    dft = tspec.MatmulDFT(case.sg.shape, torch.float64, "cpu")
    jdft = jspec.MatmulDFT(case.jsg.shape, jnp.float64)
    Z, Zj = dft.fwd(torch.tensor(U)), jdft.fwd(jnp.asarray(U))
    _both(Z, Zj, 1e-11)
    ref = np.fft.fftn(U, axes=axes)
    _close(Z.re, ref.real, 1e-11)
    _close(Z.im, ref.imag, 1e-11)
    # inverse of a non-Hermitian spectrum: the real part of ifftn
    rng = np.random.default_rng(5)
    re, im = rng.standard_normal(U.shape), rng.standard_normal(U.shape)
    back = dft.inv_real(_tsplit(re, im))
    _close(back, jdft.inv_real(_jsplit(re, im)), 1e-11)
    _close(back, np.fft.ifftn(re + 1j * im, axes=axes).real, 1e-11)
    _close(dft.inv_real(Z), U, 1e-11)


@DIMS
def test_cmatmul_lowerings_agree(case, monkeypatch):
    """``vpu`` and ``einsum`` give the same product (1e-13), each equals
    the complex NumPy product, and NS_TPU_BLOCK_APPLY selects."""
    rng = np.random.default_rng(6)
    nc, d = 2 ** case.dim, case.dim
    lead = case.sg.shape
    S = [rng.standard_normal(lead + (nc, nc)) for _ in range(2)]
    V = [rng.standard_normal(lead + (nc, d)) for _ in range(2)]
    want = (S[0] + 1j * S[1]) @ (V[0] + 1j * V[1])
    St, Vt = tuple(torch.tensor(a) for a in S), _tsplit(*V)
    out = {mode: tspec._cmatmul(St, Vt, mode=mode)
           for mode in ("vpu", "einsum")}
    for Z in out.values():
        _close(Z.re, want.real, 1e-13)
        _close(Z.im, want.imag, 1e-13)
    _both(out["vpu"], out["einsum"], 1e-13)
    _both(out["einsum"], jspec._cmatmul(
        tuple(jnp.asarray(a) for a in S), _jsplit(*V),
        "...ab,...bd->...ad"), 1e-13)
    monkeypatch.delenv("NS_TPU_BLOCK_APPLY", raising=False)
    assert torch.equal(tspec._cmatmul(St, Vt).re, out["vpu"].re)
    monkeypatch.setenv("NS_TPU_BLOCK_APPLY", "einsum")
    assert torch.equal(tspec._cmatmul(St, Vt).re, out["einsum"].re)
    monkeypatch.setenv("NS_TPU_BLOCK_APPLY", "vpu")
    assert torch.equal(tspec._cmatmul(St, Vt).re, out["vpu"].re)
    monkeypatch.setenv("NS_TPU_BLOCK_APPLY", "mxu")
    with pytest.raises(ValueError, match="NS_TPU_BLOCK_APPLY"):
        tspec._cmatmul(St, Vt)


@DIMS
@pytest.mark.parametrize("name", ["fwd_u", "inv_u", "fwd_p", "inv_p", "mass",
                                  "stiffness", "grad", "div",
                                  "helmholtz_solve", "mass_solve",
                                  "poisson_solve"])
def test_spectral_operator_matches_jax(case, name):
    """Every transform, apply and solve of SpectralOperators on the same
    spectral data against the JAX one: 1e-11 (solves on data, not P)."""
    ops, jo = case.ops, case.jops
    U, P = case.random(seed=7)
    rng = np.random.default_rng(8)
    lead, nc, d = case.sg.shape, 2 ** case.dim, case.dim
    uh = [rng.standard_normal(lead + (nc, d)) for _ in range(2)]
    ph = [rng.standard_normal(lead) for _ in range(2)]
    Uh, Uhj, Ph, Phj = _tsplit(*uh), _jsplit(*uh), _tsplit(*ph), _jsplit(*ph)
    if name == "fwd_u":
        got, want = ops.fwd_u(torch.tensor(U)), jo.fwd_u(jnp.asarray(U))
        assert got.re.shape == lead + (nc, d) and got.re.is_contiguous()
    elif name == "inv_u":
        got, want = ops.inv_u(Uh), jo.inv_u(Uhj)
    elif name == "fwd_p":
        got, want = ops.fwd_p(torch.tensor(P)), jo.fwd_p(jnp.asarray(P))
    elif name == "inv_p":
        got, want = ops.inv_p(Ph), jo.inv_p(Phj)
    elif name in ("mass", "stiffness", "div", "mass_solve"):
        got, want = getattr(ops, name)(Uh), getattr(jo, name)(Uhj)
    elif name in ("grad", "poisson_solve"):
        got, want = getattr(ops, name)(Ph), getattr(jo, name)(Phj)
    else:
        got = ops.helmholtz_solve(1.5 / DT, VISC, Uh)
        want = jo.helmholtz_solve(jnp.asarray(1.5 / DT), VISC, Uhj)
    if isinstance(got, tuple):
        _both(got, want, 1e-11)
    else:
        _close(got, want, 1e-11)


@DIMS
def test_spectral_solves_invert_the_stencils(case):
    """Inside the port: the eigenbasis solves undo the tap applies
    (Helmholtz and mass 1e-10, the mean-free Poisson 1e-9)."""
    sg, ops = case.sg, case.ops
    U, P = (torch.tensor(a) for a in case.random(seed=9))
    MU = apply_uu(sg.taps_uu(sg.M_tau), U)
    KU = apply_uu(sg.taps_uu(sg.K_tau), U)
    rec = ops.inv_u(ops.helmholtz_solve(0.4, 0.1,
                                        ops.fwd_u(0.4 * MU + 0.1 * KU)))
    _close(rec, U.numpy(), 1e-10)
    _close(ops.inv_u(ops.mass_solve(ops.fwd_u(MU))), U.numpy(), 1e-10)
    P = P - P.mean()
    LP = apply_pp(sg.taps_pp(sg.L_tau), P)
    _close(ops.inv_p(ops.poisson_solve(ops.fwd_p(LP))), P.numpy(), 1e-9)


@DIMS
def test_ops_numpy_round_trip(case):
    """spectral_ops_to_numpy reads either package's operators (equal to
    1e-13: the host setup is the same NumPy), and from_numpy restores
    them exactly."""
    d, dj = (tspec.spectral_ops_to_numpy(o) for o in (case.ops, case.jops))
    assert d.keys() == dj.keys() == {"Mhat", "Khat", "Ghat", "Dhat", "P",
                                     "PH", "lam", "Linv"}
    for name in ("Mhat", "Khat", "Ghat", "Dhat"):
        for a, b in zip(d[name], dj[name]):
            _close(a, b, 1e-13)
    _close(d["Linv"], dj["Linv"], 1e-13)
    back = tspec.spectral_ops_from_numpy(case.sg, d, device="cpu")
    assert back.rdtype == torch.float64 and back.sgrid is case.sg
    for name in ("Mhat", "P", "PH"):
        for a, b in zip(getattr(back, name), getattr(case.ops, name)):
            assert torch.equal(a, b)
    assert torch.equal(back.lam, case.ops.lam)
    bad = dict(d, lam=d["lam"][1:])
    with pytest.raises(ValueError, match="lam"):
        tspec.spectral_ops_from_numpy(case.sg, bad, device="cpu")


# ---------------------------------------------------------------------------
# the projection step
# ---------------------------------------------------------------------------

def _jax_steps(case, n_steps):
    step, init_state, read_state = jspec.build_spectral_projection_step(
        case.jsg, visc=VISC, dt=DT, dtype=jnp.float64)
    u0, p0 = case.flow()
    state = init_state(u0, u0, p0)
    for i in range(n_steps):
        a, e = ALPHAS[min(i, 1)], ETAS[min(i, 1)]
        state = step(state, tuple(jnp.asarray(v) for v in a),
                     tuple(jnp.asarray(v) for v in e))
    return read_state(state)


def _torch_steps(case, n_steps, **kw):
    step, init_state, read_state = build_spectral_projection_step(
        case.sg, visc=VISC, dt=DT, **kw)
    u0, p0 = case.flow()
    state = init_state(u0, u0, p0)
    for i in range(n_steps):
        old = state
        state = step(state, ALPHAS[min(i, 1)], ETAS[min(i, 1)])
        # the step shifts the state and leaves the old tensors alone
        assert state[1] is old[0] and state[3] is old[2]
    return read_state(state)


_JAX_RESULT = {}


@pytest.fixture
def jax_result(case):
    """4 JAX steps (BDF-1, then BDF-2), built and run once per dimension."""
    if case.dim not in _JAX_RESULT:
        _JAX_RESULT[case.dim] = _jax_steps(case, 4)
    return _JAX_RESULT[case.dim]


@DIMS
def test_step_matches_jax(case, jax_result):
    """4 steps against the JAX step: 1e-10 on u and p."""
    u, p = _torch_steps(case, 4, device="cpu")
    assert isinstance(u, np.ndarray) and u.dtype == np.float64
    assert u.shape == (case.space.n_velocity_dofs,)
    assert p.shape == (case.space.n_pnodes,)
    assert np.isfinite(u).all() and np.isfinite(p).all()
    np.testing.assert_allclose(u, jax_result[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(p, jax_result[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize("dim", [2])
def test_step_with_jax_symbols_matches_jax(case, jax_result):
    """The port's step on the JAX package's own symbols and eigenbasis,
    carried across as NumPy: 1e-10 on u and p."""
    ops = tspec.spectral_ops_from_numpy(
        case.sg, tspec.spectral_ops_to_numpy(case.jops), device="cpu")
    u, p = _torch_steps(case, 4, ops=ops)
    np.testing.assert_allclose(u, jax_result[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(p, jax_result[1], rtol=0, atol=1e-10)
    other = PeriodicStructuredTH(case.space)
    with pytest.raises(ValueError, match="another class grid"):
        build_spectral_projection_step(other, visc=VISC, dt=DT, ops=ops)


@pytest.mark.parametrize("dim", [2])
def test_step_size_argument(case):
    """``k`` overrides the built ``dt``: a step built with another dt and
    stepped with k = DT equals the step built with DT (exactly: the same
    floats reach the same ops)."""
    u0, p0 = case.flow()
    out = []
    for dt, k in ((DT, None), (3.0 * DT, DT)):
        step, init_state, read_state = build_spectral_projection_step(
            case.sg, visc=VISC, dt=dt, device="cpu")
        state = step(init_state(u0, u0, p0), ALPHAS[0], ETAS[0], k=k)
        out.append(read_state(state))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("dim", [2])
def test_spectral_step_matches_banded_step(case):
    """Inside the port: the spectral step and the banded planar step
    integrate the same scheme; with the CG run to 1e-13 they agree over 4
    steps to 1e-8 on u and 1e-7 on the mean-free p."""
    from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
    from navierstokes_tpu_torch.solvers.planar_step import \
        build_planar_projection_step

    u_sp, p_sp = _torch_steps(case, 4, device="cpu")

    fast = FastTaylorHood(case.space, device="cpu")
    step = build_planar_projection_step(fast.ops, visc=VISC, dt=DT,
                                        cg_iters=(200, 400, 120),
                                        cg_rtol=1e-13)
    u0, p0 = case.flow()
    u = fast.permute_velocity(torch.tensor(u0.reshape(-1, 2).T.copy()))
    p = fast.permute_pressure(torch.tensor(p0))
    state = (u, u, p, torch.zeros_like(p))
    for i in range(4):
        u_new, p_new, phi = step(*state, ALPHAS[min(i, 1)], ETAS[min(i, 1)])
        state = (u_new, state[0], p_new, phi)
    u_b = fast.unpermute_velocity(state[0]).numpy().T.reshape(-1)
    p_b = fast.unpermute_pressure(state[2]).numpy()
    scale = np.abs(u_b).max()
    np.testing.assert_allclose(u_sp, u_b, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(p_sp - p_sp.mean(), p_b - p_b.mean(), rtol=0,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# device policy and what is left out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["SpectralOperators",
                                   "StructuredConvection",
                                   "build_spectral_projection_step",
                                   "spectral_ops_from_numpy"])
def test_entry_points_raise_without_a_card(entry):
    """No ``device`` means the card; without one the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    case = _case(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "SpectralOperators":
            SpectralOperators(case.sg)
        elif entry == "StructuredConvection":
            StructuredConvection(case.sg)
        elif entry == "build_spectral_projection_step":
            build_spectral_projection_step(case.sg, visc=VISC, dt=DT)
        else:
            tspec.spectral_ops_from_numpy(
                case.sg, tspec.spectral_ops_to_numpy(case.ops))


def test_cpu_dtype_policy():
    """float64 is the CPU default, float32 may be asked for, anything else
    is refused."""
    case = _case(2)
    assert case.ops.rdtype == torch.float64
    conv = StructuredConvection(case.sg, dtype=torch.float32, device="cpu")
    assert conv.N2.dtype == torch.float32
    with pytest.raises(TypeError):
        SpectralOperators(case.sg, dtype=torch.float16, device="cpu")


def test_shard_spectral_step_not_ported():
    """Ported (item 15): 4 steps over 2 CPU shards equal the unsharded
    step's (tests/test_torch_spectral_sharded.py holds the rest)."""
    from navierstokes_tpu_torch.parallel.sharded import device_mesh

    case = _case(2)
    step, init, read = tspec.build_spectral_projection_step(
        case.sg, visc=0.01, dt=1e-3, device="cpu")
    sharded, shard_state = tspec.shard_spectral_step(
        step, case.sg, device_mesh(2, device="cpu"))
    u0 = np.random.default_rng(3).standard_normal(
        case.sg.space.n_velocity_dofs)
    p0 = np.zeros(case.sg.space.n_pnodes)
    one, two = init(u0, u0, p0), shard_state(init(u0, u0, p0))
    for _ in range(4):
        one = step(one, (1.5, -2.0, 0.5), (2.0, -1.0))
        two = sharded(two, (1.5, -2.0, 0.5), (2.0, -1.0))
    for a, b in zip(read(one), read(sharded.gather_state(two))):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-12 * np.abs(a).max())
