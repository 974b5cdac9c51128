"""The AMG-preconditioned Poisson solve in one launch
(``assembly/cuda_amg.py``, ``csrc/amg_pcg.cu``) on the CPU.

CPU tensors take the plain version, which is ``_pcg`` with ``AMG.apply``
as the planar step called it: the same bits.  The step that dispatches to
it still matches the JAX package's planar step with its AMG (float64,
1e-10 of each field's largest entry).  The dispatch
takes the fused path for the hierarchy ``build_poisson_amg`` built, mean
free and masked, without a tolerance, and keeps ``_pcg`` otherwise.  The
plan is a pure function of the shapes; its descriptor's layout is read
against the kernel's source.  The kernel itself runs on the card only
(``chip_smoke.py``, phase ``kernels``).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import FastTaylorHood as JaxFast
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_build_step
from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.assembly import cuda_amg
from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.setups import (lid_driven_cavity_setup,
                                           taylor_green_setup)
from navierstokes_tpu_torch.solvers.planar_step import (
    _inv, _pcg, build_planar_projection_step, build_poisson_amg)

ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]
ATOL_STEP = 1e-10

_SPACES = {}


def _space(kind, n):
    key = (kind, n)
    if key not in _SPACES:
        if kind == "torus":
            _SPACES[key] = taylor_green_setup(n)[0]
        else:
            _SPACES[key] = TaylorHoodSpace(lid_driven_cavity_setup(n)[0])
    return _SPACES[key]


def _outflow(space, fast):
    """Prescribed pressure on the wall x = 1, permuted (a DFG-style
    outflow)."""
    mask = np.zeros(space.n_pnodes, bool)
    mask[np.abs(space.p_coords[:, 0] - 1.0) < 1e-12] = True
    return mask[fast.permP]


def _system(kind, n, dtype):
    """``(fast, amg, mask, b, x0)`` of one Poisson solve of the step."""
    space = _space("torus" if kind == "torus" else "cavity", n)
    fast = FastTaylorHood(space, dtype=dtype, device="cpu")
    pmask = _outflow(space, fast) if kind == "cavity_masked" else None
    amg = build_poisson_amg(fast, pmask)
    mask = None if pmask is None else \
        torch.tensor(np.where(pmask, 0.0, 1.0), dtype=dtype)
    rng = np.random.default_rng(n)
    b, x0 = (torch.tensor(rng.standard_normal(space.n_pnodes), dtype=dtype)
             for _ in range(2))
    if mask is None:
        b, x0 = b - b.mean(), x0 - x0.mean()
    else:
        b, x0 = mask * b, mask * x0
    return fast, amg, mask, b, x0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("kind", ["cavity", "torus", "cavity_masked"])
def test_plain_path_gives_the_steps_bits(kind, n, dtype):
    """On CPU tensors the wrapper is ``_step_core``'s former call:
    ``_pcg(A', b, x0, iters, inv_diag, project, precond_fn=amg.apply)``."""
    fast, amg, mask, b, x0 = _system(kind, n, dtype)
    if mask is None:
        def stiff(v):
            return fast.L.apply(v)

        def project(r):
            return r - r.mean()
    else:
        def stiff(v):
            return mask * fast.L.apply(mask * v) + (1.0 - mask) * v

        def project(r):
            return mask * r

    cudalib.reset_launch_counts()
    for iters in (0, 1, 7):
        want = _pcg(stiff, b, x0, iters, inv_diag=_inv(fast.ops.diag_l),
                    project=project, precond_fn=amg.apply)
        got = cuda_amg.amg_pcg(amg, fast.L, b, x0, mask, iters)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the residual fell: the solve converges
    assert float(got[1].norm()) < 1e-2 * float(b.norm())
    assert cudalib.LAUNCHES["amg_pcg"] == 0


def _spy(monkeypatch):
    """Count the step's calls of the wrapper as the card counts its
    launches (CPU tensors launch nothing)."""
    real = cuda_amg.amg_pcg

    def counted(*args):
        cudalib.LAUNCHES["amg_pcg"] += 1
        return real(*args)

    monkeypatch.setattr(cuda_amg, "amg_pcg", counted)
    cudalib.reset_launch_counts()


def _steps(step, fast, n_steps=3):
    space = fast.space
    rng = np.random.default_rng(5)
    u = fast.permute_velocity(torch.tensor(
        1e-2 * rng.standard_normal((2, space.n_unodes)),
        dtype=fast.dtype))
    p = torch.zeros(space.n_pnodes, dtype=fast.dtype)
    state = [u, u, p, torch.zeros_like(p)]
    for i in range(n_steps):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        un, pn, phi = step(state[0], state[1], state[2], state[3], a, e)[:3]
        state = [un, state[0], pn, phi]
    return state


@pytest.mark.parametrize("masked", [False, True])
def test_step_with_amg_matches_jax(masked, monkeypatch):
    """The step with ``poisson_precond="amg"`` and no tolerance takes the
    fused solve and matches the JAX package's step with its AMG."""
    n = 16
    js, ts = JaxSpace(jax_hyper_cube(2, n)[0]), \
        TaylorHoodSpace(hyper_cube(2, n)[0])
    jf, tf = JaxFast(js), FastTaylorHood(ts, device="cpu")
    pmask = _outflow(ts, tf) if masked else None
    kw = dict(visc=0.01, dt=1e-3, cg_iters=(8, 20, 6), with_residuals=True,
              pres_bc_mask=pmask, poisson_precond="amg")
    step_j, step_t = jax_build_step(jf, **kw), \
        build_planar_projection_step(tf, **kw)
    _spy(monkeypatch)
    rng = np.random.default_rng(7)
    u0 = 1e-2 * rng.standard_normal((2, ts.n_unodes))
    uj = jf.permute_velocity(jnp.asarray(u0))
    ut = torch.tensor(np.asarray(uj))
    sj = [uj, uj, jnp.zeros(ts.n_pnodes), jnp.zeros(ts.n_pnodes)]
    st = [ut, ut, torch.zeros(ts.n_pnodes, dtype=torch.float64),
          torch.zeros(ts.n_pnodes, dtype=torch.float64)]
    for i in range(3):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        un, p, phi, rj = step_j(*sj, tuple(jnp.asarray(v) for v in a),
                                tuple(jnp.asarray(v) for v in e))
        sj = [un, sj[0], p, phi]
        un, p, phi, rt = step_t(*st, a, e)
        st = [un, st[0], p, phi]
    # the random velocity makes p and phi O(1e5): 1e-10 of each field's
    # largest entry
    for got, want in zip(st, sj):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_STEP
                                   * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-13)
    assert cudalib.launched() == {"amg_pcg": 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["meanfree", "masked", "rtol", "callable",
                                  "no_fit"])
def test_dispatch(case, dtype, monkeypatch):
    """One fused solve per step with the step's own AMG and no tolerance,
    mean free or masked; ``_pcg`` with a tolerance, with a callable
    preconditioner, and where the plan does not fit."""
    space = _space("cavity", 16)
    fast = FastTaylorHood(space, dtype=dtype, device="cpu")
    kw = dict(visc=1e-3, dt=1e-3, cg_iters=(8, 12, 6))
    if case == "masked":
        kw["pres_bc_mask"] = _outflow(space, fast)
    if case == "rtol":
        kw["cg_rtol"] = 1e-6
    if case == "callable":
        inv_l = _inv(fast.ops.diag_l)
        kw["poisson_precond"] = lambda r: inv_l * r
    else:
        kw["poisson_precond"] = "amg"
    if case == "no_fit":
        monkeypatch.setattr(cuda_amg, "amg_pcg_plan",
                            lambda *args: None)
    step = build_planar_projection_step(fast, **kw)
    _spy(monkeypatch)
    state = _steps(step, fast)
    assert all(torch.isfinite(t).all() for t in state)
    fused = case in ("meanfree", "masked")
    assert cudalib.LAUNCHES["amg_pcg"] == (3 if fused else 0)
    # the builder decided: the step carries its hierarchy, and p_precond
    # stays the bound AMG.apply (chip_smoke.py reads its __self__)
    if fused:
        assert step.static["p_amg"] is step.static["p_precond"].__self__
    else:
        assert step.static["p_amg"] is None


def test_prepare_packs_what_fits(monkeypatch):
    """``prepare`` takes a hierarchy on a ``CirculantBand`` of its size
    whose layout fits, and packs it then, so that no capture reads the
    host; it refuses another operator, a band of another size, a
    hierarchy without levels and a layout that does not fit."""
    fast, amg, _, _, _ = _system("cavity", 16, torch.float64)
    other, amg2, _, _, _ = _system("cavity", 32, torch.float64)
    assert cuda_amg.prepare(amg, fast.L, torch.float64, False) is amg
    assert cuda_amg._PACKS[amg].shape.K == len(fast.L.offsets)
    assert cuda_amg.prepare(amg2, fast.L, torch.float64, False) is None
    assert amg2 not in cuda_amg._PACKS
    assert cuda_amg.prepare(amg, fast.ops.D[0], torch.float64,
                            False) is None
    bare = build_poisson_amg(fast, None, coarse_size=10 ** 6)
    assert not bare.levels
    assert cuda_amg.prepare(bare, fast.L, torch.float64, False) is None
    monkeypatch.setattr(cuda_amg, "amg_pcg_plan", lambda *args: None)
    assert cuda_amg.prepare(amg2, other.L, torch.float64, True) is None


CAVITY_128 = cuda_amg.Shape(
    16641, 7, 6, 130, 385, ((2827, 17, 11, 130, 277), (330, 22, 11, 48, 117)),
    41)
OUTFLOW_128 = cuda_amg.Shape(
    16641, 7, 6, 130, 259, ((2924, 13, 10, 91, 230), (459, 20, 12, 65, 146)),
    172)
TORUS_128 = cuda_amg.Shape(
    16384, 9, 8, 129, 346, ((2720, 15, 12, 129, 230), (314, 25, 13, 48, 167)),
    36)


@pytest.mark.parametrize("shape,dtype,masked,ndist,pinv_shared", [
    (CAVITY_128, torch.float32, False, 2, True),
    (CAVITY_128, torch.float32, True, 2, True),
    (CAVITY_128, torch.float64, False, 3, True),
    (CAVITY_128, torch.float64, True, 3, True),
    (OUTFLOW_128, torch.float32, True, 2, False),
    (OUTFLOW_128, torch.float64, True, 3, False),
    (TORUS_128, torch.float32, False, 2, True),
])
def test_plan(shape, dtype, masked, ndist, pinv_shared):
    """The 128^2 cavity's hierarchies (``build_poisson_amg`` at that size,
    mean free and with an outflow wall) and the 128^2 torus's (its levels
    periodic: distances go round) fit one cluster: the fewest
    distributed levels first, the coarse pseudo-inverse in shared memory
    where it fits; every offset lies inside the layout."""
    plan = cuda_amg.amg_pcg_plan(shape, dtype, masked)
    assert plan.ndist == ndist
    assert plan.smem_bytes <= cudalib.SMEM_PER_BLOCK - cuda_amg.SMEM_STATIC
    assert len(plan.fields) == len(shape.levels) + 2
    s_vals = cuda_amg.FIELDS.index("s_vals")
    assert (plan.fields[-1][s_vals] >= 0) == pinv_shared
    offsets = list(plan.header) + [v for f in plan.fields for name, v in
                                   zip(cuda_amg.FIELDS, f)
                                   if name.startswith("s_")]
    assert all(-1 <= o < plan.smem_bytes and o % 16 == 0 or o == -1
               for o in offsets)
    s_mask = plan.header[cuda_amg.HEADER.index("s_mask") - 3]
    assert (s_mask >= 0) == masked
    assert cuda_amg.amg_pcg_plan(shape, dtype, masked) is plan
    rows = cuda_amg.FIELDS.index("rows")
    ns = [shape.n] + [lv[0] for lv in shape.levels] + [shape.coarse]
    assert [f[rows] for f in plan.fields] == [-(-n // 16) for n in ns]


def test_plan_refuses_what_does_not_fit():
    wide = CAVITY_128._replace(levels=((2827, 40, 11, 130, 277),
                                       (330, 22, 11, 48, 117)))
    big = CAVITY_128._replace(n=16641 * 16)
    deep = CAVITY_128._replace(levels=((2827, 17, 11, 130, 277),) * 7)
    for shape in (wide, big, deep):
        assert cuda_amg.amg_pcg_plan(shape, torch.float32, False) is None


def test_owner_magic_divides():
    """``__umulhi(j, magic) == j // rows`` for every row j of a level."""
    for rows in (2, 3, 21, 177, 1041, 2049, 16383):
        m = cuda_amg._magic(rows) % 2 ** 32
        j = np.arange(16 * rows, dtype=np.uint64)
        assert np.array_equal((j * np.uint64(m)) >> np.uint64(32),
                              j // np.uint64(rows))


def test_descriptor_matches_the_kernel_source():
    """``HEADER``, ``FIELDS`` and the constants are ``amg_pcg.cu``'s."""
    src = (cudalib.CSRC / "amg_pcg.cu").read_text()

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        return [w.strip() for w in body.split(",") if w.strip()]

    header = enum("Header")
    assert header[-1] == "kHeader"
    assert [h.lower() for h in header[:-1]] == [
        "k" + h.replace("_", "") for h in cuda_amg.HEADER]
    fields = enum("Field")
    assert fields[-1] == "kFields"
    assert [f.lower() for f in fields[:-1]] == [
        "k" + f.replace("_", "") for f in cuda_amg.FIELDS]
    for const, value in (("kThreads", cuda_amg.THREADS),
                         ("kCtas", cuda_amg.CTAS),
                         ("kMaxLevels", cuda_amg.MAX_LEVELS),
                         ("kMaxWidth", cuda_amg.MAX_WIDTH)):
        assert re.search(r"constexpr int %s = %d;" % (const, value), src)
    fast, amg, mask, b, x0 = _system("cavity", 16, torch.float32)
    packed = cuda_amg._packed(amg, fast.L)
    plan = cuda_amg.amg_pcg_plan(packed.shape, torch.float32, False)
    desc = list(cuda_amg._descriptor(plan, packed.goff, 30))
    assert desc[:3] == [len(packed.shape.levels) + 1, plan.ndist, 30]
    assert len(desc) == len(header) - 1 + len(plan.fields) * (len(fields) - 1)
