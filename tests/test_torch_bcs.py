"""Port parity: boundary conditions, coefficients, rotation and the monitor
(fem/bcs.py, fem/dirichlet.py, the facet machinery of mesh/core.py and
fem/spaces.py, problems/, utils/monitor.py).

All of this is host NumPy or pure Python in both packages, so everything
must be EQUAL: constrained dofs and values with ``np.array_equal``, facet
tables with ``np.array_equal``, pure-Python results with ``==``.
"""

import math

import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import bcs as jbcs
from navierstokes_tpu.fem.dirichlet import \
    compile_dirichlet_bcs as jax_compile
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu.mesh.core import boundary_normal as jax_boundary_normal
from navierstokes_tpu.mesh.core import \
    extract_all_boundary_markers as jax_all_markers
from navierstokes_tpu.problems import \
    AngularVelocityVector as JaxAngularVelocity
from navierstokes_tpu.problems import \
    EquationCoefficientHandler as JaxCoefficients
from navierstokes_tpu.problems import FunctionTime as JaxFunctionTime
from navierstokes_tpu_torch.fem import bcs as tbcs
from navierstokes_tpu_torch.fem.dirichlet import (compile_dirichlet_bcs,
                                                  validate_bc_format)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers as M,
                                         boundary_normal,
                                         extract_all_boundary_markers,
                                         hyper_cube, hyper_rectangle)
from navierstokes_tpu_torch.problems import (AngularVelocityVector,
                                             EquationCoefficientHandler,
                                             FunctionTime)
from navierstokes_tpu_torch.utils.monitor import SolverMonitor


def _both(dim):
    if dim == 2:
        (jm, jk), (tm, tk) = jax_hyper_rectangle((0, 0), (2, 1), (6, 4)), \
            hyper_rectangle((0, 0), (2, 1), (6, 4))
    else:
        (jm, jk), (tm, tk) = jax_hyper_cube(3, 2), hyper_cube(3, 2)
    return (JaxSpace(jm), jk), (TaylorHoodSpace(tm), tk)


_SPACES = {}


def _spaces(dim):
    if dim not in _SPACES:
        _SPACES[dim] = _both(dim)
    return _SPACES[dim]


def _vec(x, t=None):
    t = 0.0 if t is None else t
    return np.stack([x[:, 1] * (1.0 + t)] + [0.5 * x[:, 0]]
                    * (x.shape[1] - 1), axis=1)


def _comp(x, t=None):
    return x[:, 0] + (0.0 if t is None else t)


def _pfun(x):
    return 5.0 * x[:, 1]


# (name, velocity BCs, pressure BCs) as (type name, id, *rest)
SPECS = [
    ("no_slip", [("no_slip", M.left.value, None)], []),
    ("no_normal_flux", [("no_normal_flux", M.left.value, None)], []),
    ("no_tangential_flux", [("no_tangential_flux", M.top.value, None)], []),
    ("constant_and_component",
     [("constant", M.top.value, None),          # value filled per dim
      ("constant_component", M.bottom.value, 1, 3.0)], []),
    ("functions_in_time",
     [("function", M.left.value, _vec),
      ("function_component", M.top.value, 0, _comp)], []),
    ("last_wins_on_corners",
     [("no_slip", M.left.value, None), ("function", M.top.value, _vec)],
     []),
    ("pressure",
     [("no_slip", M.bottom.value, None)],
     [("constant", M.right.value, 7.0), ("function", M.left.value, _pfun),
      ("mean_value", None, 1.5)]),
]


def _typed(mod, enum, spec, dim):
    out = []
    for name, bid, *rest in spec:
        if name == "constant" and enum == "VelocityBCType":
            rest = [tuple(float(i + 1) for i in range(dim))]
        out.append((getattr(getattr(mod, enum), name), bid, *rest))
    return out


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name,vel,pres", SPECS, ids=[s[0] for s in SPECS])
def test_compiled_bcs_equal(dim, name, vel, pres):
    (js, jk), (ts, tk) = _spaces(dim)
    jb, jmean = jax_compile(js, jk, _typed(jbcs, "VelocityBCType", vel, dim),
                            _typed(jbcs, "PressureBCType", pres, dim))
    tb, tmean = compile_dirichlet_bcs(
        ts, tk, _typed(tbcs, "VelocityBCType", vel, dim),
        _typed(tbcs, "PressureBCType", pres, dim))
    assert jmean == tmean
    assert len(tb.dofs) > 0
    assert np.array_equal(tb.dofs, jb.dofs)
    assert tb.time_dependent == jb.time_dependent
    for t in (None, 0.0, 2.0):
        assert np.array_equal(tb.values(t), jb.values(t))


@pytest.mark.parametrize("dim", [2, 3])
def test_facet_machinery_equal(dim):
    (js, jk), (ts, tk) = _spaces(dim)
    jm, tm = js.mesh, ts.mesh
    ids = tk.ids_with_value(M.top.value)
    assert np.array_equal(ids, jk.ids_with_value(M.top.value))
    assert np.array_equal(tm.facet_midpoints(), jm.facet_midpoints())
    assert np.array_equal(tm.facet_areas(), jm.facet_areas())
    ext = tm.exterior_facet_ids
    assert np.array_equal(tm.facet_outward_normals(ext),
                          jm.facet_outward_normals(ext))
    assert extract_all_boundary_markers(tm, tk) == jax_all_markers(jm, jk)
    for face in (M.left, M.right, M.bottom, M.top):
        assert boundary_normal(tm, tk, face.value) == \
            jax_boundary_normal(jm, jk, face.value)
    assert np.array_equal(ts.facet_unodes(ids), js.facet_unodes(ids))
    assert np.array_equal(ts.facet_pnodes(ids), js.facet_pnodes(ids))
    jb, tb = js.facet_batch(ids), ts.facet_batch(ids)
    assert jb.keys() == tb.keys()
    for key in jb:
        assert np.array_equal(tb[key], jb[key]), key
    nodes = np.arange(5)
    assert np.array_equal(ts.velocity_dof(nodes, 1), js.velocity_dof(nodes, 1))
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ts.n_unodes, dim))
    p = rng.standard_normal(ts.n_pnodes)
    assert np.array_equal(ts.join(u, p), np.asarray(js.join(u, p)))
    assert torch.equal(ts.join(torch.tensor(u), torch.tensor(p)),
                       torch.tensor(ts.join(u, p)))
    assert np.array_equal(ts.vertex_velocity(u), js.vertex_velocity(u))
    assert np.array_equal(ts.vertex_pressure(p), js.vertex_pressure(p))


def test_bc_enums_and_form_parsers_equal():
    for enum in ("VelocityBCType", "PressureBCType", "TractionBCType",
                 "WeakFormConvectiveTerm", "WeakFormViscousTerm"):
        je, te = getattr(jbcs, enum), getattr(tbcs, enum)
        assert [(m.name, m.value) for m in te] == \
            [(m.name, m.value) for m in je]
    for form in ("standard", "rotational", "divergence", "skew_symmetric"):
        assert tbcs.parse_convective_form(form).name == \
            jbcs.parse_convective_form(form).name
    for form in ("reduced", "traction"):
        assert tbcs.parse_viscous_form(form).name == \
            jbcs.parse_viscous_form(form).name


def test_validate_bc_format_refuses_malformed_specs():
    (_, _), (ts, tk) = _spaces(2)
    V, P = tbcs.VelocityBCType, tbcs.PressureBCType
    validate_bc_format((V.no_slip, M.left.value, None), 2, tk, ts.mesh)
    validate_bc_format((V.constant_component, M.left.value, 1, 2.0), 2, tk,
                       ts.mesh)
    validate_bc_format((P.constant, M.right.value, 0.0), 2, tk, ts.mesh)
    for bad in ((V.constant, M.left.value, (1.0, 2.0, 3.0)),   # wrong dim
                (V.constant_component, M.left.value, 5, 1.0),  # component
                (V.no_slip, 99, None)):                        # unknown id
        with pytest.raises((AssertionError, ValueError)):
            validate_bc_format(bad, 2, tk, ts.mesh)


COEFFS = [dict(Re=25.0), dict(Reynolds=100.0, Froude=2.0),
          dict(Re=1000.0, Ro=2.0), dict(Ro=2.0, Ek=0.5),
          dict(Ek=0.1, Re=10.0), dict(Ek=0.25), dict(Ro=4.0)]


@pytest.mark.parametrize("kw", COEFFS, ids=[str(sorted(k)) for k in COEFFS])
def test_equation_coefficients_equal(kw):
    jh, th = JaxCoefficients(**kw), EquationCoefficientHandler(**kw)
    assert th.equation_coefficients == jh.equation_coefficients
    assert th.get_file_suffix() == jh.get_file_suffix()
    assert str(th) == str(jh)


def test_coefficient_handler_rules():
    h = EquationCoefficientHandler(Re=1.0, Ro=1.0, Ek=1.0)
    with pytest.raises(RuntimeError):
        _ = h.equation_coefficients
    h = EquationCoefficientHandler(Re=100.0)
    h.close()
    with pytest.raises(RuntimeError):
        h.Re = 50.0
    h.modify_dimensionless_number("Re", 50.0)
    assert h.Re == 50.0 and h.get_file_suffix() == "_Re5.000e+01"


def _spin_up(base):
    class SpinUp(base):
        def __init__(self):
            super().__init__(1)

        def value(self):
            return math.tanh(self.current_time)

        def derivative(self):
            return 1.0 - math.tanh(self.current_time) ** 2

    return SpinUp()


def test_angular_velocity_equal():
    jo = JaxAngularVelocity(2, function=_spin_up(JaxFunctionTime))
    to = AngularVelocityVector(2, function=_spin_up(FunctionTime))
    for t in (None, 0.5, 1.0):
        if t is not None:
            jo.set_time(t)
            to.set_time(t)
        assert (to.space_dim, to.value, to.derivative) == \
            (jo.space_dim, jo.value, jo.derivative)


def test_monitor_keeps_tensors_until_read():
    """A recorded tensor stays a tensor (no read inside the step) and comes
    back as floats when a record is asked for."""
    mon = SolverMonitor()
    res = torch.tensor([1e-3, 2e-3, 3e-3])
    mon.record("linear_solve", residual=res.max(), residuals=res,
               label="projection-cg")
    assert mon.records[-1]["residuals"] is res
    rec = mon.last("linear_solve")
    assert rec["residual"] == pytest.approx(3e-3)
    assert rec["residuals"] == pytest.approx([1e-3, 2e-3, 3e-3])
    assert rec["label"] == "projection-cg"
