"""Boundary-condition taxonomy and weak-form variants.

Same typed taxonomy as the reference (source/ns_solver_base.py:16-56):
velocity/pressure/traction BC kinds plus the convective- and viscous-term
weak-form variants after John (2016), pp. 307-308.

BCs are *specified* exactly like in the reference, as tuples

    (BCType, boundary_id, value)                 full-field constraint
    (BCType, boundary_id, component, value)      single-component constraint

where ``value`` is ``None`` (homogeneous), a float / tuple of floats
(constant), or a Python callable ``f(x)`` / ``f(x, t)`` evaluated at node
coordinates (replacing dolfin ``Expression`` strings).  Compilation of these
specs into device-resident dof index/value arrays lives in
``fem.dirichlet``.
"""

from __future__ import annotations

from enum import Enum, auto


class VelocityBCType(Enum):
    no_slip = auto()
    no_normal_flux = auto()
    no_tangential_flux = auto()
    constant = auto()
    constant_component = auto()
    function = auto()
    function_component = auto()


class PressureBCType(Enum):
    constant = auto()
    function = auto()
    mean_value = auto()


class TractionBCType(Enum):
    constant = auto()
    constant_component = auto()
    function = auto()
    function_component = auto()
    free = auto()


class WeakFormConvectiveTerm(Enum):
    """Convective-term weak forms after John (2016), pp. 307-308."""
    standard_form = auto()
    rotational_form = auto()
    divergence_form = auto()
    skew_symmetric_form = auto()


class WeakFormViscousTerm(Enum):
    """Viscous-term weak forms: grad-grad vs. symmetric-gradient (traction)."""
    reduced_form = auto()
    traction_form = auto()


_CONVECTIVE_FORMS = {
    "standard": WeakFormConvectiveTerm.standard_form,
    "rotational": WeakFormConvectiveTerm.rotational_form,
    "divergence": WeakFormConvectiveTerm.divergence_form,
    "skew_symmetric": WeakFormConvectiveTerm.skew_symmetric_form,
}

_VISCOUS_FORMS = {
    # "standard" is an accepted alias of the reduced grad-grad form,
    # matching the reference's constructor (ns_solver_base.py:110-115)
    "standard": WeakFormViscousTerm.reduced_form,
    "reduced": WeakFormViscousTerm.reduced_form,
    "traction": WeakFormViscousTerm.traction_form,
}


def parse_convective_form(name) -> WeakFormConvectiveTerm:
    if isinstance(name, WeakFormConvectiveTerm):
        return name
    key = str(name).lower()
    if key not in _CONVECTIVE_FORMS:
        raise ValueError(f"unknown convective form {name!r}; "
                         f"expected one of {sorted(_CONVECTIVE_FORMS)}")
    return _CONVECTIVE_FORMS[key]


def parse_viscous_form(name) -> WeakFormViscousTerm:
    if isinstance(name, WeakFormViscousTerm):
        return name
    key = str(name).lower()
    if key not in _VISCOUS_FORMS:
        raise ValueError(f"unknown viscous form {name!r}; "
                         f"expected one of {sorted(_VISCOUS_FORMS)}")
    return _VISCOUS_FORMS[key]
