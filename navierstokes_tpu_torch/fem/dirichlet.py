"""Compilation of Dirichlet boundary conditions into dof/value arrays.

Replaces dolfin DirichletBC construction (reference:
source/ns_solver_base.py:546-660): each BC spec tuple is resolved at setup
into the affected global mixed-dof indices plus a value provider.  At solve
time ``values(t)`` produces a flat array aligned with ``dofs`` -- for
time-dependent inflow profiles this is re-evaluated on the host each step
(boundary-sized work) and fed to the step as a plain array
(this replaces the mutate-``Expression.t`` protocol,
reference ns_solver_base.py:1033-1104).

Application semantics downstream (assembly layer):
  * solution vectors carry the BC values at ``dofs``;
  * residuals are masked to ``x[dofs] - g`` there (SystemAssembler parity);
  * Jacobian rows/columns are replaced by identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from navierstokes_tpu_torch.fem.bcs import (PressureBCType, TractionBCType,
                                      VelocityBCType)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, _eval_field
from navierstokes_tpu_torch.mesh.core import FacetMarkers, boundary_normal


@dataclass
class _BCEntry:
    dofs: np.ndarray          # global mixed dof indices
    coords: np.ndarray        # node coordinates, one row per dof
    value: object             # None | float | tuple | callable
    component: int | None     # velocity component (None = evaluate vector fn)
    is_pressure: bool

    def evaluate(self, t, dim) -> np.ndarray:
        if self.value is None:
            return np.zeros(len(self.dofs))
        if self.is_pressure or self.component is not None:
            if callable(self.value):
                vals = _eval_field(self.value, self.coords, t, None)
                return np.asarray(vals).reshape(-1)
            return np.full(len(self.dofs), float(self.value))
        vals = _eval_field(self.value, self.coords, t, dim)
        return np.asarray(vals).reshape(-1)


@dataclass
class CompiledDirichletBCs:
    """Unique constrained dofs + value provider (last-written-wins merge)."""

    dofs: np.ndarray                       # (nd,) int32, unique, sorted
    entries: list = field(default_factory=list)
    dim: int = 2
    time_dependent: bool = False

    def values(self, t=None) -> np.ndarray:
        out = np.zeros(len(self.dofs))
        for entry in self.entries:
            # ``dofs`` is sorted and unique and holds every entry's dofs
            out[np.searchsorted(self.dofs, entry.dofs)] = \
                entry.evaluate(t, self.dim)
        return out


def _axis_aligned_normal_component(space, markers, bndry_id):
    """Axis index of the (required axis-aligned) boundary normal."""
    normal = np.array(boundary_normal(space.mesh, markers, bndry_id))
    comp = int(np.abs(normal).argmax())
    if abs(abs(normal[comp]) - 1.0) > 5.0e-15 or any(
            abs(normal[d]) > 5.0e-15 for d in range(space.dim) if d != comp):
        raise AssertionError(
            "no_normal/tangential_flux requires an axis-aligned boundary")
    return comp


def compile_dirichlet_bcs(space: TaylorHoodSpace, markers: FacetMarkers,
                          velocity_bcs=(), pressure_bcs=()):
    """Compile velocity+pressure Dirichlet specs for the mixed space.

    Returns ``(compiled, mean_pressure_value)``; the latter is not a
    Dirichlet constraint but the target mean of a
    ``PressureBCType.mean_value`` spec (reference ns_solver_base.py:655-658).
    """
    dim = space.dim
    entries: list[_BCEntry] = []
    time_dependent = False
    mean_pressure_value = None

    def velocity_entry(node_ranks, component, value):
        nonlocal time_dependent
        coords = space.u_coords[node_ranks]
        if component is None:
            # node-major/component-minor: matches (n, dim).ravel() evaluation
            dofs = (node_ranks[:, None] * dim
                    + np.arange(dim)[None, :]).reshape(-1)
        else:
            dofs = node_ranks * dim + component
        if callable(value):
            time_dependent = True
        entries.append(_BCEntry(dofs.astype(np.int64), coords, value,
                                component if component is not None else None,
                                False))

    for bc in velocity_bcs:
        if len(bc) == 3:
            bc_type, bndry_id, value = bc
            component = None
        else:
            bc_type, bndry_id, component, value = bc
        facet_ids = markers.ids_with_value(bndry_id)
        assert len(facet_ids) > 0, f"no facets carry marker {bndry_id}"
        nodes = space.facet_unodes(facet_ids)

        if bc_type is VelocityBCType.no_slip:
            velocity_entry(nodes, None, None)
        elif bc_type is VelocityBCType.no_normal_flux:
            comp = _axis_aligned_normal_component(space, markers, bndry_id)
            velocity_entry(nodes, comp, None)
        elif bc_type is VelocityBCType.no_tangential_flux:
            comp = _axis_aligned_normal_component(space, markers, bndry_id)
            for other in range(dim):
                if other != comp:
                    velocity_entry(nodes, other, None)
        elif bc_type is VelocityBCType.constant:
            assert isinstance(value, (tuple, list)) and len(value) == dim
            velocity_entry(nodes, None, tuple(float(v) for v in value))
        elif bc_type is VelocityBCType.constant_component:
            velocity_entry(nodes, int(component), float(value))
        elif bc_type is VelocityBCType.function:
            velocity_entry(nodes, None, value)
        elif bc_type is VelocityBCType.function_component:
            velocity_entry(nodes, int(component), value)
        else:  # pragma: no cover
            raise RuntimeError(f"unhandled velocity BC type {bc_type}")

    for bc in pressure_bcs:
        bc_type, bndry_id, value = bc
        if bc_type is PressureBCType.mean_value:
            assert bndry_id is None
            mean_pressure_value = float(value)
            continue
        facet_ids = markers.ids_with_value(bndry_id)
        assert len(facet_ids) > 0, f"no facets carry marker {bndry_id}"
        nodes = space.facet_pnodes(facet_ids)
        dofs = space.pressure_offset + nodes.astype(np.int64)
        coords = space.p_coords[nodes]
        if callable(value):
            time_dependent = True
        elif value is not None:
            value = float(value)
        entries.append(_BCEntry(dofs, coords, value, None, True))

    if entries:
        all_dofs = np.unique(np.concatenate([e.dofs for e in entries]))
    else:
        all_dofs = np.empty(0, dtype=np.int64)
    compiled = CompiledDirichletBCs(all_dofs.astype(np.int32), entries, dim,
                                    time_dependent)
    return compiled, mean_pressure_value


def validate_bc_format(bc, space_dim, markers: FacetMarkers,
                       mesh, internal_constraint=False):
    """Structural validation of one BC spec tuple.

    Parity with ns_solver_base.py:302-368 (adapted: values may be floats,
    tuples, or callables instead of dolfin Expressions).
    """
    from navierstokes_tpu_torch.mesh.core import extract_all_boundary_markers

    assert isinstance(bc, (list, tuple)) and len(bc) >= 2
    assert isinstance(bc[0], (VelocityBCType, PressureBCType, TractionBCType))
    rank = 0 if isinstance(bc[0], PressureBCType) else 1

    if bc[0] is not PressureBCType.mean_value:
        assert isinstance(bc[1], (int, np.integer))
        if internal_constraint:
            assert len(markers.ids_with_value(bc[1])) > 0, \
                f"marker {bc[1]} not found"
        else:
            all_ids = extract_all_boundary_markers(mesh, markers)
            assert bc[1] in all_ids, \
                f"Boundary id {bc[1]} was not found in the boundary markers."

    if rank == 0:
        assert bc[2] is None or isinstance(bc[2], float) or callable(bc[2])
    else:
        if len(bc) == 3:
            value = bc[2]
            assert value is None or callable(value) \
                or (isinstance(value, (tuple, list)) and len(value) == space_dim
                    and all(isinstance(x, float) for x in value))
        elif len(bc) == 4:
            assert isinstance(bc[2], (int, np.integer)) and bc[2] < space_dim
            assert bc[3] is None or isinstance(bc[3], float) or callable(bc[3])
        else:  # pragma: no cover
            raise RuntimeError("malformed boundary condition tuple")
