"""Driver ``spectral_graph_3d``: ``spectral_graph``'s step and chunks on a
3D periodic configuration, whose velocity has three components per node.

Workload keys: those of ``spectral_graph``.  The seeded initial fields
are kept on the lattice (``lattice.initial``) for the problem's guards."""

from __future__ import annotations

import torch

from harness.spec import load_module

SpectralGraph = load_module("drivers", "spectral_graph").SpectralGraph


class SpectralGraph3D(SpectralGraph):

    def __init__(self, ctx):
        super().__init__(ctx)
        self.lattice.initial = ctx.initial

    def reference_state(self, snap):
        U, U_old, _, _, Ph = snap
        sg = self._sgrid

        def velocity(U):
            return self._to_u(sg.grids_to_u(U).reshape(-1, 3).T)

        p = self._to_p(sg.grid_to_p(self._ops.inv_p(Ph)))
        return velocity(U), velocity(U_old), p, torch.zeros_like(p)


def build(ctx):
    return SpectralGraph3D(ctx)
