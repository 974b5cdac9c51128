"""Cell-sharded mixed (saddle-point) residual and Jacobian for the
Newton stack (``navierstokes_tpu/parallel/sharded_mixed.py``).

The stationary stack's hot operation is the matrix-free Jacobian action
of :class:`~navierstokes_tpu_torch.assembly.operators.MixedOperator`: a
per-cell sweep plus a scatter.  Here the CELLS are partitioned over the
shards of a :class:`~navierstokes_tpu_torch.parallel.comm.DeviceMesh`:
each shard evaluates its own cells on the replicated state vector,
scatters into a full-length partial result, and one
:func:`~navierstokes_tpu_torch.parallel.comm.psum` adds the partials in
shard order on shard 0's device.  State vectors stay replicated.

Where the JAX class shards a residual sweep and ``jax.linearize``s it,
the port's Jacobian is not AD: it is ``MixedOperator._cell_tangent``
(the Picard residual plus the convective bilinear form).  So both sweeps
are sharded here, the residual and the tangent, with one psum each; the
Dirichlet rows stay identity rows, as in the one-device operator.

Duck-types the ``MixedOperator`` surface that the PCD stack and the
stationary solver read (everything this class does not define is the
wrapped operator's), so ``MatrixFreePCD(ShardedMixedOperator(...))`` is a
multi-shard Newton-Krylov solve with no change to the solver layer.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.assembly import kernels
from navierstokes_tpu_torch.parallel.comm import as_mesh, psum
from navierstokes_tpu_torch.utils.segment import SegmentSum


class ShardedMixedOperator:
    """Cell-sharded facade over a ``MixedOperator``.

    The geometry (``Jinv``, ``W``) and the cell index tables are padded
    to a multiple of the shard count and split into one chunk per shard,
    on the shard's device; padded cells carry zero quadrature weight and
    point at node 0, so they contribute nothing.  ``mixed_op``'s device
    must be shard 0's, where the replicated vectors live.
    """

    def __init__(self, mixed_op, device_mesh):
        mesh = as_mesh(device_mesh)
        if mixed_op.device != mesh.devices[0]:
            raise ValueError(f"the operator lives on {mixed_op.device}, "
                             f"the mesh's shard 0 on {mesh.devices[0]}")
        self.base = mixed_op
        self.mesh = mesh
        self.axis = mesh.axis
        n_dev = len(mesh)
        space = mixed_op.space
        self.space = space

        nc = mixed_op.cell_unodes.shape[0]
        self._n_pad = (-nc) % n_dev
        self.n_cells_padded = nc + self._n_pad
        self.chunk = chunk = self.n_cells_padded // n_dev

        def pad_cells(a, fill=0):
            a = np.asarray(a)
            if self._n_pad == 0:
                return a
            block = np.full((self._n_pad,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, block], axis=0)

        # the cell kernels close over the shape tables: one pair per device
        sweeps = {mixed_op.device: (mixed_op._cell_residual,
                                    mixed_op._linearize_cells)}
        for dev in mesh.physical_devices:
            if dev not in sweeps:
                args = tuple(t.to(dev) for t in (mixed_op.N2, mixed_op.G2,
                                                  mixed_op.N1)) + (
                    mixed_op.dim, mixed_op.conv_form, mixed_op.visc_form,
                    mixed_op.with_coriolis)
                sweeps[dev] = (kernels.make_cell_residual(*args),
                               kernels.make_cell_tangent(*args))
        cu = pad_cells(space.cell_unodes)
        cp_ = pad_cells(space.cell_pnodes)
        Jinv = pad_cells(mixed_op.Jinv.cpu().numpy())
        W = pad_cells(mixed_op.W.cpu().numpy(), fill=0.0)
        self._shards = []
        for d, dev in enumerate(mesh.devices):
            cells = slice(d * chunk, (d + 1) * chunk)

            def ints(a):
                return torch.as_tensor(np.asarray(a[cells], np.int64),
                                       device=dev)

            self._shards.append(dict(
                device=dev, cells=cells, residual=sweeps[dev][0],
                tangent=sweeps[dev][1],
                cell_unodes=ints(cu), cell_pnodes=ints(cp_),
                Jinv=torch.as_tensor(Jinv[cells], device=dev),
                W=torch.as_tensor(W[cells], device=dev),
                scatter_u=SegmentSum(cu[cells], space.n_unodes, dev),
                scatter_p=SegmentSum(cp_[cells], space.n_pnodes, dev)))

    # -- pass-throughs the PCD stack and the solvers use --------------------
    def __getattr__(self, name):
        return getattr(self.base, name)

    def split(self, x):
        return self.base.split(x)

    # -- the sharded sweeps ---------------------------------------------------
    def _local_source(self, source_q, sh):
        """A per-cell source's rows of the shard's cells (zero rows for
        the padding); a scalar passes through."""
        if not torch.is_tensor(source_q) or source_q.dim() == 0:
            return source_q
        if self._n_pad:
            source_q = torch.cat([source_q, source_q.new_zeros(
                (self._n_pad,) + tuple(source_q.shape[1:]))])
        return source_q[sh["cells"]].to(sh["device"], non_blocking=True)

    def _gathered(self, sh, x):
        """Shard ``sh``'s cell values (u_c, p_c) of a replicated vector."""
        u, p = self.space.split(x.to(sh["device"], non_blocking=True))
        return u[sh["cell_unodes"]], p[sh["cell_pnodes"]]

    def _assembled(self, sh, r_u_c, r_p_c):
        return torch.cat([sh["scatter_u"](r_u_c).reshape(-1),
                          sh["scatter_p"](r_p_c)])

    def _sum(self, parts):
        if len(parts) == 1:
            return parts[0]
        return psum(parts, self.mesh)[0]

    def _residual_sweep(self, x, scalars, source_q, picard):
        parts = []
        for sh in self._shards:
            u_c, p_c = self._gathered(sh, x)
            parts.append(self._assembled(sh, *sh["residual"](
                u_c, p_c, u_c, sh["Jinv"], sh["W"],
                self._local_source(source_q, sh), scalars, picard)))
        return self._sum(parts)

    def residual(self, x, bc_values, scalars, source_q=0.0, extra_ru=None,
                 mask_bcs=True):
        """``MixedOperator.residual`` with the cell sweep sharded."""
        r = self._residual_sweep(x, scalars, source_q, False)
        if extra_ru is not None:
            n_u = self.space.n_velocity_dofs
            r = torch.cat([r[:n_u] + extra_ru.reshape(-1), r[n_u:]])
        if mask_bcs:
            bc = self.base._bc_dofs
            r[bc] = x[bc] - bc_values
        return r

    def linearize_at(self, x, scalars, source_q=0.0, picard=False):
        """``MixedOperator.linearize_at`` with both sweeps sharded: returns
        ``(r, jvp)``, the masked residual at ``x`` and the Jacobian action
        with identity rows at the Dirichlet dofs."""
        base = self.base
        tangents = []
        for sh in self._shards:
            u_c, _ = self._gathered(sh, x)
            tangents.append(sh["tangent"](u_c, sh["Jinv"], sh["W"],
                                          scalars, picard))

        def jvp(v):
            parts = []
            for sh, tangent in zip(self._shards, tangents):
                w_u, w_p = self._gathered(sh, v)
                parts.append(self._assembled(sh, *tangent(w_u, w_p)))
            # the bc offset (z[bc] - g) differentiates to identity rows
            return torch.where(base._bc_mask, v, self._sum(parts))

        r = self._residual_sweep(x, scalars, source_q, picard)
        return torch.where(base._bc_mask, x, r), jvp
