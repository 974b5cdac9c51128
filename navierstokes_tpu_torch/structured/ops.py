"""Stencil (shift-based) operator application on class grids.

Counterpart of ``navierstokes_tpu/structured/ops.py``.  Each operator is a
list of taps ``(c_out, c_in, shift, weight)``; applying it is a sum of
``torch.roll`` shifts and multiply-adds over (*grid[, d]) tensors, with
none of the per-row gathers of the unstructured element loop.  Periodic
wrap is exactly ``torch.roll``.  All applies are dimension-agnostic:
shifts carry the grid rank (2D or 3D).

Left behind as a TPU artefact: ``NS_TPU_MATMUL_PRECISION`` / ``_PREC``.
Every product here runs in full precision (``config`` turns TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.structured import cuda_conv
from navierstokes_tpu_torch.utils import monitor


def _roll(A, s):
    """A[g] -> A[g + s] with periodic wrap (negative torch.roll shift).

    ``s`` is a length-(grid rank) shift; the grid axes are the LEADING
    axes of ``A``.  Only the axes that move are rolled."""
    moved = [(-int(v), a) for a, v in enumerate(s) if int(v) != 0]
    if not moved:
        return A
    shifts, dims = zip(*moved)
    return torch.roll(A, shifts=shifts, dims=dims)


def _weights(w, like):
    return torch.as_tensor(np.asarray(w), dtype=like.dtype,
                           device=like.device)


def apply_uu(taps, U):
    """Scalar P2->P2 stencil applied per velocity component.

    ``U``: (2^dim, *grid, d) -> (2^dim, *grid, d).
    """
    out = [None] * len(U)
    for (co, ci), entries in taps.items():
        acc = 0.0
        for s, w in entries:
            acc = acc + float(w) * _roll(U[ci], s)
        out[co] = acc if out[co] is None else out[co] + acc
    zero = torch.zeros_like(U[0])
    return torch.stack([o if o is not None else zero for o in out])


def apply_up(taps, P, n_uclass=None):
    """Vector-weighted P1->P2 stencil (pressure gradient).

    taps weights are (d,); ``P``: (*grid) -> (2^dim, *grid, d).
    """
    if n_uclass is None:
        n_uclass = 2 ** P.ndim
    out = [None] * n_uclass
    for (co, _ci), entries in taps.items():
        acc = 0.0
        for s, w in entries:
            acc = acc + _weights(w, P) * _roll(P, s)[..., None]
        out[co] = acc if out[co] is None else out[co] + acc
    d = len(next(iter(taps.values()))[0][1])
    zero = torch.zeros(P.shape + (d,), dtype=P.dtype, device=P.device)
    return torch.stack([o if o is not None else zero for o in out])


def apply_pu(taps, U):
    """Vector-contracting P2->P1 stencil (divergence): (2^dim, *grid, d)
    -> (*grid)."""
    acc = 0.0
    for (_co, ci), entries in taps.items():
        for s, w in entries:
            acc = acc + torch.matmul(_roll(U[ci], s), _weights(w, U))
    return acc


def apply_pp(taps, P):
    """Scalar P1->P1 stencil: (*grid) -> (*grid)."""
    acc = 0.0
    for s, w in taps[(0, 0)]:
        acc = acc + float(w) * _roll(P, s)
    return acc


# ---------------------------------------------------------------------------
# nonlinear convection on class grids
# ---------------------------------------------------------------------------

class StructuredConvection:
    """b_i = int((u . grad)u . N_i) assembled entirely with shifts.

    The element quadrature is that of the unstructured path; the cell
    gather and the transpose-table scatter are replaced by rolls in and
    out of the class grids (12 in 2D, 60 in 3D).

    The four contractions of the JAX ``__call__`` keep their order but run
    as batched matrix products over the flattened (*grid, d) tail, so no
    operand is permuted or copied: with X = u_loc as (ntau, nlu, G d),

        u_q    = N2 X                        (ntau, nq, G d)
        grad_u = g2 X                        (ntau, e, nq, G d)
        conv   = sum_e grad_u[:, e] * u_q[..., e]
        r      = (W N2^T) conv               (ntau, nlu, G d)

    Tensors are made on ``device`` (default: the card; the CPU only with
    ``device="cpu"``) in ``dtype`` (default ``config.default_dtype``).
    """

    @monitor.spanned("setup.engine",
                     owner=lambda self, sgrid, *a, **k: sgrid)
    def __init__(self, sgrid, dtype=None, device=None):
        space = sgrid.space
        self.sgrid = sgrid
        self.device = dev = config.require_device(device)
        self.dtype = dt = config.resolve_dtype(dtype, dev)

        def t(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=dt,
                                device=dev)

        g2 = np.einsum("qia,tae->tqie", space.G2, sgrid.Jinv_tau)
        ntau, nq, nlu, d = g2.shape
        self.N2 = t(space.N2)                             # (nq, nlu)
        # g2 (ntau, nq, nlu, e) and W (ntau, nq) in the layouts the matrix
        # products read
        self.g2_rows = t(g2.transpose(0, 3, 1, 2)
                         .reshape(ntau, d * nq, nlu))     # (ntau, e nq, nlu)
        self.WN = t(sgrid.W_tau[:, None, :]
                    * space.N2.T[None, :, :])             # (ntau, nlu, nq)
        # the kernels' packed tables, shifts and classes
        self.tables = cuda_conv.build_tables(self)

    def gather_local(self, U):
        """(2^dim, *grid, d) -> (ntau, nlu, *grid, d) local values."""
        sg = self.sgrid
        out = U.new_empty((sg.n_tau, sg.n_local_u) + tuple(U.shape[1:]))
        for t in range(sg.n_tau):
            for l in range(sg.n_local_u):
                out[t, l] = _roll(U[sg.u_class[t, l]], sg.u_shift[t, l])
        return out

    def scatter_local(self, R):
        """(ntau, nlu, *grid, d) local contributions -> (2^dim, *grid, d)."""
        sg = self.sgrid
        out = R.new_zeros((sg.n_uclass,) + tuple(R.shape[2:]))
        for t in range(sg.n_tau):
            for l in range(sg.n_local_u):
                out[int(sg.u_class[t, l])] += _roll(R[t, l],
                                                    -sg.u_shift[t, l])
        return out

    def __call__(self, U):
        """The convection of class grids ``U``; its device work is the
        phases ``convection.gather``, ``convection.quadrature`` and
        ``convection.scatter``, in that order.

        A CUDA tensor launches the gather-and-quadrature kernel in
        ``convection.quadrature`` and the scatter kernel in
        ``convection.scatter`` (``cuda_conv``), or raises;
        ``convection.gather`` then holds no launch and ends at its start
        mark (it reads 0).  A CPU tensor runs :meth:`plain`."""
        if not U.is_cuda:
            return self.plain(U)
        with monitor.phase("convection.gather", empty=True):
            pass
        with monitor.phase("convection.quadrature"):
            r = cuda_conv.quadrature(U, self.tables)
        with monitor.phase("convection.scatter"):
            return cuda_conv.scatter(r, self.tables)

    def plain(self, U):
        """The convection in plain torch: :meth:`gather_local`,
        :meth:`quadrature` and :meth:`scatter_local`, one phase each."""
        with monitor.phase("convection.gather"):
            u_loc = self.gather_local(U)
        with monitor.phase("convection.quadrature"):
            r = self.quadrature(u_loc)
        with monitor.phase("convection.scatter"):
            return self.scatter_local(r)

    def quadrature(self, u_loc):
        """(ntau, nlu, *grid, d) local values -> (ntau, nlu, *grid, d)
        local contributions; pointwise in the grid, so it takes any grid
        extent (a slab, too)."""
        ntau, nlu = u_loc.shape[:2]
        tail = tuple(u_loc.shape[2:])
        d = tail[-1]
        nq = self.N2.shape[0]
        X = u_loc.reshape(ntau, nlu, -1)
        u_q = torch.bmm(self.N2.expand(ntau, -1, -1), X).reshape(
            (ntau, nq) + tail)
        grad_u = torch.bmm(self.g2_rows, X).reshape(
            (ntau, d, nq) + tail)                         # (t,e,q,*g,d)
        conv = grad_u[:, 0] * u_q[..., 0:1]
        for e in range(1, d):
            conv.addcmul_(grad_u[:, e], u_q[..., e:e + 1])
        r = torch.bmm(self.WN, conv.reshape(ntau, nq, -1))
        return r.reshape((ntau, nlu) + tail)
