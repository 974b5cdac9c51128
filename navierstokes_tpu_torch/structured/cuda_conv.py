"""The structured convection in two CUDA launches.

:func:`quadrature` gathers each (cell, simplex)'s local velocities from the
class grids and runs the rule's points on them in one launch of
``csrc/structured_conv.cu::structured_conv_quadrature_kernel``; it returns
the local contributions ``R`` (ntau, nlu, *grid, d) that
``StructuredConvection.quadrature(gather_local(U))`` gives.
:func:`scatter` sums them onto the class grids in one launch of
``structured_conv_scatter_kernel``, in the order of
``StructuredConvection.scatter_local``.  Both are built into the kernel
library (``cudalib.py``); this module alone declares their C interface.
They take CUDA tensors and raise on any other;
``StructuredConvection`` runs its plain ``gather_local``, ``quadrature``
and ``scatter_local`` on the CPU.

:func:`pack_tables`, a pure function of the convection's tables, lays out
what the quadrature kernel reads per simplex; :func:`build_tables` packs
them once, with the lattice and the local nodes' classes and shifts, for
one ``StructuredConvection``.  Each convection counts one launch under
``cudalib.LAUNCHES["structured_convection"]``, at its quadrature.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from navierstokes_tpu_torch import cudalib

_I, _P = ctypes.c_int, ctypes.c_void_p


class Tables(NamedTuple):
    """What the kernels read of one ``StructuredConvection``."""
    dim: int
    shape: tuple       # the cell lattice
    ntau: int
    nlu: int
    nq: int
    pack: torch.Tensor  # (ntau, nq (4 nlu + pad)) on the convection's device
    cls: ctypes.Array   # (ntau nlu) classes of the local nodes
    shift: ctypes.Array  # (ntau nlu dim) their lattice shifts


def _pad(nlu):
    return -(-nlu // 4) * 4


def pack_tables(N2, g2_rows, WN):
    """(ntau, nq (4 nlu + pad)) tables, one row per simplex: per point q,
    ``nlu`` rows of four ``(N2[q, l], g2[t, q, l, 0..d-1], 0...)`` (the
    shape function and its derivatives), then ``WN[t, :, q]`` padded with
    zeros to a multiple of four nodes.

    ``N2`` (nq, nlu), ``g2_rows`` (ntau, d nq, nlu) and ``WN``
    (ntau, nlu, nq) are the tensors ``StructuredConvection`` holds; the
    pack takes their dtype and device."""
    ntau, dnq, nlu = g2_rows.shape
    nq = N2.shape[0]
    d = dnq // nq
    rows = N2.new_zeros((ntau, nq, nlu, 4))
    rows[..., 0] = N2
    rows[..., 1:1 + d] = g2_rows.reshape(ntau, d, nq, nlu).permute(0, 2, 3, 1)
    tests = N2.new_zeros((ntau, nq, _pad(nlu)))
    tests[..., :nlu] = WN.transpose(1, 2)
    return torch.cat([rows.reshape(ntau, -1), tests.reshape(ntau, -1)],
                     dim=1).contiguous()


def build_tables(conv) -> Tables:
    """The kernels' tables of the ``StructuredConvection`` ``conv``, on
    its device."""
    sg = conv.sgrid
    cls = [int(c) for c in sg.u_class.reshape(-1)]
    shift = [int(s) for s in sg.u_shift.reshape(-1)]
    return Tables(sg.dim, tuple(int(n) for n in sg.shape), sg.n_tau,
                  sg.n_local_u, int(conv.N2.shape[0]),
                  pack_tables(conv.N2, conv.g2_rows, conv.WN),
                  (ctypes.c_int * len(cls))(*cls),
                  (ctypes.c_int * len(shift))(*shift))


def _check_operand(name, X, tables, lead):
    """``X`` is (*lead, *lattice, dim), contiguous, of the tables' dtype
    and device."""
    want = tuple(lead) + tables.shape + (tables.dim,)
    cudalib.check_tensors({name: X}, tables.pack.device, tables.pack.dtype)
    if X.ndim != len(want):
        raise ValueError(f"{name} has rank {X.ndim}, expected {len(want)} "
                         f"{want}")
    if tuple(X.shape) != want:
        raise ValueError(f"{name} is {tuple(X.shape)}, expected {want}")
    if not X.is_cuda:
        raise ValueError(f"{name} is on {X.device}: the structured "
                         "convection kernels take CUDA tensors (the plain "
                         "version is StructuredConvection's gather_local, "
                         "quadrature and scatter_local)")


def _lattice(tables):
    n = tables.shape + (1,) * (3 - tables.dim)
    return tables.dim, n[0], n[1], n[2]


# ns_structured_conv_quadrature_<f32|f64>(dim, n0, n1, n2, ntau, nlu, nq,
# cls, shift, U, tables, R, stream)
QUADRATURE_ARGS = (_I,) * 7 + (_P,) * 6


def quadrature(U, tables):
    """The local contributions (ntau, nlu, *grid, d) of the class grids
    ``U`` (2^dim, *grid, d): one launch of the gather-and-quadrature
    kernel.  The kernel takes P2 simplices, at most six a cell, whose
    packed tables fit a block's 48 KB of shared memory; it refuses others
    and this raises."""
    _check_operand("U", U, tables, (2 ** tables.dim,))
    R = U.new_empty((tables.ntau, tables.nlu) + tuple(U.shape[1:]))
    fn = cudalib.entry("structured_conv_quadrature", U.dtype,
                       QUADRATURE_ARGS)
    with cudalib.on_device(U.device):
        err = fn(*_lattice(tables), tables.ntau, tables.nlu, tables.nq,
                 tables.cls, tables.shift, U.data_ptr(),
                 tables.pack.data_ptr(), R.data_ptr(),
                 cudalib.current_stream(U.device))
    cudalib.check_error(err, "structured_conv_quadrature")
    cudalib.LAUNCHES["structured_convection"] += 1
    return R


# ns_structured_conv_scatter_<f32|f64>(dim, n0, n1, n2, ntau, nlu, cls,
# shift, R, out, stream)
SCATTER_ARGS = (_I,) * 6 + (_P,) * 5


def scatter(R, tables):
    """The class grids (2^dim, *grid, d) that the local contributions
    ``R`` (ntau, nlu, *grid, d) sum to: one launch of the scatter
    kernel."""
    _check_operand("R", R, tables, (tables.ntau, tables.nlu))
    out = R.new_empty((2 ** tables.dim,) + tuple(R.shape[2:]))
    fn = cudalib.entry("structured_conv_scatter", R.dtype, SCATTER_ARGS)
    with cudalib.on_device(R.device):
        err = fn(*_lattice(tables), tables.ntau, tables.nlu, tables.cls,
                 tables.shift, R.data_ptr(), out.data_ptr(),
                 cudalib.current_stream(R.device))
    cudalib.check_error(err, "structured_conv_scatter")
    return out
