"""The AMG-preconditioned Poisson CG of the planar step in one CUDA launch.

:func:`amg_pcg` runs ``iters`` iterations of ``linalg/pcg.pcg(A', b, x0,
iters, project=P, precond_fn=amg.apply)`` -- with ``A' v = m*L(m*v) +
(1-m)*v`` and ``P r = m*r`` for a mask ``m``, ``A' = L`` and ``P r = r -
mean(r)`` without one -- for the hierarchy ``amg`` that
``planar_step.build_poisson_amg`` builds on the ``CirculantBand`` ``L``.
It returns ``(x, r)`` as ``cuda_band.circulant_pcg`` does.  On a CUDA
tensor it launches ``csrc/amg_pcg.cu::amg_pcg_cluster_kernel`` (built into
the kernel library, ``cudalib.py``) or raises; on a CPU tensor it runs
:func:`amg_pcg_plain`, that ``pcg`` call itself.

:func:`amg_pcg_plan`, a pure function of the hierarchy's shapes, lays the
solve out in one 16-CTA cluster's shared memory: the fewest levels
distributed (each CTA owns ``ceil(n / 16)`` contiguous rows of each), the
levels below them and the coarse pseudo-inverse replicated in every CTA.
It returns None when no layout fits.  :func:`prepare`, called where the
step is built, decides once whether a hierarchy takes the kernel and
packs it (the only host reads); the step then keeps ``pcg`` where it
answers None.  Launches count under ``cudalib.LAUNCHES["amg_pcg"]``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.assembly.fastop import CirculantBand
from navierstokes_tpu_torch.linalg.amg import AMG, _DeviceDense
from navierstokes_tpu_torch.linalg.pcg import pcg

CTAS = 16             # kCtas in amg_pcg.cu
THREADS = 1024        # kThreads
MAX_LEVELS = 8        # kMaxLevels: the band level, ELL levels, the coarse
MAX_WIDTH = 32        # kMaxWidth: band offsets, ELL and aggregate widths
SMEM_STATIC = 2_048   # reserved for the kernel's static arrays
# the descriptor's header and per-level fields, in amg_pcg.cu's order
HEADER = ("nlev", "ndist", "iters", "s_r", "s_ap", "s_zp", "s_mask",
          "s_work")
FIELDS = ("n", "rows", "magic", "width", "swidth", "halo", "reach",
          "g_vals", "g_cols", "g_dinv", "g_wdinv", "g_cdinv", "g_agg",
          "g_rtab", "s_vals", "s_cols", "s_dinv", "s_wdinv", "s_cdinv",
          "s_agg", "s_rtab", "s_scr", "s_in", "s_b", "s_r0", "s_x2")


class Shape(NamedTuple):
    """The hierarchy's shapes: level 0's rows ``n``, band offsets ``K``,
    aggregate size ``swidth``, ``halo`` (the farthest neighbour, either way
    round) and ``reach`` (the farthest row from a CTA's rows that the
    restriction into its coarse rows reads: ``halo`` plus the farthest
    member of those coarse rows outside them); per ELL level ``(rows,
    width, swidth, halo, reach)``; the coarse level's rows."""
    n: int
    K: int
    swidth: int
    halo: int
    reach: int
    levels: tuple
    coarse: int


class AmgPlan(NamedTuple):
    """How :func:`amg_pcg` lays a hierarchy out in the cluster."""
    ndist: int         # levels distributed over the CTAs (level 0 first)
    smem_bytes: int    # dynamic shared memory per CTA
    header: tuple      # the header's s_* byte offsets
    fields: tuple      # per level: its FIELDS (the g_* ones 0)


def _rows(n):
    # at least 2, so that the owner's magic number fits 32 bits
    return max(2, -(-n // CTAS))


def _magic(rows):
    """``__umulhi(j, magic) == j // rows`` for every j < 16 * rows."""
    m = (2 ** 32 - 1) // rows + 1
    return m - 2 ** 32 if m >= 2 ** 31 else m


@functools.lru_cache(maxsize=64)
def amg_pcg_plan(shape: Shape, dtype: torch.dtype,
                 masked: bool) -> AmgPlan | None:
    """The layout with the fewest distributed levels that fits one CTA's
    shared memory, or None.

    A distributed level keeps its owned rows (level 0: the band slice,
    r, Ap, both (z, p) buffers, r0 and the mask; an ELL level: its rows
    and the input b, r0, x2), both inverse diagonals, the aggregate of
    each row, and the members of the coarse rows it owns; a replicated
    level keeps all of it; the coarse level its pseudo-inverse.  One work
    buffer per CTA holds a distributed level's neighbourhood (its rows and
    ``reach`` rows each side); the terms of a restriction go to the
    (z, p) buffer that a V-cycle leaves unread.
    """
    es = 4 if dtype == torch.float32 else 8
    nlev = 1 + len(shape.levels)
    if nlev + 1 > MAX_LEVELS or not 1 <= shape.K <= MAX_WIDTH or \
            max((shape.swidth, *(max(lv[1:3]) for lv in shape.levels))) > \
            MAX_WIDTH:
        return None
    ns = [shape.n] + [lv[0] for lv in shape.levels] + [shape.coarse]
    widths = [shape.K] + [lv[1] for lv in shape.levels]
    swidths = [shape.swidth] + [lv[2] for lv in shape.levels]
    halos = [shape.halo] + [lv[3] for lv in shape.levels]
    reaches = [shape.reach] + [lv[4] for lv in shape.levels]
    budget = cudalib.SMEM_PER_BLOCK - SMEM_STATIC
    # fewer distributed levels first (each costs 4 cluster barriers per
    # iteration), the coarse pseudo-inverse in shared memory before in L2
    for ndist, pinv_shared in itertools.product(range(1, nlev + 1),
                                                (True, False)):
        top = 0

        def take(count, size=es):
            nonlocal top
            at = top
            top += -(-count * size // 16) * 16
            return at

        # the restriction's terms fit the (z, p) buffer it borrows
        if any(_rows(ns[k + 1]) * swidths[k] > 2 * _rows(ns[0])
               for k in range(ndist)):
            continue
        # the work buffer: the widest neighbourhood
        header = {"s_work": take(max(_rows(ns[k]) + 2 * reaches[k]
                                     for k in range(ndist)))}
        fields = []
        for k in range(nlev + 1):
            n, R = ns[k], _rows(ns[k])
            f = dict.fromkeys(FIELDS, 0)
            f.update(n=n, rows=R, magic=_magic(R))
            if k == nlev:                       # coarse: replicated
                if ndist == nlev:
                    f["s_in"] = take(R)
                f.update(s_vals=take(n * n) if pinv_shared else -1,
                         s_b=take(n), s_r0=take(n))
                fields.append(tuple(f[name] for name in FIELDS))
                continue
            W, S = widths[k], swidths[k]
            Rn = _rows(ns[k + 1])
            f.update(width=0 if k == 0 else W, swidth=S, halo=halos[k],
                     reach=reaches[k])
            if k < ndist:                       # distributed
                f["s_vals"] = take(W * R)
                if k == 0:
                    header.update(s_r=take(R), s_ap=take(R),
                                  s_zp=take(4 * R),
                                  s_mask=take(R) if masked else -1)
                    f["s_x2"] = header["s_ap"]
                else:
                    f["s_cols"] = take(W * R, 4)
                    f["s_in"] = f["s_b"] = take(R)
                    f["s_x2"] = take(R)
                f.update(s_dinv=take(R), s_wdinv=take(R), s_agg=take(R, 4),
                         s_r0=take(R), s_rtab=take(Rn * S, 4))
            else:                               # replicated
                if k == ndist:
                    f["s_in"] = take(R)
                nn = ns[k + 1]
                f.update(s_vals=take(W * n), s_cols=take(W * n, 4),
                         s_dinv=take(n), s_wdinv=take(n), s_cdinv=take(n),
                         s_agg=take(n, 4), s_b=take(n), s_r0=take(n),
                         s_x2=take(n), s_rtab=take(nn * S, 4),
                         s_scr=take(nn * S))
            fields.append(tuple(f[name] for name in FIELDS))
        if top <= budget:
            return AmgPlan(ndist, top, tuple(header[h] for h in HEADER[3:]),
                           tuple(fields))
    return None


def _ell(A):
    """``(cols (W, n) int32, vals (W, n))`` on the host: a level's
    operator as a padded row table, column-major."""
    if isinstance(A, _DeviceDense):
        mat = A.mat.cpu().numpy()
        nz = mat != 0.0
        W = max(int(nz.sum(axis=1).max()), 1)
        cols = np.full((mat.shape[0], W), -1, np.int64)
        vals = np.zeros((mat.shape[0], W), mat.dtype)
        for i in range(mat.shape[0]):
            c = np.flatnonzero(nz[i])
            cols[i, :len(c)] = c
            vals[i, :len(c)] = mat[i, c]
    else:
        cols = A.cols.cpu().numpy().copy()
        vals = A.vals.cpu().numpy()
    # a pad reads the row itself, times 0
    rows = np.broadcast_to(np.arange(cols.shape[0])[:, None], cols.shape)
    pad = (cols < 0) | (cols >= A.n_cols)
    cols = np.where(pad, rows, cols)
    vals = np.where(pad, 0.0, vals).astype(vals.dtype)
    return cols.T.astype(np.int32), vals.T


class _Packed(NamedTuple):
    shape: Shape
    tpack: torch.Tensor    # every level's values, in the hierarchy's dtype
    ipack: torch.Tensor    # every level's indices, int32
    goff: tuple            # per level: the g_* element offsets, as items
    cs: object             # ctypes double array: each level's c


_PACKS: "weakref.WeakKeyDictionary[AMG, _Packed]" = weakref.WeakKeyDictionary()


def _packed(amg: AMG, band_op: CirculantBand) -> _Packed:
    """The hierarchy on ``band_op`` (its level 0): shapes and data in two
    flat tensors on its device, built once per hierarchy (the first call
    reads the levels to the host, so it raises during a CUDA graph's
    capture: :func:`prepare` packs the step's hierarchy when the step is
    built)."""
    got = _PACKS.get(amg)
    if got is not None:
        return got
    if amg.coarse_inv.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an AMG hierarchy met for the first time during "
                           "a CUDA graph's capture: pack it before "
                           "(cuda_amg.prepare)")
    tparts, iparts = [], []
    tcount, icount = 0, 0

    def put_t(arr):
        nonlocal tcount
        at = tcount
        t = torch.as_tensor(np.ascontiguousarray(arr)).reshape(-1)
        tparts.append(t)
        tcount += t.numel()
        return at

    def put_i(arr):
        nonlocal icount
        at = icount
        t = torch.as_tensor(np.ascontiguousarray(arr, np.int32)).reshape(-1)
        iparts.append(t)
        icount += t.numel()
        return at

    def around(d, n):
        # the distance d between rows, either way round a level of n rows
        d = np.abs(d) % n
        return np.minimum(d, n - d)

    def reach(k, halo):
        # halo plus the farthest member of a CTA's coarse rows outside the
        # CTA's rows of level k
        n = amg.levels[k]["agg"].numel()
        rows, coarse_rows = _rows(n), _rows(amg.levels[k]["n_agg"])
        table = amg.levels[k]["restrict"].table.cpu().numpy()
        lo = (np.arange(table.shape[0]) // coarse_rows * rows)[:, None]
        inside = (table >= lo) & (table < lo + rows)
        out = np.minimum(around(lo - table, n), around(table - lo - rows + 1,
                                                       n))
        out = np.where(inside | (table >= n), 0, out)
        return halo + int(out.max(initial=0))

    levels, goff, cs = [], [], []
    for k, lvl in enumerate(amg.levels):
        g = dict.fromkeys(("g_vals", "g_cols", "g_dinv", "g_wdinv",
                           "g_cdinv", "g_agg", "g_rtab"), 0)
        table = lvl["restrict"].table.cpu().numpy()
        rtab = np.where(table >= lvl["agg"].numel(), -1, table)
        g.update(g_dinv=put_t(lvl["dinv"].cpu().numpy()),
                 g_wdinv=put_t(lvl["wdinv"].cpu().numpy()),
                 g_cdinv=put_t(lvl["cdinv"].cpu().numpy()),
                 g_agg=put_i(lvl["agg"].cpu().numpy()),
                 g_rtab=put_i(rtab))
        if k > 0:
            cols, vals = _ell(lvl["A"])
            g.update(g_vals=put_t(vals), g_cols=put_i(cols))
            halo = int(around(cols - np.arange(cols.shape[1]),
                              cols.shape[1]).max())
            levels.append((lvl["agg"].numel(), cols.shape[0],
                           rtab.shape[1], halo, reach(k, halo)))
        goff.append(tuple(g.items()))
        cs.append(lvl["c"])
    coarse = amg.coarse_inv
    goff.append((("g_vals", put_t(coarse.cpu().numpy())),))
    cs.append(0.0)
    halo0 = int(around(np.asarray(band_op.offsets), amg.n).max())
    shape = Shape(amg.n, len(band_op.offsets),
                  int(amg.levels[0]["restrict"].table.shape[1]), halo0,
                  reach(0, halo0), tuple(levels), int(coarse.shape[0]))
    dev = coarse.device
    packed = _Packed(shape,
                     torch.cat([t.to(coarse.dtype) for t in tparts]).to(dev),
                     torch.cat(iparts).to(dev), tuple(goff),
                     (ctypes.c_double * len(cs))(*cs))
    _PACKS[amg] = packed
    return packed


def prepare(amg, band_op, dtype: torch.dtype, masked: bool) -> AMG | None:
    """``amg`` if :func:`amg_pcg` can run its solve, else None: the
    hierarchy that ``build_poisson_amg`` built on the ``CirculantBand``
    ``band_op`` (with a mask or not), whose layout fits one cluster
    (:func:`amg_pcg_plan`).  Packs the hierarchy on the way (the plan
    reads its shapes from the pack), so call it before any capture."""
    if not amg.levels or not isinstance(band_op, CirculantBand) or \
            band_op.band.shape[1] != amg.n:
        return None
    plan = amg_pcg_plan(_packed(amg, band_op).shape, dtype, masked)
    return None if plan is None else amg


def amg_pcg_plain(amg, band_op, b, x0, mask, iters):
    """``(x, r)`` after ``iters`` AMG-preconditioned CG steps: ``pcg``
    with ``amg.apply``, as ``_step_core`` calls it."""
    if mask is None:
        def matvec(v):
            return band_op.apply(v)

        def project(r):
            return r - r.mean()
    else:
        def matvec(v):
            return mask * band_op.apply(mask * v) + (1.0 - mask) * v

        def project(r):
            return mask * r

    return pcg(matvec, b, x0, int(iters), project=project,
               precond_fn=amg.apply)


_P, _I = ctypes.c_void_p, ctypes.c_int
# ns_amg_pcg_prepare_<f32|f64>(smem, masked)
PREPARE_ARGS = (_I, _I)
# ns_amg_pcg_<f32|f64>(desc, cs, offs, K, smem, band, tpack, ipack, b, x0,
# mask, x, r, stream)
AMG_PCG_ARGS = (_P, _P, _P, _I, _I) + (_P,) * 9


@functools.lru_cache(maxsize=16)
def _prepared(plan: AmgPlan, dtype: torch.dtype, device: torch.device,
              masked: bool):
    """Opt the kernel into its shared memory and check that its cluster
    can be resident, once per plan and device; raises if not."""
    prepare = cudalib.entry("amg_pcg_prepare", dtype, PREPARE_ARGS)
    with cudalib.on_device(device):
        cudalib.check_error(
            prepare(plan.smem_bytes, int(masked)),
            f"amg_pcg ({CTAS}-CTA cluster, {plan.smem_bytes} B shared "
            "memory each)")
    return plan


@functools.lru_cache(maxsize=64)
def _descriptor(plan: AmgPlan, goff: tuple, iters: int):
    """The kernel's descriptor (``HEADER``, then ``FIELDS`` per level) as
    a ctypes int array."""
    out = [len(plan.fields) - 1, plan.ndist, iters, *plan.header]
    for f, g in zip(plan.fields, goff):
        row = dict(zip(FIELDS, f))
        row.update(dict(g))
        out.extend(int(row[name]) for name in FIELDS)
    return (ctypes.c_int * len(out))(*out)


def _validate(amg, band_op, b, x0, mask, iters):
    n = amg.n
    if band_op.band.shape[1] != n:
        raise ValueError(f"band of {band_op.band.shape[1]} rows for a "
                         f"hierarchy of {n}")
    for name, t in (("b", b), ("x0", x0)) + \
            ((("mask", mask),) if mask is not None else ()):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    named = {"band": band_op.band, "b": b, "x0": x0,
             "hierarchy": amg.coarse_inv}
    if mask is not None:
        named["mask"] = mask
    cudalib.check_tensors(named, b.device, b.dtype)
    if int(iters) < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def amg_pcg(amg, band_op, b, x0, mask, iters):
    """``(x, r)`` after ``iters`` AMG-preconditioned CG steps on
    ``A' = m*L(m*v) + (1-m)*v`` (``mask`` m; mean free when None).

    CUDA tensors run the whole solve in one launch of
    ``amg_pcg_cluster_kernel``; CPU tensors take :func:`amg_pcg_plain`.
    """
    if not b.is_cuda:
        return amg_pcg_plain(amg, band_op, b, x0, mask, iters)
    _validate(amg, band_op, b, x0, mask, iters)
    packed = _packed(amg, band_op)
    if packed.shape.K != len(band_op.offsets):
        raise ValueError(f"a band of {len(band_op.offsets)} offsets for a "
                         f"hierarchy packed with {packed.shape.K}")
    dtype, dev, masked = b.dtype, b.device, mask is not None
    plan = amg_pcg_plan(packed.shape, dtype, masked)
    if plan is None:
        raise ValueError(f"the hierarchy {packed.shape} does not fit one "
                         "cluster's shared memory")
    _prepared(plan, dtype, dev, masked)
    _, offs_c = cudalib.check_offsets(band_op.offsets, amg.n, MAX_WIDTH)
    desc = _descriptor(plan, packed.goff, int(iters))
    fn = cudalib.entry("amg_pcg", dtype, AMG_PCG_ARGS)
    with cudalib.on_device(dev):
        x = torch.empty_like(b)
        r = torch.empty_like(b)
        err = fn(
            desc, packed.cs, offs_c, len(band_op.offsets), plan.smem_bytes,
            band_op.band.data_ptr(), packed.tpack.data_ptr(),
            packed.ipack.data_ptr(), b.data_ptr(), x0.data_ptr(),
            None if mask is None else mask.data_ptr(), x.data_ptr(),
            r.data_ptr(), cudalib.current_stream(dev))
    cudalib.check_error(err, "amg_pcg")
    cudalib.LAUNCHES["amg_pcg"] += 1
    return x, r
