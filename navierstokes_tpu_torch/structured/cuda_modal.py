"""The spectral step's per-mode work in three CUDA launches.

:func:`helmholtz`, :func:`poisson` and :func:`correction` compute the phases
of the same names of ``spectral._modal_update``, one launch each of
``csrc/spectral_modal.cu``'s ``spectral_helmholtz_kernel``,
``spectral_poisson_kernel`` and ``spectral_correction_kernel``, from the
per-mode arrays that a ``SpectralOperators`` (or a slab view of one) holds.
They are built into the kernel library (``cudalib.py``); this module alone
declares their C interface.  They take CUDA tensors, contiguous, of the
operators' dtype, with 2^dim x 2^dim blocks in 2D or 3D, and raise on any
other; ``_modal_update`` runs its plain chain on the CPU.  Every output is
a fresh tensor, returned as an ``(re, im)`` pair.  Each modal update counts
one launch under ``cudalib.LAUNCHES["spectral_modal"]``, at its Helmholtz
launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from navierstokes_tpu_torch import cudalib

_I, _L, _D, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_double, \
    ctypes.c_void_p
# (NB, d): 2^dim node classes and dim components, the kernels' blocks
BLOCKS = ((4, 2), (8, 3))


def _layout(ops):
    """``(lead, NB, d)`` of the per-mode arrays of ``ops``: ``lead``, the
    shape of the modes, is ``Linv``'s (a slab's, for a slab view)."""
    lead = tuple(ops.Linv.shape)
    return lead, int(ops.lam.shape[-1]), int(ops.Ghat[0].shape[-1])


def _check(named, ops, streamed):
    """Each of ``named``'s tensors (name -> (tensor, trailing shape)) has
    the operators' dtype and device, is contiguous and (*modes, *trailing);
    the operators' blocks are ones the kernels take; every tensor is on a
    card, and those in ``streamed`` are 16-byte aligned (the kernels copy
    them in bulk)."""
    lead, nb, d = _layout(ops)
    if (nb, d) not in BLOCKS:
        raise ValueError(f"blocks of {nb} classes and {d} components: the "
                         f"kernels take {BLOCKS}")
    cudalib.check_tensors({name: t for name, (t, _) in named.items()},
                          ops.lam.device, ops.lam.dtype)
    for name, (t, trailing) in named.items():
        want = lead + tuple(trailing)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want}")
    for name, (t, _) in named.items():
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the spectral modal "
                             "kernels take CUDA tensors (the plain chain is "
                             "_modal_update's on the CPU)")
        if name in streamed and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _pairs(prefix, pair, trailing):
    re, im = pair
    return {f"{prefix}.re": (re, trailing), f"{prefix}.im": (im, trailing)}


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _streamed_ptrs(streamed):
    return [t.data_ptr() for t, _ in streamed.values()]


# ns_spectral_helmholtz_<f32|f64>(nb, d, modes, Uh, Uh_old, Ch, M, G, P
# (re, im each), lam, Ph (re, im), c1, c2, a0k, visc, out (re, im), stream)
HELMHOLTZ_ARGS = (_I, _I, _L) + (_P,) * 15 + (_D,) * 4 + (_P,) * 3


def helmholtz(ops, Ch, Uh, Uh_old, Ph, alpha, k, visc):
    """U* of the Helmholtz phase: P diag(1/(a0/k + visc lam)) P^H Bh with
    Bh = M (-(a1/k) Uh - (a2/k) Uh_old) - Ch - G Ph, per mode, in one
    launch.  ``alpha`` (a0, a1, a2), ``k`` and ``visc`` are Python
    floats, passed by value."""
    lead, nb, d = _layout(ops)
    vec, sym = (nb, d), (nb, nb)
    streamed = {**_pairs("Uh", Uh, vec), **_pairs("Uh_old", Uh_old, vec),
                **_pairs("Ch", Ch, vec), **_pairs("Mhat", ops.Mhat, sym),
                **_pairs("Ghat", ops.Ghat, vec), **_pairs("P", ops.P, sym),
                "lam": (ops.lam, (nb,))}
    _check({**streamed, **_pairs("Ph", Ph, ())}, ops, streamed)
    a0, a1, a2 = alpha
    out = (torch.empty_like(Uh[0]), torch.empty_like(Uh[1]))
    fn = cudalib.entry("spectral_helmholtz", Uh[0].dtype, HELMHOLTZ_ARGS)
    device = Uh[0].device
    with cudalib.on_device(device):
        err = fn(nb, d, math.prod(lead), *_streamed_ptrs(streamed),
                 *_ptrs(*Ph), -(a1 / k), -(a2 / k), a0 / k, float(visc),
                 *_ptrs(*out), cudalib.current_stream(device))
    cudalib.check_error(err, "spectral_helmholtz")
    cudalib.LAUNCHES["spectral_modal"] += 1
    return out


# ns_spectral_poisson_<f32|f64>(nb, d, modes, U*, D (re, im each), Linv,
# a0k, out (re, im), stream)
POISSON_ARGS = (_I, _I, _L) + (_P,) * 5 + (_D,) + (_P,) * 3


def poisson(ops, Ustar, a0k):
    """Phi of the Poisson phase: Linv a0k (D . U*), per mode, in one
    launch."""
    lead, nb, d = _layout(ops)
    streamed = {**_pairs("Ustar", Ustar, (nb, d)),
                **_pairs("Dhat", ops.Dhat, (nb, d))}
    _check({**streamed, "Linv": (ops.Linv, ())}, ops, streamed)
    out = (torch.empty_like(ops.Linv), torch.empty_like(ops.Linv))
    fn = cudalib.entry("spectral_poisson", Ustar[0].dtype, POISSON_ARGS)
    device = Ustar[0].device
    with cudalib.on_device(device):
        err = fn(nb, d, math.prod(lead), *_streamed_ptrs(streamed),
                 ops.Linv.data_ptr(), float(a0k), *_ptrs(*out),
                 cudalib.current_stream(device))
    cudalib.check_error(err, "spectral_poisson")
    return out


# ns_spectral_correction_<f32|f64>(nb, d, modes, U*, G, P, Phi, Ph (re, im
# each), -k/a0, zero_mode, Uh_new, Ph_new (re, im each), stream)
CORRECTION_ARGS = (_I, _I, _L) + (_P,) * 10 + (_D, _I) + (_P,) * 5


def correction(ops, Ustar, Phi, Ph, ka0, has_zero_mode):
    """``(Uh_new, Ph_new)`` of the correction phase: U* - ka0 P P^H (G Phi)
    and Ph + Phi, per mode, in one launch; with ``has_zero_mode``, mode 0
    of Ph_new is zero."""
    lead, nb, d = _layout(ops)
    streamed = {**_pairs("Ustar", Ustar, (nb, d)),
                **_pairs("Ghat", ops.Ghat, (nb, d)),
                **_pairs("P", ops.P, (nb, nb))}
    _check({**streamed, **_pairs("Phi", Phi, ()), **_pairs("Ph", Ph, ())},
           ops, streamed)
    uh = (torch.empty_like(Ustar[0]), torch.empty_like(Ustar[1]))
    ph = (torch.empty_like(Ph[0]), torch.empty_like(Ph[1]))
    fn = cudalib.entry("spectral_correction", Ustar[0].dtype,
                       CORRECTION_ARGS)
    device = Ustar[0].device
    with cudalib.on_device(device):
        err = fn(nb, d, math.prod(lead), *_streamed_ptrs(streamed),
                 *_ptrs(*Phi, *Ph), -float(ka0), int(bool(has_zero_mode)),
                 *_ptrs(*uh, *ph), cudalib.current_stream(device))
    cudalib.check_error(err, "spectral_correction")
    return uh, ph

