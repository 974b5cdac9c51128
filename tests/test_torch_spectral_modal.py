"""The spectral step's three per-mode kernels (``structured/cuda_modal.py``,
``csrc/spectral_modal.cu``).

On the CPU: ``_modal_update`` is the plain chain, bit for bit, and launches
nothing; the wrappers refuse what the kernels do not take; the launch
count moves only on a launch.

On a card (marked ``cuda``, skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_spectral_modal.py``,
as the shared conftest imports JAX): each kernel against its phase's plain
chain at 16^2, 128^2, 4^3, 48^3 and 6x5x7, in f32 (1e-5 of the largest
plain entry) and f64 (1e-12), with and without the zero mode; the modal
update on the slab views of ``shard_spectral_step``; and two replays of a
captured step bit for bit.  The symbols are translation-invariant, so one
8^2 / 4^3 space gives the operators of every lattice.  This file imports no
JAX.
"""

import copy

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               SpectralOperators, cuda_modal,
                                               spectral)
from navierstokes_tpu_torch.structured.spectral import SplitC, _axpy

DIMS = pytest.mark.parametrize("dim", [2, 3])
LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}
ALPHA, K, VISC = (1.5, -2.0, 0.5), 1.0e-3, 1.0e-2
_GRIDS = {}


def _sgrid(dim, shape=None):
    """The class grids of the periodic ``hyper_cube(dim, 8 or 4)``, with
    their lattice set to ``shape``."""
    if dim not in _GRIDS:
        mesh, _ = hyper_cube(dim, 8 if dim == 2 else 4)
        _GRIDS[dim] = PeriodicStructuredTH(TaylorHoodSpace(
            mesh, periodic=[axis_periodic(a) for a in range(dim)]))
    sg = _GRIDS[dim]
    if shape is None or tuple(shape) == sg.shape:
        return sg
    sg = copy.copy(sg)
    sg.shape = tuple(shape)
    return sg


def _fields(ops, dtype, device="cpu", seed=5):
    """Seeded spectral fields (Ch, Uh, Uh_old, Ph) on ``ops``'s modes."""
    rng = np.random.default_rng(seed)
    lead = tuple(ops.Linv.shape)
    vec = lead + (ops.n_uclass, ops.d)

    def split(shape):
        return SplitC(*(torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                     device=device) for _ in range(2)))

    return split(vec), split(vec), split(vec), split(lead)


def _chain(ops, Ch, Uh, Uh_old, Ph, has_zero_mode):
    """The modal update as the plain chain wrote it out before the kernels,
    operation by operation."""
    a0, a1, a2 = ALPHA
    Bh = _axpy(-(a1 / K), ops.mass(Uh), None)
    Bh = _axpy(-(a2 / K), ops.mass(Uh_old), Bh)
    Bh = _axpy(-1.0, Ch, Bh)
    Bh = _axpy(-1.0, ops.grad(Ph), Bh)
    Ustar = ops.helmholtz_solve(a0 / K, VISC, Bh)
    Phi = ops.poisson_solve(_axpy(a0 / K, ops.div(Ustar), None))
    Uh_new = _axpy(-(K / a0), ops.mass_solve(ops.grad(Phi)), Ustar)
    Ph_new = SplitC(Ph.re + Phi.re, Ph.im + Phi.im)
    if has_zero_mode:
        Ph_new.re[(0,) * ops.dim].zero_()
        Ph_new.im[(0,) * ops.dim].zero_()
    return Uh_new, Ph_new


def _equal(a, b):
    return torch.equal(a.re, b.re) and torch.equal(a.im, b.im)


@pytest.mark.parametrize("has_zero_mode", [True, False])
@DIMS
def test_cpu_tensors_take_the_plain_chain(dim, has_zero_mode):
    """On the CPU the modal update is the plain chain, bit for bit, and
    launches nothing."""
    sg = _sgrid(dim)
    ops = SpectralOperators(sg, dtype=torch.float64, device="cpu")
    Ch, Uh, Uh_old, Ph = _fields(ops, torch.float64)
    cudalib.reset_launch_counts()
    got = spectral._modal_update(ops, Ch, Uh, Uh_old, Ph, ALPHA, K, VISC,
                                 has_zero_mode)
    want = _chain(ops, Ch, Uh, Uh_old, Ph, has_zero_mode)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])
    assert bool(got[1].re[(0,) * dim] == 0) == has_zero_mode
    assert cudalib.LAUNCHES["spectral_modal"] == 0


def _calls(ops, Ch, Uh, Uh_old, Ph):
    """Each wrapper, as a thunk, with these fields."""
    Ustar, Phi = Uh, Ph
    return [
        lambda: cuda_modal.helmholtz(ops, Ch, Uh, Uh_old, Ph, ALPHA, K, VISC),
        lambda: cuda_modal.poisson(ops, Ustar, ALPHA[0] / K),
        lambda: cuda_modal.correction(ops, Ustar, Phi, Ph, K / ALPHA[0],
                                      True)]


def _bad(case, pair):
    """A (re, im) pair made wrong in one way."""
    re, im = pair
    if case == "dtype":
        return SplitC(re.float(), im.float())
    if case == "shape":
        return SplitC(re[:-1].contiguous(), im[:-1].contiguous())
    if case == "contiguity":
        t = re.transpose(0, 1).contiguous().transpose(0, 1)
        return SplitC(t, im)
    return pair


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "cpu",
                                  "blocks"])
@DIMS
def test_wrappers_refuse_what_the_kernels_do_not_take(dim, case,
                                                      monkeypatch):
    """A wrong dtype, shape or layout raises before any launch; so does a
    CPU tensor, which the plain chain takes instead, and a block shape the
    kernels are not built for."""
    sg = _sgrid(dim, (4, 6) if dim == 2 else (4, 2, 3))
    ops = SpectralOperators(sg, dtype=torch.float64, device="cpu")
    Ch, Uh, Uh_old, Ph = _fields(ops, torch.float64)
    if case == "blocks":
        monkeypatch.setattr(cuda_modal, "BLOCKS", ())
    error = TypeError if case == "dtype" else ValueError
    match = {"dtype": "float64", "shape": "expected",
             "contiguity": "contiguous", "cpu": "CUDA tensors",
             "blocks": "kernels take"}[case]
    cudalib.reset_launch_counts()
    # the bad operand is the velocity-shaped input of each wrapper
    for call in _calls(ops, Ch, _bad(case, Uh), Uh_old, Ph):
        with pytest.raises(error, match=match):
            call()
    assert cudalib.LAUNCHES["spectral_modal"] == 0


def test_launches_count_only_launches(monkeypatch):
    """The counter moves by one at each Helmholtz launch that the card
    takes, never on the Poisson or correction launch, on a refused launch
    or on the CPU."""
    sg = _sgrid(2)
    ops = SpectralOperators(sg, dtype=torch.float64, device="cpu")
    Ch, Uh, Uh_old, Ph = _fields(ops, torch.float64)
    codes, calls = [0], []

    def entry(name, dtype, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(name)
            return codes[0]
        return fn

    class Lib:
        @staticmethod
        def ns_error_string(err):
            return b"refused"

    check = cuda_modal._check
    monkeypatch.setattr(cuda_modal, "_check",
                        lambda named, ops, streamed: check(
                            named, ops, streamed)
                        if ops.lam.is_cuda else None)
    monkeypatch.setattr(cudalib, "entry", entry)
    monkeypatch.setattr(cudalib, "load_library", lambda: Lib)
    monkeypatch.setattr(cudalib, "current_stream", lambda device: 0)
    cudalib.reset_launch_counts()
    spectral._modal_update(ops, Ch, Uh, Uh_old, Ph, ALPHA, K, VISC, True)
    assert cudalib.LAUNCHES["spectral_modal"] == 0 and not calls
    for call in _calls(ops, Ch, Uh, Uh_old, Ph):
        call()
    assert cudalib.LAUNCHES["spectral_modal"] == 1
    assert calls == ["spectral_helmholtz", "spectral_poisson",
                     "spectral_correction"]
    codes[0] = 1
    for call in _calls(ops, Ch, Uh, Uh_old, Ph):
        with pytest.raises(RuntimeError, match="refused"):
            call()
    assert cudalib.LAUNCHES["spectral_modal"] == 1


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spectral modal kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    """The largest error of a (re, im) pair over its largest plain
    entry."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(float(w.abs().max()) for w in want)


def _phases(ops, Ch, Uh, Uh_old, Ph, has_zero_mode):
    """Each kernel and its phase's plain chain from the same inputs:
    {phase: [(kernel output, plain output), ...]}.  The plain chain zeroes
    the pressure of mode 0 with ``has_zero_mode``, so a kernel that did
    not would miss by an entry of ``Ph``."""
    a0 = ALPHA[0]
    Ustar = spectral._helmholtz_plain(ops, Ch, Uh, Uh_old, Ph, ALPHA, K,
                                      VISC)
    Phi = spectral._poisson_plain(ops, Ustar, a0 / K)
    Uh_new, Ph_new = spectral._correction_plain(ops, Ustar, Phi, Ph, K / a0,
                                                has_zero_mode)
    uh, ph = cuda_modal.correction(ops, Ustar, Phi, Ph, K / a0,
                                   has_zero_mode)
    return {"helmholtz": [(cuda_modal.helmholtz(ops, Ch, Uh, Uh_old, Ph,
                                                ALPHA, K, VISC), Ustar)],
            "poisson": [(cuda_modal.poisson(ops, Ustar, a0 / K), Phi)],
            "correction": [(uh, Uh_new), (ph, Ph_new)]}


@pytest.mark.cuda
@pytest.mark.parametrize("has_zero_mode", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16), (128, 128), (4, 4, 4),
                                   (48, 48, 48), (6, 5, 7)])
def test_kernels_match_the_plain_chain(card, shape, dtype, has_zero_mode):
    ops = SpectralOperators(_sgrid(len(shape), shape), dtype=dtype,
                            device=card)
    fields = _fields(ops, dtype, card)
    cudalib.reset_launch_counts()
    for phase, pairs in _phases(ops, *fields, has_zero_mode).items():
        for got, want in pairs:
            err = _rel(got, want)
            assert err <= LIMITS[dtype], (phase, err)
    assert cudalib.LAUNCHES["spectral_modal"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_views_match_the_whole_box(card, dtype):
    """``_modal_update`` on the slab views of ``shard_spectral_step`` (a
    slab's modes; the zero mode on shard 0 only) gives the slabs of the
    plain chain's update of the whole box."""
    shape, n = (6, 8, 5), 2
    w = shape[1] // n
    ops = SpectralOperators(_sgrid(3, shape), dtype=dtype, device=card)
    fields = _fields(ops, dtype, card)
    want = _chain(ops, *fields, True)
    for s in range(n):
        view = spectral._slab_ops(ops, s, w, card)
        mine = [SplitC(*(spectral._slab(t, 1, s, w, card) for t in f))
                for f in fields]
        got = spectral._modal_update(view, *mine, ALPHA, K, VISC, s == 0)
        for g, full in zip(got, want):
            part = [spectral._slab(t, 1, s, w, card) for t in full]
            assert _rel(g, part) <= LIMITS[dtype]


@pytest.mark.cuda
@DIMS
def test_captured_replays_are_bitwise_equal(card, dim):
    shape = (16, 16) if dim == 2 else (6, 5, 7)
    ops = SpectralOperators(_sgrid(dim, shape), dtype=torch.float32,
                            device=card)
    fields = _fields(ops, torch.float32, card)

    def update():
        return spectral._modal_update(ops, *fields, ALPHA, K, VISC, True)

    eager = update()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        update()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    cudalib.reset_launch_counts()
    with torch.cuda.graph(graph):
        out = update()
    assert cudalib.LAUNCHES["spectral_modal"] == 1
    graph.replay()
    first = [t.clone() for pair in out for t in pair]
    graph.replay()
    torch.cuda.synchronize()
    again = [t for pair in out for t in pair]
    ref = [t for pair in eager for t in pair]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
