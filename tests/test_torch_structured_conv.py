"""The structured convection's two kernels (``structured/cuda_conv.py``,
``csrc/structured_conv.cu``).

On the CPU: ``StructuredConvection`` runs its plain chain, bit for bit;
the packed tables hold ``N2``, ``g2_rows`` and ``WN``; the wrappers refuse
what the kernels do not take; the launch count moves only on a launch.

On a card (marked ``cuda``, skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_structured_conv.py``,
as the shared conftest imports JAX): the kernels against the plain chain
at 16^2, 128^2, 4^3, 48^3 and 6x5x7, in f32 (1e-5 of the largest plain
entry) and f64 (1e-12), and two replays of a captured call bit for bit.
The class tables are translation-invariant, so one 8^2 / 4^3 space gives
the tables of every lattice.  This file imports no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               StructuredConvection, cuda_conv)

DIMS = pytest.mark.parametrize("dim", [2, 3])
LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}
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


def _velocity(sg, dtype, device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((sg.n_uclass,) + tuple(sg.shape) + (sg.dim,))
    return torch.tensor(U, dtype=dtype, device=device)


@DIMS
def test_cpu_tensors_take_the_plain_chain(dim):
    """On the CPU the convection is gather_local, quadrature and
    scatter_local, bit for bit, and launches nothing."""
    sg = _sgrid(dim)
    conv = StructuredConvection(sg, device="cpu")
    U = _velocity(sg, torch.float64)
    cudalib.reset_launch_counts()
    want = conv.scatter_local(conv.quadrature(conv.gather_local(U)))
    assert torch.equal(conv(U), want)
    assert torch.equal(conv.plain(U), want)
    assert cudalib.LAUNCHES["structured_convection"] == 0


@DIMS
def test_packed_tables_hold_the_convections_tables(dim):
    """The pack is, per simplex and point, (N2, g2) rows of four and the
    weighted test functions: g2_rows and WN to 1e-15 (f64), from the
    space's reference gradients and weights."""
    sg = _sgrid(dim)
    conv = StructuredConvection(sg, device="cpu")
    tables = conv.tables
    space = sg.space
    ntau, nlu, d = sg.n_tau, sg.n_local_u, dim
    nq = space.N2.shape[0]
    assert (tables.dim, tables.shape, tables.ntau, tables.nlu, tables.nq) == \
        (dim, sg.shape, ntau, nlu, nq)
    pad = -(-nlu // 4) * 4
    assert tables.pack.shape == (ntau, nq * (4 * nlu + pad))
    assert tables.pack.dtype == torch.float64
    rows = tables.pack[:, :nq * nlu * 4].reshape(ntau, nq, nlu, 4).numpy()
    tests = tables.pack[:, nq * nlu * 4:].reshape(ntau, nq, pad).numpy()
    g2 = np.einsum("qia,tae->tqie", space.G2, sg.Jinv_tau)
    np.testing.assert_allclose(rows[..., 0],
                               np.broadcast_to(space.N2, (ntau, nq, nlu)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(rows[..., 1:1 + d], g2, rtol=0, atol=1e-15)
    assert not rows[..., 1 + d:].any()
    np.testing.assert_allclose(
        rows[..., 1:1 + d].transpose(0, 3, 1, 2).reshape(ntau, d * nq, nlu),
        conv.g2_rows.numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(tests[..., :nlu],
                               sg.W_tau[:, :, None] * space.N2[None],
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(tests[..., :nlu].transpose(0, 2, 1),
                               conv.WN.numpy(), rtol=0, atol=1e-15)
    assert not tests[..., nlu:].any()
    assert list(tables.cls) == sg.u_class.reshape(-1).tolist()
    assert list(tables.shift) == sg.u_shift.reshape(-1).tolist()


def _bad_operand(case, X, lead):
    """``X`` (*lead, *lattice, d) made wrong in one way."""
    if case == "dtype":
        return X.float()
    if case == "rank":
        return X[0]
    if case == "contiguity":
        return X.transpose(1, 2).contiguous().transpose(1, 2)
    if case == "grid":
        return X.narrow(lead, 0, X.shape[lead] - 1).contiguous()
    return X


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguity", "grid",
                                  "cpu"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """A wrong dtype, rank, layout or lattice raises before any launch;
    so does a CPU tensor, which the plain chain takes instead."""
    sg = _sgrid(3, (4, 4, 5))
    conv = StructuredConvection(sg, device="cpu")
    U = _velocity(sg, torch.float64)
    R = conv.quadrature(conv.gather_local(U))
    cudalib.reset_launch_counts()
    error = TypeError if case == "dtype" else ValueError
    match = {"dtype": "float64", "rank": "rank", "contiguity": "contiguous",
             "grid": "expected", "cpu": "CUDA tensors"}[case]
    with pytest.raises(error, match=match):
        cuda_conv.quadrature(_bad_operand(case, U, 1), conv.tables)
    with pytest.raises(error, match=match):
        cuda_conv.scatter(_bad_operand(case, R, 2), conv.tables)
    assert cudalib.LAUNCHES["structured_convection"] == 0


def test_launches_count_only_launches(monkeypatch):
    """The counter moves by one at each quadrature launch that the card
    takes, never on the scatter, on a refused launch or on the CPU."""
    sg = _sgrid(2)
    conv = StructuredConvection(sg, device="cpu")
    U = _velocity(sg, torch.float64)
    R = conv.quadrature(conv.gather_local(U))
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

    check = cuda_conv._check_operand
    monkeypatch.setattr(cuda_conv, "_check_operand",
                        lambda name, X, tables, lead: check(
                            name, X, tables, lead) if X.is_cuda else None)
    monkeypatch.setattr(cudalib, "entry", entry)
    monkeypatch.setattr(cudalib, "load_library", lambda: Lib)
    monkeypatch.setattr(cudalib, "current_stream", lambda device: 0)
    cudalib.reset_launch_counts()
    conv(U)
    assert cudalib.LAUNCHES["structured_convection"] == 0 and not calls
    cuda_conv.quadrature(U, conv.tables)
    cuda_conv.scatter(R, conv.tables)
    assert cudalib.LAUNCHES["structured_convection"] == 1
    assert calls == ["structured_conv_quadrature", "structured_conv_scatter"]
    codes[0] = 1
    for fn, X in ((cuda_conv.quadrature, U), (cuda_conv.scatter, R)):
        with pytest.raises(RuntimeError, match="refused"):
            fn(X, conv.tables)
    assert cudalib.LAUNCHES["structured_convection"] == 1


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the structured convection kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16), (128, 128), (4, 4, 4),
                                   (48, 48, 48), (6, 5, 7)])
def test_kernels_match_the_plain_chain(card, shape, dtype):
    sg = _sgrid(len(shape), shape)
    conv = StructuredConvection(sg, dtype=dtype, device=card)
    U = _velocity(sg, dtype, card)
    cudalib.reset_launch_counts()
    got = conv(U)
    assert cudalib.LAUNCHES["structured_convection"] == 1
    want = conv.plain(U)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= LIMITS[dtype], err
    assert torch.equal(conv(U), got)


@pytest.mark.cuda
@DIMS
def test_captured_replays_are_bitwise_equal(card, dim):
    sg = _sgrid(dim, (16, 16) if dim == 2 else (6, 5, 7))
    conv = StructuredConvection(sg, dtype=torch.float32, device=card)
    U = _velocity(sg, torch.float32, card)
    eager = conv(U)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv(U)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv(U)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out) and torch.equal(first, eager)
