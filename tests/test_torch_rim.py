"""Port parity: the rim formats of the operator engine on wall-bounded
boxes (``AffineBand``, ``GatherOp``, ``build_rim_operator`` and the rim
branch of ``FastTaylorHood`` in assembly/fastop.py).

CPU, float64.  Host assembly is the same NumPy code on both sides, so the
chosen formats, window geometry, band blocks and COO triplets must be
EQUAL; the applies and diagonals differ only in summation order (torch
against XLA, the padded row gather against an indexed add) and are held to
1e-12 absolute on unit-normal inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import hyper_cube, hyper_rectangle

ATOL = 1e-12      # summation order only, O(1) values


def _spaces(fixture):
    if fixture == "channel":        # the fixture of tests/test_fastop.py
        args = ((0.0, 0.0), (2.0, 1.0), (12, 6))
        return (JaxSpace(jax_hyper_rectangle(*args)[0]),
                TaylorHoodSpace(hyper_rectangle(*args)[0]))
    return (JaxSpace(jax_hyper_cube(2, 8)[0]),
            TaylorHoodSpace(hyper_cube(2, 8)[0]))


_ENGINES = {}


def _engines(fixture, rim, monkeypatch):
    """Both packages' engines on ``fixture``; ``rim == "gather"`` forces
    the couplings onto the sorted-COO format through NS_FASTOP_RIM_BYTES
    (as tests/test_fastop.py::test_rim_gather_fallback does)."""
    if (fixture, rim) not in _ENGINES:
        if rim == "gather":
            monkeypatch.setenv("NS_FASTOP_RIM_BYTES", "0")
        js, ts = _spaces(fixture)
        _ENGINES[fixture, rim] = (jfo.FastTaylorHood(js),
                                  tfo.FastTaylorHood(ts, device="cpu"))
    return _ENGINES[fixture, rim]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


CASES = [(f, r) for f in ("channel", "cavity") for r in ("band", "gather")]


@pytest.mark.parametrize("fixture,rim", CASES)
def test_chosen_formats_and_arrays_equal(fixture, rim, monkeypatch):
    jf, tf = _engines(fixture, rim, monkeypatch)
    assert np.array_equal(tf.permU, jf.permU)
    assert np.array_equal(tf.permP, jf.permP)
    assert tf.structured and jf.structured
    # no strided convection without a torus (test_fastop.py:368)
    assert tf.conv_strided is None and jf.conv_strided is None
    for name in ("M", "K", "L", "Mp"):
        jo, to = getattr(jf, name), getattr(tf, name)
        assert type(to).__name__ == type(jo).__name__ == "CirculantBand"
        assert list(to.offsets) == list(jo.offsets)
        assert np.array_equal(to.band.numpy(), np.asarray(jo.band))
    want = "GatherOp" if rim == "gather" else "AffineBand"
    for jo, to in zip(jf.G + jf.D, tf.G + tf.D):
        assert type(to).__name__ == type(jo).__name__ == want
        assert (to.n_rows, to.n_cols) == (jo.n_rows, jo.n_cols)
        assert to.nbytes == jo.nbytes
        if want == "AffineBand":
            for attr in ("stride", "b_lo", "nblk", "T", "W", "pad_back",
                         "n_tiles"):
                assert getattr(to, attr) == getattr(jo, attr), attr
            assert np.array_equal(to.bandmat.numpy(), np.asarray(jo.bandmat))
        else:
            for attr in ("rows", "cols", "vals"):
                assert np.array_equal(getattr(to, attr).numpy(),
                                      np.asarray(getattr(jo, attr))), attr


@pytest.mark.parametrize("fixture,rim", CASES)
def test_applies_and_diagonals_match(fixture, rim, monkeypatch):
    jf, tf = _engines(fixture, rim, monkeypatch)
    rng = np.random.default_rng(5)
    nu, np_ = jf.space.n_unodes, jf.space.n_pnodes
    u = rng.standard_normal((2, nu))
    p = rng.standard_normal((3, np_))            # a batch of pressures
    ut, pt, uj, pj = torch.tensor(u), torch.tensor(p), jnp.asarray(u), \
        jnp.asarray(p)
    for d in range(2):
        _close(tf.G[d].apply(pt), jf.G[d].apply(pj))
        _close(tf.G[d].apply(pt[0]), jf.G[d].apply(pj[0]))
        _close(tf.D[d].apply(ut), jf.D[d].apply(uj))
        _close(tf.D[d].apply(ut[d]), jf.D[d].apply(uj[d]))
    for name, (xt, xj) in (("M", (ut, uj)), ("K", (ut, uj)),
                           ("L", (pt, pj)), ("Mp", (pt, pj))):
        _close(getattr(tf, name).apply(xt), getattr(jf, name).apply(xj))
    for got, want in zip(tf.diagonals(), jf.diagonals()):
        _close(got, want)
    _close(tfo.conv_apply(tf.ops, ut, 0.7), jfo.conv_apply(jf.ops, uj, 0.7))
    flat = rng.standard_normal(nu * 2)
    _close(tf.interleaved_to_planar(flat),
           jf.interleaved_to_planar(jnp.asarray(flat)))
    _close(tf.planar_to_interleaved(ut), jf.planar_to_interleaved(uj))


@pytest.mark.parametrize("name", ["M", "L"])
def test_square_affine_band_matches(name, monkeypatch):
    """A square operator forced into an ``AffineBand``
    (``circulant_cap=0``): geometry and blocks equal, apply and diagonal
    to 1e-12 (test_fastop.py::test_affine_band_forced at operator level;
    the port's engine refuses the non-circulant case, which needs the RCM
    ordering)."""
    jf, tf = _engines("channel", "band", monkeypatch)
    jop, top = getattr(jf, name), getattr(tf, name)
    n = top.n
    import scipy.sparse as sp

    rows = np.tile(np.arange(n), len(top.offsets))
    cols = np.concatenate([(np.arange(n) + o) % n for o in top.offsets])
    A = sp.csr_matrix((top.band.numpy().ravel(), (rows, cols)), shape=(n, n))
    A.eliminate_zeros()
    ja = jfo.build_operator(A, np.float64, circulant_cap=0)
    ta = tfo.build_operator(A, torch.float64, "cpu", circulant_cap=0)
    assert isinstance(ta, tfo.AffineBand) and isinstance(ja, jfo.AffineBand)
    assert (ta.stride, ta.b_lo, ta.W) == (ja.stride, ja.b_lo, ja.W)
    assert np.array_equal(ta.bandmat.numpy(), np.asarray(ja.bandmat))
    x = np.random.default_rng(6).standard_normal((2, n))
    _close(ta.apply(torch.tensor(x)), ja.apply(jnp.asarray(x)))
    _close(ta.apply(torch.tensor(x)), jop.apply(jnp.asarray(x)))
    _close(ta.diagonal(), ja.diagonal())
    _close(ta.diagonal(), jop.diagonal())


@pytest.mark.parametrize("rim", ["band", "gather"])
def test_planar_ops_round_trip_carries_the_rim_formats(rim, monkeypatch):
    """``planar_ops_to_numpy`` of the JAX engine loads into the port with
    either coupling format, and applies as the port's own engine does."""
    jf, tf = _engines("cavity", rim, monkeypatch)
    d = tfo.planar_ops_to_numpy(jf)
    assert d["G"][0]["format"] == ("GatherOp" if rim == "gather"
                                   else "AffineBand")
    ops = tfo.planar_ops_from_numpy(d, device="cpu")
    again = tfo.planar_ops_to_numpy(tf)
    for key in ("G", "D"):
        for a, b in zip(d[key], again[key]):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    p = torch.tensor(np.random.default_rng(7).standard_normal(
        jf.space.n_pnodes))
    for got, own in zip(ops.G, tf.G):
        assert type(got) is type(own)
        assert torch.equal(got.apply(p), own.apply(p))


def test_gather_apply_repeats_itself():
    """The padded row gather sums in a fixed order: two applies give the
    same bits (an atomic scatter-add need not)."""
    rng = np.random.default_rng(8)
    import scipy.sparse as sp

    A = sp.random(300, 500, density=0.05, random_state=3, format="csr")
    op = tfo.GatherOp.from_scipy(A, torch.float64, "cpu")
    x = torch.tensor(rng.standard_normal((4, 500)))
    y = op.apply(x)
    assert torch.equal(y, op.apply(x))
    np.testing.assert_allclose(y.numpy(), (A @ x.numpy().T).T, rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="sorted"):
        tfo.GatherOp([2, 1], [0, 0], [1.0, 1.0], (3, 3), torch.float64,
                     "cpu")


def test_structure_error_and_caps():
    import scipy.sparse as sp

    A = sp.random(400, 400, density=0.2, random_state=4, format="csr")
    with pytest.raises(tfo.StructureError, match="window"):
        tfo.build_operator(A, torch.float64, "cpu", circulant_cap=0,
                           window_cap=16)
    with pytest.raises(tfo.StructureError, match="NS_FASTOP_MAX_BYTES"):
        tfo.build_operator(A, torch.float64, "cpu", circulant_cap=0,
                           max_bytes=1000)
    assert issubclass(tfo.StructureError, ValueError)
    # build_rim_operator falls back to the gather format instead
    op = tfo.build_rim_operator(A, torch.float64, "cpu", circulant_cap=0,
                                max_bytes=1000)
    assert isinstance(op, tfo.GatherOp)
    with pytest.raises(ValueError, match="exceeds"):
        tfo.build_operator(A, torch.float64, "cpu", circulant_cap=1000)
