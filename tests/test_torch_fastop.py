"""Port parity: the gather-free operator engine (assembly/fastop.py).

CPU, float64.  Host assembly is the same NumPy code on both sides, so the
permutations, offsets, band arrays, stencil taps and convection tables
must be EQUAL.  The applies differ only in summation order (torch vs XLA
on the CPU), so they are held to 1e-12 absolute on unit-normal inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube, hyper_rectangle

ATOL = 1e-12      # summation order only, O(1) values


@pytest.fixture(scope="module", params=[8, 16])
def engines(request):
    n = request.param
    mesh, _ = jax_hyper_cube(2, n)
    jf = jfo.FastTaylorHood(JaxSpace(
        mesh, periodic=[jax_axis_periodic(0), jax_axis_periodic(1)]))
    mesh, _ = hyper_cube(2, n)
    tf = tfo.FastTaylorHood(TaylorHoodSpace(
        mesh, periodic=[axis_periodic(0), axis_periodic(1)]), device="cpu")
    return jf, tf


def _assert_tree_equal(a, b, path="ops"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_engine_arrays_equal(engines):
    jf, tf = engines
    assert np.array_equal(tf.permU, jf.permU)
    assert np.array_equal(tf.permP, jf.permP)
    for name in ("M", "K", "L", "Mp"):
        assert isinstance(getattr(tf, name), tfo.CirculantBand)
    assert (len(tf.M.offsets), len(tf.L.offsets)) == (23, 9)
    assert all(isinstance(g, tfo.StencilCoupling) for g in tf.G + tf.D)
    assert tf.conv_strided is not None and len(tf.conv_strided.offs) == 2
    _assert_tree_equal(tfo.planar_ops_to_numpy(tf),
                       tfo.planar_ops_to_numpy(jf))


def test_applies_match(engines):
    jf, tf = engines
    rng = np.random.default_rng(3)
    nu, np_ = jf.space.n_unodes, jf.space.n_pnodes
    u = rng.standard_normal((2, nu))
    p = rng.standard_normal(np_)
    ut, pt = torch.as_tensor(u), torch.as_tensor(p)
    uj, pj = jnp.asarray(u), jnp.asarray(p)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)

    for name, (xt, xj) in (("M", (ut, uj)), ("K", (ut, uj)),
                           ("L", (pt, pj)), ("Mp", (pt, pj))):
        close(getattr(tf, name).apply(xt), getattr(jf, name).apply(xj))
    for d in range(2):
        close(tf.G[d].apply(pt), jf.G[d].apply(pj))
        close(tf.D[d].apply(ut[d]), jf.D[d].apply(uj[d]))
    close(tfo.conv_apply(tf.ops, ut, 1.3, strided=tf.conv_strided),
          jfo.conv_apply(jf.ops, uj, 1.3, strided=jf.conv_strided))
    close(tfo.conv_apply(tf.ops, ut, 1.3), jfo.conv_apply(jf.ops, uj, 1.3))
    # fused Helmholtz band with coefficients passed as 0-d tensors
    f64 = torch.float64
    ht = tfo.combine_circulant([(torch.tensor(317.2, dtype=f64), tf.M),
                                (torch.tensor(0.013, dtype=f64), tf.K)])
    hj = jfo.combine_circulant([(jnp.asarray(317.2), jf.M),
                                (jnp.asarray(0.013), jf.K)])
    assert ht.offsets == hj.offsets
    close(ht.band, hj.band)
    close(ht.apply(ut), hj.apply(uj))


def test_planar_ops_round_trip(engines):
    jf, _ = engines
    d = tfo.planar_ops_to_numpy(jf)
    ops = tfo.planar_ops_from_numpy(d, device="cpu")
    assert ops.diag_m.dtype == torch.float64
    assert ops.conv_strided == tfo.StridedConv(
        grid=tuple(jf.conv_strided.grid), offs=jf.conv_strided.offs)

    class Engine:          # the attributes planar_ops_to_numpy reads
        pass

    e = Engine()
    e.ops, e.conv_strided = ops, ops.conv_strided
    e.permU, e.permP = ops.permU, ops.permP
    _assert_tree_equal(tfo.planar_ops_to_numpy(e), d)


def test_meshes_not_ported_yet_raise():
    """(The name dates from when 3D spaces raised.)  Operators that are not
    circulant under the lexicographic order take the RCM ordering: the
    same order and bands as the JAX engine's.  The 3D engine is ported:
    on ``hyper_cube(3, 2)`` its permutations, bands and rim couplings
    equal the JAX engine's (the full 3D suite is
    ``tests/test_torch_fastop3d.py``)."""
    mesh, _ = hyper_rectangle((0.0, 0.0), (2.0, 1.0), (12, 6))
    tf = tfo.FastTaylorHood(TaylorHoodSpace(mesh), device="cpu",
                            circulant_cap=4)
    from navierstokes_tpu.mesh import hyper_rectangle as jax_rectangle

    jmesh, _ = jax_rectangle((0.0, 0.0), (2.0, 1.0), (12, 6))
    jf = jfo.FastTaylorHood(JaxSpace(jmesh), circulant_cap=4)
    assert np.array_equal(tf.permU, np.asarray(jf.permU))
    assert np.array_equal(tf.permP, np.asarray(jf.permP))
    assert not np.array_equal(tf.permU, tfo.lex_permutation(
        tfo.node_coordinates(tf.space)[0]))
    for name in ("M", "K", "L", "Mp"):
        assert isinstance(getattr(tf, name), tfo.AffineBand)
        assert np.array_equal(getattr(tf, name).bandmat.numpy(),
                              np.asarray(getattr(jf, name).bandmat))
    mesh, _ = hyper_cube(3, 2)
    tf = tfo.FastTaylorHood(TaylorHoodSpace(mesh), device="cpu")
    jmesh, _ = jax_hyper_cube(3, 2)
    jf = jfo.FastTaylorHood(JaxSpace(jmesh))
    assert tf.dim == 3 and tf.conv_strided is None
    assert np.array_equal(tf.permU, np.asarray(jf.permU))
    assert np.array_equal(tf.permP, np.asarray(jf.permP))
    for name in ("M", "K", "L", "Mp"):
        t, j = getattr(tf, name), getattr(jf, name)
        assert type(t).__name__ == type(j).__name__ == "CirculantBand"
        assert np.array_equal(t.band.numpy(), np.asarray(j.band))
    for t, j in zip(tf.G + tf.D, list(jf.G) + list(jf.D)):
        assert type(t).__name__ == type(j).__name__
        assert np.array_equal(t.bandmat.numpy(), np.asarray(j.bandmat))
