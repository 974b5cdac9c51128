"""The PCG kernels' plan, their folded iteration, and the default device.

On the CPU no CUDA kernel runs, so what is tested here is what surrounds
them:

* ``cuda_band.pcg_plan`` routes the main path's 128^2 sub-solves and the
  512^2 velocity shape as the kernels are designed for, within the
  shared memory of one sm_90 block;
* route B's (and route A's) iteration, which folds p = z + beta p into the
  next matvec, emulated in plain torch: every neighbour recomputes
  p_new[j] = invd[j] r[j] + beta p_old[j] from r and p_old.  At f64 it
  equals ``_pcg`` (``circulant_pcg_plain``) to 1e-13 relative -- the
  arithmetic is the same, only the mean is a sum over N;
* the port's entry points default to the card and raise without one.
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import (FastTaylorHood,
                                                    planar_ops_from_numpy,
                                                    planar_ops_to_numpy)
from navierstokes_tpu_torch.setups import taylor_green_setup

F32, F64 = torch.float32, torch.float64
VELOCITY_128 = (65_536, 23, 2)      # P2 nodes of 128^2, M/K band, 2 planes
POISSON_128 = (16_384, 9, 1)        # P1 nodes of 128^2, L band
VELOCITY_512 = (1_048_576, 23, 2)
CAVITY_VELOCITY_128 = (66_049, 19, 2)   # wall-bounded 128^2: odd N, K = 19
CAVITY_POISSON_128 = (16_641, 7, 1)


@pytest.mark.parametrize("shape,dtype,has_mask,route,ctas,resident", [
    (POISSON_128, F32, False, "cluster", 16, True),
    (POISSON_128, F64, False, "cluster", 16, True),
    (POISSON_128, F32, True, "cluster", 16, True),
    (VELOCITY_128, F32, False, "grid", 128, True),
    (VELOCITY_128, F64, False, "grid", 128, True),
    (VELOCITY_128, F32, True, "grid", 128, True),
    (VELOCITY_512, F32, False, "grid", 132, False),
    ((4096, 9, 2), F32, True, "cluster", 16, True),
    ((65_536, 9, 1), F32, False, "grid", 64, True),
    # the lid-driven cavity: 2,048 rows per CTA in f32 (7 of the 16 CTAs
    # own no row); in f64 the state no longer fits a cluster
    (CAVITY_POISSON_128, F32, False, "cluster", 16, True),
    (CAVITY_POISSON_128, F64, False, "grid", 17, True),
    (CAVITY_VELOCITY_128, F32, True, "grid", 130, True),
    (CAVITY_VELOCITY_128, F64, True, "grid", 130, True),
], ids=["poisson-f32", "poisson-f64", "poisson-masked-f32",
        "velocity-f32", "velocity-f64", "velocity-masked-f32",
        "velocity512-f32", "small-masked", "poisson256-f32",
        "cavity-poisson-f32", "cavity-poisson-f64",
        "cavity-velocity-masked-f32", "cavity-velocity-masked-f64"])
def test_pcg_plan_routes(shape, dtype, has_mask, route, ctas, resident):
    n, K, batch = shape
    plan = cuda_band.pcg_plan(n, K, batch, dtype, has_mask)
    assert (plan.route, plan.ctas, plan.resident) == (route, ctas, resident)
    assert plan.smem_bytes <= cuda_band.SMEM_PER_BLOCK
    assert plan.ctas * plan.rows >= n
    esize = 4 if dtype == F32 else 8
    if route == "cluster":
        assert plan.rows & (plan.rows - 1) == 0
        vectors = 8 + has_mask
        assert plan.smem_bytes == plan.rows * (K + batch * vectors) * esize
    else:
        assert plan.ctas <= cuda_band.H100_SMS
        assert (plan.ctas - 1) * plan.rows < n
        assert plan.smem_bytes == (K * plan.rows * esize if resident else 0)


def test_pcg_plan_cluster_budget():
    """Poisson at 128^2 on 16 CTAs: 1,024 rows each, 69,632 B in f32 and
    139,264 B in f64 (band 9 rows + 8 vectors); a system whose rows need
    more than a block's shared memory on 16 CTAs takes route B."""
    p32 = cuda_band.pcg_plan(*POISSON_128, F32, False)
    p64 = cuda_band.pcg_plan(*POISSON_128, F64, False)
    assert (p32.rows, p32.smem_bytes) == (1024, 69_632)
    assert (p64.rows, p64.smem_bytes) == (1024, 139_264)
    big = cuda_band.pcg_plan(32_768, 9, 1, F64, True)  # 2048 x 18 x 8 B
    assert big.route == "grid"


def test_index_range_is_checked():
    cuda_band._check_index_range(23, 1 << 20, 2)
    for K, n, batch in ((1, 1 << 30, 1), (1, 1 << 29, 4), (96, 1 << 25, 1)):
        with pytest.raises(ValueError, match="2\\^3"):
            cuda_band._check_index_range(K, n, batch)


def _spd_case(kind):
    """The f64 cases of tests/test_torch_band_kernels.py::_spd_case."""
    rng = np.random.default_rng(11)
    n, W = 4096, 128
    offs = sorted({(c + j) % n for c in (0, W, n - W) for j in (-1, 0, 1)})
    band = np.full((len(offs), n), -1.0)
    band[offs.index(0)] = 2.0 * len(offs)
    shape, mask, meanfree = (n,), None, False
    if kind == "masked":
        shape = (2, n)
        fixed = np.zeros(shape, bool)
        fixed[:, :300] = True
        mask = torch.tensor(np.where(fixed, 0.0, 1.0))
    elif kind == "meanfree":
        band[offs.index(0)] = len(offs) - 1.0
        meanfree = True
    b = rng.standard_normal(shape)
    x0 = np.zeros(shape)
    if kind == "masked":
        g = np.where(fixed, rng.standard_normal(shape), 0.0)
        b, x0 = np.where(fixed, g, b), g
    t = torch.tensor
    return (t(band), offs, t(b), t(x0), t(1.0 / band[offs.index(0)]), mask,
            meanfree)


def _folded_pcg(band, offs, b, x0, invd, mask, iters, meanfree):
    """The kernels' iteration in plain torch: no separate p update; the
    matvec recomputes p_new = invd r + beta p_old at every row it reads,
    and the last beta is not computed."""
    n = b.shape[-1]

    def A(v):
        return cuda_band.circulant_apply_plain(band, offs, v)

    def masked(v):
        return v if mask is None else mask * v

    def op(w, v):
        return w if mask is None else mask * w + (1.0 - mask) * v

    def project(r):
        r = masked(r)
        return r - r.sum() / n if meanfree else r

    zero = torch.zeros((), dtype=b.dtype)
    r = project(b - op(A(masked(x0)), x0))
    x, p_old, beta = x0, torch.zeros_like(b), zero
    rz = torch.sum(r * (invd * r))
    for it in range(iters):
        p_new = invd * r + beta * p_old
        Ap = op(A(masked(p_new)), p_new)
        denom = torch.sum(p_new * Ap)
        alpha = torch.where(denom.abs() > 0.0, rz / denom, zero)
        x = x + alpha * p_new
        r = project(r - alpha * Ap)
        p_old = p_new
        if it + 1 == iters:
            break
        rz_new = torch.sum(r * (invd * r))
        beta = torch.where(rz.abs() > 0.0, rz_new / rz, zero)
        rz = rz_new
    return x, r


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("kind", ["plain", "masked", "meanfree"])
def test_folded_iteration_matches_pcg(kind):
    band, offs, b, x0, invd, mask, meanfree = _spd_case(kind)
    maskv = 1.0 if mask is None else mask
    x_ref, r_ref = cuda_band.circulant_pcg_plain(band, offs, b, x0, invd,
                                                 maskv, 25, meanfree)
    x, r = _folded_pcg(band, offs, b, x0, invd, mask, 25, meanfree)
    assert _rel(x, x_ref) <= 1e-13
    assert _rel(r, r_ref) <= 1e-13


def test_default_device_is_the_card():
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.default_dtype("cpu") == torch.float64


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_engine_without_device_raises_without_a_card():
    _no_card()
    space, _, _ = taylor_green_setup(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastTaylorHood(space)


def test_ops_from_numpy_without_device_raises_without_a_card():
    _no_card()
    space, _, _ = taylor_green_setup(8)
    d = planar_ops_to_numpy(FastTaylorHood(space, device="cpu"))
    with pytest.raises(RuntimeError, match="is_available"):
        planar_ops_from_numpy(d)
    assert planar_ops_from_numpy(d, device="cpu").diag_m.device.type == "cpu"
