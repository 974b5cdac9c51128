"""Port parity: the plain versions of the two band kernels, and what the
wrappers refuse.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).  Here, on the CPU:

* ``circulant_apply_plain`` against the JAX ``stack`` lowering at f64
  (1e-13 relative: summation order only) and against the Pallas TPU kernel
  run in interpret mode at f32 (1e-6 relative: f32 summation order);
* ``circulant_pcg_plain`` against the JAX ``_pcg`` at f64 (1e-12
  relative: summation order, amplified over 25 iterations) and against
  the Pallas whole-solve kernel in interpret mode at f32 (the tolerances
  of tests/test_pallas_band.py: 1e-5 relative on x, and
  |d||r||| <= 1e-4 ||r|| + 1e-6).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly import pallas_band
from navierstokes_tpu.assembly.fastop import CirculantBand as JaxBand
from navierstokes_tpu.solvers.planar_step import _pcg as jax_pcg
from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.assembly import cuda_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torus_offsets(n, W):
    return sorted({(c + j) % n
                   for c in (0, W, 2 * W, n - W, n - 2 * W)
                   for j in (-2, -1, 0, 1, 2)})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,W,batch", [(1024, 128, 1), (16384, 256, 2),
                                       (1000, 100, 2)])
def test_apply_plain_matches_jax_stack(n, W, batch):
    rng = np.random.default_rng(7)
    offs = _torus_offsets(n, W)
    band = rng.standard_normal((len(offs), n))
    x = rng.standard_normal((batch, n) if batch > 1 else (n,))
    cb = JaxBand(offs, band, np.float64)
    cb.mode = "stack"
    want = np.asarray(cb.apply(jnp.asarray(x)))
    got = cuda_band.circulant_apply_plain(torch.as_tensor(band), offs,
                                          torch.as_tensor(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-13


def test_apply_plain_matches_pallas_interpret_f32():
    rng = np.random.default_rng(8)
    n, W, batch = 4096, 128, 2
    offs = _torus_offsets(n, W)
    band = rng.standard_normal((len(offs), n)).astype(np.float32)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    want = np.asarray(pallas_band.circulant_apply(
        jnp.asarray(band), offs, jnp.asarray(x), interpret=True))
    got = cuda_band.circulant_apply_plain(torch.as_tensor(band), offs,
                                          torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


def _spd_case(kind, dtype):
    """(band, offsets, b, x0, inv_diag, maskv, meanfree) on n = 4096.

    ``plain``: the SPD band of tests/test_pallas_band.py:88-96;
    ``masked``: the same with 2 planes and a strip of fixed nodes whose
    right-hand side and start carry the fixed values, as the step builds
    them; ``meanfree``: a zero-row-sum (Laplacian-like) band, 1 plane.
    """
    rng = np.random.default_rng(11)
    n, W = 4096, 128
    offs = sorted({(c + j) % n for c in (0, W, n - W) for j in (-1, 0, 1)})
    band = np.full((len(offs), n), -1.0)
    band[offs.index(0)] = 2.0 * len(offs)
    shape = (n,)
    maskv, meanfree = 1.0, False
    if kind == "masked":
        shape = (2, n)
        fixed = np.zeros(shape, bool)
        fixed[:, :300] = True
        maskv = np.where(fixed, 0.0, 1.0)
    elif kind == "meanfree":
        band[offs.index(0)] = len(offs) - 1.0
        meanfree = True
    b = rng.standard_normal(shape)
    x0 = np.zeros(shape)
    if kind == "masked":
        g = np.where(fixed, rng.standard_normal(shape), 0.0)
        b = np.where(fixed, g, b)
        x0 = g
    inv_diag = 1.0 / band[offs.index(0)]
    if not np.isscalar(maskv):
        maskv = maskv.astype(dtype)
    band, b, x0, inv_diag = (a.astype(dtype) for a in (band, b, x0, inv_diag))
    return band, offs, b, x0, inv_diag, maskv, meanfree


def _jax_reference(band, offs, b, x0, inv_diag, maskv, meanfree, iters):
    cb = JaxBand(offs, band, band.dtype)
    cb.mode = "stack"
    masked = not np.isscalar(maskv)
    m = jnp.asarray(maskv) if masked else None

    def matvec(v):
        if masked:
            return m * cb.apply(m * v) + (1.0 - m) * v
        return cb.apply(v)

    project = None
    if masked:
        def project(r):
            return m * r
    elif meanfree:
        def project(r):
            return r - jnp.mean(r)

    return jax_pcg(matvec, jnp.asarray(b), jnp.asarray(x0), iters,
                   inv_diag=jnp.asarray(inv_diag), project=project)


def _torch_plain(band, offs, b, x0, inv_diag, maskv, meanfree, iters):
    t = torch.as_tensor
    mask = maskv if np.isscalar(maskv) else t(maskv)
    return cuda_band.circulant_pcg_plain(t(band), offs, t(b), t(x0),
                                         t(inv_diag), mask, iters, meanfree)


@pytest.mark.parametrize("kind", ["plain", "masked", "meanfree"])
def test_pcg_plain_matches_jax_pcg(kind):
    case = _spd_case(kind, np.float64)
    x_ref, res_ref = _jax_reference(*case, 25)
    x, r = _torch_plain(*case, 25)
    assert _rel(x, x_ref) <= 1e-12
    res = float(torch.linalg.vector_norm(r))
    assert abs(res - float(res_ref)) <= 1e-12 * max(float(res_ref), 1e-300)


@pytest.mark.parametrize("kind", ["plain", "masked", "meanfree"])
def test_pcg_plain_matches_pallas_interpret_f32(kind):
    band, offs, b, x0, invd, maskv, meanfree = _spd_case(kind, np.float32)
    mask_j = jnp.asarray(maskv, jnp.float32)
    x_pal, r_pal = pallas_band.circulant_pcg(
        jnp.asarray(band), offs, jnp.asarray(b), jnp.asarray(x0),
        jnp.asarray(invd), mask_j, 25, meanfree, interpret=True)
    x, r = _torch_plain(band, offs, b, x0, invd, maskv, meanfree, 25)
    assert x.dtype == torch.float32
    assert _rel(x, x_pal) <= 1e-5
    res_pal = float(np.linalg.norm(np.asarray(r_pal, np.float64)))
    res = float(torch.linalg.vector_norm(r.double()))
    assert abs(res - res_pal) <= 1e-4 * res_pal + 1e-6


def test_pcg_scalar_mask_equals_broadcast_ones():
    band, offs, b, x0, invd, _, _ = _spd_case("plain", np.float64)
    t = torch.as_tensor
    args = (t(band), offs, t(b), t(x0), t(invd))
    x1, r1 = cuda_band.circulant_pcg_plain(*args, 1.0, 25, False)
    ones = torch.ones(b.shape[-1], dtype=torch.float64)
    x2, r2 = cuda_band.circulant_pcg_plain(*args, ones, 25, False)
    assert torch.equal(x1, x2) and torch.equal(r1, r2)


def test_pcg_meanfree_refuses_several_planes():
    """The TPU kernel takes the mean over all planes jointly when B > 1
    (navierstokes_tpu/assembly/pallas_band.py:131,151); the port refuses
    that case (both the wrapper and the plain version)."""
    band, offs, _, _, invd, _, _ = _spd_case("meanfree", np.float64)
    b = torch.zeros((2, band.shape[1]), dtype=torch.float64)
    for fn in (cuda_band.circulant_pcg, cuda_band.circulant_pcg_plain):
        with pytest.raises(ValueError, match="B == 1"):
            fn(torch.as_tensor(band), offs, b, b.clone(),
               torch.as_tensor(invd), 1.0, 5, True)


# ---------------------------------------------------------------------------
# what the wrappers refuse, and the CPU dispatch
# ---------------------------------------------------------------------------

def _small_case(dtype=torch.float64):
    rng = np.random.default_rng(0)
    n = 256
    offs = _torus_offsets(n, 32)
    band = torch.as_tensor(rng.standard_normal((len(offs), n))).to(dtype)
    x = torch.as_tensor(rng.standard_normal((2, n))).to(dtype)
    return band, offs, x


def test_cpu_tensors_take_the_plain_versions():
    band, offs, x = _small_case()
    cudalib.reset_launch_counts()
    y = cuda_band.circulant_apply(band, offs, x)
    assert torch.equal(y, cuda_band.circulant_apply_plain(band, offs, x))
    invd = torch.ones(x.shape[-1], dtype=x.dtype)
    got = cuda_band.circulant_pcg(band, offs, x, torch.zeros_like(x), invd,
                                  1.0, 3, False)
    want = cuda_band.circulant_pcg_plain(band, offs, x, torch.zeros_like(x),
                                         invd, 1.0, 3, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cudalib.launched() == {}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_wrappers_refuse_other_dtypes(dtype):
    band, offs, x = _small_case()
    band, x = band.to(dtype), x.to(dtype)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_band.circulant_apply(band, offs, x)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_band.circulant_pcg(band, offs, x, x.clone(), x[0].clone(), 1.0,
                                3, False)


def test_wrappers_refuse_bad_operands():
    band, offs, x = _small_case()
    with pytest.raises(TypeError, match="differs"):
        cuda_band.circulant_apply(band, offs, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_band.circulant_apply(band, offs, x.t().contiguous().t())
    with pytest.raises(ValueError, match="offsets"):
        cuda_band.circulant_apply(band[:-1], offs, x)
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        cuda_band.circulant_apply(band, [o - 1 for o in offs], x)
    with pytest.raises(ValueError, match="scalar maskv"):
        cuda_band.circulant_pcg(band, offs, x, x.clone(), x[0].clone(), 0.5,
                                3, False)


def test_kernel_module_imports_and_builds_lazily(tmp_path, monkeypatch):
    """Importing the kernels' module needs no nvcc (the build happens at
    the first CUDA call), and a missing nvcc raises at build time."""
    code = ("import sys\n"
            "import navierstokes_tpu_torch.cudalib as cl\n"
            "import navierstokes_tpu_torch.solvers.planar_step\n"
            "import navierstokes_tpu_torch.structured\n"
            "assert not cl.load_library.cache_info().currsize\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cudalib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cudalib.build_library()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("fail", [None, "amg_pcg", "link"])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """``build_library`` compiles every source to an object (no
    ``-shared``) and links the objects into the library; a failed compile
    or link raises with nvcc's output and leaves no file behind.  A
    stand-in nvcc logs its arguments."""
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        f"case \"$*\" in *-shared*) [ {fail!r} = 'link' ] && exit 3;; esac\n"
        f"case \"$*\" in *{fail}.cu*) echo broken; exit 2;; esac\n"
        "echo \"ptxas info from $out\"; : > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setattr(cudalib, "BUILD_DIR", tmp_path / "build")
    if fail is not None:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            cudalib.build_library()
        assert list((tmp_path / "build").iterdir()) == []
        return
    path, out = cudalib.build_library()
    assert path == cudalib.library_path() and path.exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]
    calls = log.read_text().splitlines()
    assert len(calls) == len(cudalib.sources()) + 1
    for src in cudalib.sources():
        call = next(c for c in calls if c.endswith(str(src)))
        assert " -c " in f" {call} " and "-shared" not in call
        assert "arch=compute_90a,code=sm_90a" in call
    assert calls[-1].startswith("-shared -o ")
    assert out.count("ptxas info") == len(cudalib.sources()) + 1
    assert cudalib.build_library() == (path, "")
