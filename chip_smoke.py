"""Drive the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. device   -- refuse to run without CUDA; print the card's name and power
               limit as nvidia-smi reports them.
2. build    -- compile the band kernels (navierstokes_tpu_torch/csrc/band.cu)
               with nvcc and load them.
3. kernels  -- hold each kernel against its plain torch version on the
               card (f32 and f64), and time both at the main path's shapes
               with CUDA events (median of 30 runs after warm-up).
4. main     -- the generic banded SBDF-2 projection step on the periodic
               Taylor-Green vortex at 128^2, f32, configured as bench.py's
               generic path: Re = 100, dt = 1e-3, cg_iters = (10, 60, 6),
               one BDF-1 step and 3 BDF-2 warm-up steps, then 200 timed
               BDF-2 steps.  Requires finite values, amp_rel_err < 0.05 and
               launches of both kernels; prints DoF-steps/s and the residual
               triple of one extra step.
5. parity   -- 10 steps at 128^2, f64, on the card (kernels) and on the CPU
               (plain versions) from the same state; u and p must agree to
               1e-9 relative.
6. the ``kernels`` line, then the card's nvidia-smi line, then the last
   line ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes a torch.profiler table of 10 main-path steps
to DIR.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import (FastTaylorHood,
                                                    combine_circulant,
                                                    planar_ops_from_numpy,
                                                    planar_ops_to_numpy)
from navierstokes_tpu_torch.setups import taylor_green_setup
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step

RE = 100.0
DT = 1.0e-3
N_POINTS = 128
CG_ITERS = (10, 60, 6)
N_WARMUP = 4
N_STEPS = 200
N_PARITY = 10
ALPHAS = ((1.0, -1.0, 0.0), (1.5, -2.0, 0.5))
ETAS = ((1.0, 0.0), (2.0, -1.0))
RUNS = 30
DEVICE = "cuda:0"
REPLACES = {
    "circulant_apply":
        "navierstokes_tpu/assembly/pallas_band.py:220 (pallas_call :106)",
    "circulant_pcg":
        "navierstokes_tpu/assembly/pallas_band.py:202 (pallas_call :183)",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def abs_err(got, want):
    return float((got.double().cpu() - want.double().cpu()).abs().max())


def time_ms(fn):
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def torus_offsets(n, W):
    return sorted({(c + j) % n
                   for c in (0, W, 2 * W, n - W, n - 2 * W)
                   for j in (-2, -1, 0, 1, 2)})


def spd_case(kind, dtype, dev):
    """The CPU tests' PCG cases (tests/test_torch_band_kernels.py)."""
    rng = np.random.default_rng(11)
    n, W = 4096, 128
    offs = sorted({(c + j) % n for c in (0, W, n - W) for j in (-1, 0, 1)})
    band = np.full((len(offs), n), -1.0)
    band[offs.index(0)] = 2.0 * len(offs)
    shape, maskv, meanfree = (n,), 1.0, False
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
        b, x0 = np.where(fixed, g, b), g

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    mask = maskv if np.isscalar(maskv) else t(maskv)
    return (t(band), offs, t(b), t(x0), t(1.0 / band[offs.index(0)]), mask,
            25, meanfree)


def record_subsolves(step, state):
    """Arguments of the three circulant_pcg calls of one step."""
    calls = []
    launch = cuda_band.circulant_pcg

    def recorder(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return launch(*args)

    cuda_band.circulant_pcg = recorder
    try:
        step(*state, ALPHAS[1], ETAS[1])
    finally:
        cuda_band.circulant_pcg = launch
    if len(calls) != 3:
        raise RuntimeError(f"expected 3 sub-solves, recorded {len(calls)}")
    return dict(zip(("helmholtz", "poisson", "mass"), calls))


def bdf_steps(step, u, p, n, first=True):
    """``n`` steps from (u, u, p, 0): BDF-1 first (if ``first``), then
    BDF-2.  Returns the state tuple (u, u_old, p, phi)."""
    state = (u, u, p, torch.zeros_like(p))
    for i in range(n):
        k = 0 if (first and i == 0) else 1
        u_new, p_new, phi = step(*state, ALPHAS[k], ETAS[k])
        state = (u_new, state[0], p_new, phi)
    return state


def phase_device():
    """Refuse to run without CUDA; the card's nvidia-smi line and name."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi, kind


def phase_build():
    t0 = time.perf_counter()
    path, log = cuda_band.build_library()
    cuda_band.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Function properties" in ln or "Compiling" in ln]})


class Setup:
    """The 128^2 Taylor-Green problem shared by phases 3-5: the user-facing
    f32 engine on the card, and an f64 engine on the CPU whose operators
    are also copied to the card."""

    def __init__(self, dev):
        t0 = time.perf_counter()
        self.dev = dev
        self.space, self.u0, self.p0 = taylor_green_setup(N_POINTS)
        self.fast32 = FastTaylorHood(self.space, dtype=torch.float32,
                                     device=dev)
        self.fast64 = FastTaylorHood(self.space, dtype=torch.float64,
                                     device="cpu")
        self.ops64 = planar_ops_from_numpy(planar_ops_to_numpy(self.fast64),
                                           device=dev, dtype=torch.float64)
        emit({"phase": "setup", "seconds": time.perf_counter() - t0,
              "n_dofs": self.space.n_dofs, "n_unodes": self.space.n_unodes,
              "n_pnodes": self.space.n_pnodes,
              "offsets": {"M": len(self.fast32.M.offsets),
                          "L": len(self.fast32.L.offsets)},
              "strided_convection": self.fast32.conv_strided is not None})

    def initial(self, dtype, device):
        """The Taylor-Green state in the engines' (lex) node order."""
        f, t = self.fast64, torch.tensor
        return (f.permute_velocity(t(self.u0.T, dtype=dtype, device=device)),
                f.permute_pressure(t(self.p0, dtype=dtype, device=device)))


def step_for(ops, **kw):
    return build_planar_projection_step(ops, visc=1.0 / RE, dt=DT,
                                        cg_iters=CG_ITERS, **kw)


def phase_apply(st):
    """circulant_apply against its plain version; returns the max abs
    error at the main path's bands in f32."""
    rng = np.random.default_rng(7)
    cases = []
    for n, W, batch in ((1024, 128, 1), (16384, 256, 2), (1000, 100, 2)):
        offs = torus_offsets(n, W)
        cases.append((f"torus_n{n}_b{batch}", offs,
                      rng.standard_normal((len(offs), n)),
                      rng.standard_normal((batch, n))))
    ops = st.ops64
    helm = combine_circulant([(ALPHAS[1][0] / DT, ops.M), (1.0 / RE, ops.K)])
    for name, op, batch in (("M", ops.M, 2), ("helmholtz", helm, 2),
                            ("L", ops.L, 1)):
        cases.append((f"{name}_{N_POINTS}", op.offsets,
                      op.band.cpu().numpy(),
                      rng.standard_normal((batch, op.n))))
    bounds = {torch.float32: 1e-6, torch.float64: 1e-13}
    report, err_main = [], 0.0
    for name, offs, band_np, x_np in cases:
        for dtype, bound in bounds.items():
            band = torch.tensor(band_np, dtype=dtype, device=st.dev)
            x = torch.tensor(x_np, dtype=dtype, device=st.dev)
            y = cuda_band.circulant_apply(band, offs, x)
            y_ref = cuda_band.circulant_apply_plain(band, offs, x)
            torch.cuda.synchronize()
            err = rel_err(y, y_ref)
            if not err <= bound:
                raise AssertionError(f"circulant_apply {name} {dtype}: "
                                     f"rel err {err} > {bound}")
            if not name.startswith("torus") and dtype == torch.float32:
                err_main = max(err_main, abs_err(y, y_ref))
            report.append({"case": name, "dtype": str(dtype),
                           "rel_err": err})
    emit({"phase": "kernels", "kernel": "circulant_apply", "cases": report})
    return err_main


def phase_pcg(st):
    """circulant_pcg against its plain version on the CPU tests' cases and
    the three sub-solves of one step; returns (max abs error on x at the
    main path's sub-solves in f32, those f32 sub-solves)."""
    cases = [(k, spd_case(k, dtype, st.dev), dtype)
             for k in ("plain", "masked", "meanfree")
             for dtype in (torch.float32, torch.float64)]
    subs = {}
    for dtype, ops in ((torch.float32, st.fast32.ops),
                       (torch.float64, st.ops64)):
        u, p = st.initial(dtype, st.dev)
        subs[dtype] = record_subsolves(step_for(ops),
                                       (u, u, p, torch.zeros_like(p)))
        cases += [(f"{k}_{N_POINTS}", v, dtype)
                  for k, v in subs[dtype].items()]
    report, err_main = [], 0.0
    for name, case, dtype in cases:
        x, r = cuda_band.circulant_pcg(*case)
        x_ref, r_ref = cuda_band.circulant_pcg_plain(*case)
        torch.cuda.synchronize()
        err = rel_err(x, x_ref)
        rn = float(torch.linalg.vector_norm(r.double()))
        rn_ref = float(torch.linalg.vector_norm(r_ref.double()))
        if dtype == torch.float64:
            # a residual near roundoff has no digits to compare: floor at
            # 1e-12 |b|
            bn = float(torch.linalg.vector_norm(case[2].double()))
            ok = err <= 1e-10 and \
                abs(rn - rn_ref) <= 1e-10 * rn_ref + 1e-12 * bn
        else:
            ok = err <= 1e-4 and abs(rn - rn_ref) <= 1e-3 * rn_ref + 1e-6
        if not ok:
            raise AssertionError(f"circulant_pcg {name} {dtype}: rel err "
                                 f"{err}, |r| {rn} vs {rn_ref}")
        if name.endswith(f"_{N_POINTS}") and dtype == torch.float32:
            err_main = max(err_main, abs_err(x, x_ref))
        report.append({"case": name, "dtype": str(dtype), "rel_err": err,
                       "res": rn, "res_plain": rn_ref})
    emit({"phase": "kernels", "kernel": "circulant_pcg", "cases": report})
    return err_main, subs[torch.float32]


def phase_timing(st, subs32, smi):
    """Kernel and plain times at the main path's shapes (f32): the mass
    apply of a velocity pair, and each of the three sub-solves of one
    step.  Returns {kernel: {case: (kernel ms, plain ms)}}."""
    M = st.fast32.M
    xM = torch.tensor(np.random.default_rng(8).standard_normal((2, M.n)),
                      dtype=torch.float32, device=st.dev)
    times = {
        "circulant_apply": {"M_b2": (
            time_ms(lambda: cuda_band.circulant_apply(M.band, M.offsets,
                                                      xM)),
            time_ms(lambda: cuda_band.circulant_apply_plain(
                M.band, M.offsets, xM)))},
        "circulant_pcg": {
            name: (time_ms(lambda c=case: cuda_band.circulant_pcg(*c)),
                   time_ms(lambda c=case: cuda_band.circulant_pcg_plain(*c)))
            for name, case in subs32.items()}}
    emit({"phase": "timing", "unit": "ms (median of CUDA-event times)",
          "nvidia_smi": smi,
          "shapes": {"M_b2": f"band {len(M.offsets)}x{M.n}, x 2x{M.n}, f32",
                     "circulant_pcg": f"the sub-solves of one {N_POINTS}^2 "
                                      "step, f32"},
          "times": {k: {c: {"kernel": t[0], "plain": t[1]}
                        for c, t in v.items()} for k, v in times.items()}})
    return times


def phase_main(st, smi, profile_dir):
    """The main path; returns the launch counts of its run."""
    step = step_for(st.fast32.ops)
    u, p = st.initial(torch.float32, st.dev)
    cuda_band.reset_launch_counts()
    state = bdf_steps(step, u, p, N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        u_new, p_new, phi = step(*state, ALPHAS[1], ETAS[1])
        state = (u_new, state[0], p_new, phi)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    *_, res = step_for(st.fast32.ops, with_residuals=True)(
        *state, ALPHAS[1], ETAS[1])
    res = [float(v) for v in res.cpu()]
    launches = dict(cuda_band.LAUNCHES)
    u = state[0]
    finite = bool(torch.isfinite(u).all() and torch.isfinite(state[2]).all())
    n_total = N_WARMUP + N_STEPS
    expected = math.exp(-2.0 * (1.0 / RE) * (2.0 * math.pi) ** 2
                        * n_total * DT)
    amp_err = abs(float(u.abs().max()) - expected) / expected
    emit({"phase": "main", "config": f"taylor-green {N_POINTS}^2 f32",
          "n_dofs": st.space.n_dofs, "steps_timed": N_STEPS,
          "seconds": elapsed, "ms_per_step": 1e3 * elapsed / N_STEPS,
          "dof_steps_per_s": N_STEPS * st.space.n_dofs / elapsed,
          "amp_rel_err": amp_err, "finite": finite, "cg_residuals": res,
          "launches": launches, "nvidia_smi": smi})
    if not finite:
        raise AssertionError("main path produced non-finite values")
    if not amp_err < 0.05:
        raise AssertionError(f"amp_rel_err {amp_err} >= 0.05")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    if profile_dir:
        profile_steps(step, state, smi, profile_dir)
    return launches


def profile_steps(step, state, smi, profile_dir):
    """torch.profiler table of 10 more main-path steps."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            u_new, p_new, phi = step(*state, ALPHAS[1], ETAS[1])
            state = (u_new, state[0], p_new, phi)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(profile_dir, "profile_main.txt"), "w") as f:
        f.write(f"{smi}\n10 steps, taylor-green {N_POINTS}^2 f32\n{table}")


def phase_parity(st):
    """f64 steps on the card (kernels) against the CPU (plain versions)."""
    u, p = st.initial(torch.float64, st.dev)
    gpu = bdf_steps(step_for(st.ops64), u, p, N_PARITY)
    u, p = st.initial(torch.float64, "cpu")
    t0 = time.perf_counter()
    cpu = bdf_steps(step_for(st.fast64.ops), u, p, N_PARITY)
    errs = {"u": rel_err(gpu[0], cpu[0]), "p": rel_err(gpu[2], cpu[2])}
    emit({"phase": "parity", "steps": N_PARITY, "dtype": "float64",
          "rel_err": errs, "cpu_seconds": time.perf_counter() - t0})
    for name, err in errs.items():
        if not err <= 1e-9:
            raise AssertionError(f"f64 parity {name}: rel err {err} > 1e-9")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler table of 10 steps here")
    args = ap.parse_args()

    smi, kind = phase_device()
    phase_build()
    st = Setup(torch.device(DEVICE))
    err_apply = phase_apply(st)
    err_pcg, subs32 = phase_pcg(st)
    times = phase_timing(st, subs32, smi)
    launches = phase_main(st, smi, args.profile)
    phase_parity(st)

    src = "navierstokes_tpu_torch/csrc/band.cu"
    apply_t = times["circulant_apply"]["M_b2"]
    pcg_t = [sum(t[i] for t in times["circulant_pcg"].values())
             for i in (0, 1)]
    print(json.dumps({"kernels": [
        {"name": "circulant_apply", "route": "cuda", "source": src,
         "replaces": REPLACES["circulant_apply"],
         "launches": launches["circulant_apply"],
         "max_abs_err": err_apply, "ms": apply_t[0],
         "plain_ms": apply_t[1]},
        {"name": "circulant_pcg", "route": "cuda", "source": src,
         "replaces": REPLACES["circulant_pcg"],
         "launches": launches["circulant_pcg"],
         "max_abs_err": err_pcg, "ms": pcg_t[0],
         "plain_ms": pcg_t[1]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
