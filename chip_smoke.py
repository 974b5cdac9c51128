"""Drive the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py [--profile DIR] [--baseline DIR] [--phases LIST]

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. device   -- refuse to run without CUDA; print the card's name and power
               limit as nvidia-smi reports them.
2. build    -- compile the band kernels (navierstokes_tpu_torch/csrc/band.cu)
               with nvcc and load them.
3. kernels  -- hold each kernel against its plain torch version on the
               card (f32 and f64): the apply on its cases, the PCG on both
               routes (cluster, and grid with a resident and a streamed
               band; masked and mean-free cases on each), with each case's
               route.
4. main     -- the generic banded SBDF-2 projection step on the periodic
               Taylor-Green vortex at 128^2, f32, configured as bench.py's
               generic path: Re = 100, dt = 1e-3, cg_iters = (10, 60, 6),
               one BDF-1 step and 3 BDF-2 warm-up steps, then 200 timed
               BDF-2 steps.  Requires finite values, amp_rel_err < 0.05 and
               launches of both kernels; prints DoF-steps/s, the residual
               triple of one extra step and the launch counts.
5. timing   -- at the main path's f32 shapes, for the apply and each PCG
               sub-solve: the device-only time (torch.profiler kernel time
               over 20 launches), the event-timed wrapper call (median of
               30 CUDA-event timings after warm-up), the plain version,
               the bound (bytes or operations at the card's peaks), the
               launches per step and, for the apply, one torch.sparse.mm of
               the same matrix as CSR.
6. parity   -- 10 steps at 128^2, f64, on the card (kernels) and on the CPU
               (plain versions) from the same state; u and p must agree to
               1e-9 relative.
7. structured2d -- the structured spectral projection step (bench.py's
               primary path, one eager launch sequence per step) on the
               Taylor-Green vortex at 128^2, f32, Re = 100, dt = 1e-3: one
               BDF-1 and 3 BDF-2 warm-up steps, then 200 timed BDF-2
               steps.  Requires finite values and amp_rel_err < 0.05;
               prints DoF-steps/s, the host setup seconds and the peak
               device memory.
8. structured3d -- the same step on the triply periodic shear wave at
               48^3 (2.76 M DoFs), f32: 4 warm-up and 50 timed steps.
9. structured_timing -- at both shapes, CUDA-event medians of one
               convection call, fwd_u / inv_u (MatmulDFT) beside
               torch.fft.fftn / ifftn over the same axes of the same class
               grids, one _cmatmul in each lowering (vpu, einsum) and one
               helmholtz_solve; and the device-busy share of 10 steps
               (torch.profiler kernel time over wall time) with the top
               kernels by device time.
10. structured_parity -- 10 spectral steps at f64 on the card and on the
               CPU from the same state, at 128^2 and 16^3; u and p must
               agree to 1e-9 relative.
11. solver_cavity -- the product solver API at full width: the lid-driven
               cavity at 128^2 (148,739 DoFs, no-slip walls, unit lid,
               zero-mean pressure), Re = 1000, dt = 0.25 / 256, f32,
               through ``ProjectionSolver`` + ``BDFTimeStepping`` and the
               manual loop, with the solver's defaults (AMG Poisson
               preconditioner, cg_iters (40, 40, 20)) and cg_rtol = 1e-6
               (the default 1e-8 is below f32 roundoff): 4 warm-up and 200
               timed steps.  Requires step_kind "fast", finite state and
               residuals, lid nodes at 1 and wall nodes at 0 to 1e-6;
               prints every operator's format, ms/step, DoF-steps/s,
               launches and host syncs per step, the device-busy share,
               the last residual triple, ||div u||, the centre-line
               minimum of u_x and the setup seconds by stage.
12. solver_cavity_kernels -- the same cavity with cg_rtol = None,
               poisson_precond = None, cg_iters = (18, 300, 10): all three
               solves of a step are one circulant_pcg launch each, the
               velocity solves masked (B = 2, N = 66,049, K = 19), the
               Poisson solve mean-free (N = 16,641, K = 7).  50 timed
               steps; one step's three solves are held against their plain
               versions (rel. error < 1e-5, |d||r||| <= 1e-4 ||r|| + 1e-6)
               and timed, with each solve's route.
13. solver_periodic -- Taylor-Green 128^2 through the solver API, default
               (step_kind "spectral") and with prefer_spectral=False
               ("fast": stencil couplings, strided convection), 100 steps
               each, amp_rel_err < 0.05, ms/step beside the raw-step
               figures of phases main and structured2d.
14. solver_parity -- f64, card against CPU, 10 steps: cavity 32^2 with the
               defaults (AffineBand couplings) and again with
               NS_FASTOP_RIM_BYTES forcing GatherOp couplings, and the
               channel 20x4 with a time-dependent inflow; u and p must
               agree to 1e-9 relative; a second card run must repeat the
               first (no atomics on the path).  Then a checkpoint round
               trip on the card: save after 3 variable steps, load into a
               fresh solver, 3 more steps equal the unbroken run bit for
               bit.
15. the ``kernels`` line, then the card's nvidia-smi line, then the last
   line ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes a torch.profiler table of 10 steps of each
path (banded, structured 2D, structured 3D, solver cavity) to DIR.
``--phases LIST`` runs only the named groups (``kernels``, ``structured``,
``solver``; the device and build phases always run) and then prints no
``kernels`` line.  ``--baseline DIR``
also times the kernels of another checkout of this repository (its ``navierstokes_tpu_torch``, built from its own
source) on the same inputs in the same process, in the order baseline,
this, this, baseline.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import (FastTaylorHood,
                                                    combine_circulant,
                                                    planar_ops_from_numpy,
                                                    planar_ops_to_numpy)
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.spaces import axis_periodic
from navierstokes_tpu_torch.io import load_checkpoint, save_checkpoint
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.setups import (channel_setup,
                                           lid_driven_cavity_setup,
                                           parabolic_inlet,
                                           taylor_green_setup)
from navierstokes_tpu_torch.solvers import ProjectionSolver
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               StructuredConvection,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.structured.spectral import _cmatmul
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

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
PROFILE_LAUNCHES = 20
# the structured spectral path: bench.py's sizes (NS_BENCH_DIM=2 / 3), the
# decay-rate factor of the analytic solution, and the parity grid sizes
STRUCTURED = {
    "structured2d": {"dim": 2, "n": 128, "steps": 200, "rate": 2.0,
                     "n_parity": 128},
    "structured3d": {"dim": 3, "n": 48, "steps": 50, "rate": 1.0,
                     "n_parity": 16},
}
N_BUSY = 10
# the solver-API phases: the cavity of benchmarks/cavity_re1000.py (its
# Re, step size and fixed-iteration counts) and the parity grids
SOLVER = {"n": 128, "re": 1000.0, "steps": 200, "cg_rtol": 1e-6,
          "kernel_steps": 50, "kernel_cg_iters": (18, 300, 10),
          "periodic_steps": 100, "n_parity": 32, "channel": (20, 4)}
DEVICE = "cuda:0"
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the peak rates outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
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


def device_ms(fn):
    """Device-only time of ``fn`` in ms: the band kernels' time in a
    torch.profiler trace of PROFILE_LAUNCHES calls, over the number of
    kernel records in the trace (one per call; a long process can lose
    records, so the trace's own count is the divisor, and a trace with
    fewer than half of the launches is refused)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    total, records = 0.0, 0
    for e in prof.key_averages():
        if "circulant_" in e.key:
            total += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            records += e.count
    if total <= 0.0 or 2 * records < PROFILE_LAUNCHES:
        raise RuntimeError(f"torch.profiler recorded {records} of "
                           f"{PROFILE_LAUNCHES} kernel launches")
    return total / records / 1e3


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by): the least time for the work at the card's
    peak memory rate and peak rate for ``dtype``."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def apply_work(K, n, batch, esize):
    """Bytes (band, x and y once each) and FLOPs of one band apply."""
    return (K * n + 2 * batch * n) * esize, 2 * K * n * batch


def pcg_work(case):
    """Bytes (each input read once, x and r written once) and FLOPs of one
    whole solve with these arguments, counted per row as _pcg does the
    work: each iteration a matvec (2K; masked 5 more: m*v before, and
    m*w + (1-m)*v after), two dot products and the x, r, z and p updates
    (11; masked 1 more, mean-free 2 more); the setup counts as one more
    iteration."""
    band, _, b, x0, invd, maskv, iters, meanfree = case
    K, n = band.shape
    rows = b.numel()
    masked = torch.is_tensor(maskv)
    esize = b.element_size()
    nbytes = band.numel() + 4 * rows + invd.numel() + \
        (maskv.numel() if masked else 0)
    matvec = 2 * K + (5 if masked else 0)
    per_iter = matvec + 11 + (1 if masked else 0) + (2 if meanfree else 0)
    flops = rows * ((iters + 1) * per_iter)
    return nbytes * esize, flops


def spd_case(kind, dtype, dev, n=4096, W=128):
    """The CPU tests' PCG cases (tests/test_torch_band_kernels.py) at
    n = 4096; at a larger ``n`` the same construction routes to the grid
    kernel."""
    rng = np.random.default_rng(11)
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


def streamed_case(dtype, dev, n=1 << 20, W=1024, batch=2, iters=10):
    """A random SPD band whose slice does not fit in shared memory (the
    512^2 velocity shape: K = 23, N = 1,048,576, 2 planes): a constant
    random value on each offset pair (so symmetric) and a random diagonal
    that dominates its row."""
    rng = np.random.default_rng(12)
    half = (1, 2, 3, 4, 5, W - 1, W, W + 1, 2 * W - 1, 2 * W, 2 * W + 1)
    offs = sorted({0} | {h % n for h in half} | {-h % n for h in half})
    band = np.empty((len(offs), n))
    vals = {h: -0.5 - rng.random() for h in half}
    for k, o in enumerate(offs):
        if o:
            band[k] = vals[o if o in vals else n - o]
    d = offs.index(0)
    band[d] = np.abs(np.delete(band, d, axis=0)).sum(0) + 1.0 + rng.random(n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (t(band), offs, t(rng.standard_normal((batch, n))),
            t(np.zeros((batch, n))), t(1.0 / band[d]), 1.0, iters, False)


def record_subsolves(run):
    """Arguments of the three circulant_pcg calls of one step, which
    ``run()`` takes."""
    calls = []
    launch = cuda_band.circulant_pcg

    def recorder(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return launch(*args)

    cuda_band.circulant_pcg = recorder
    try:
        run()
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


def pcg_route(case):
    band, _, b, *_ = case
    n = band.shape[1]
    plan = cuda_band.pcg_plan(n, band.shape[0], b.numel() // n, b.dtype,
                              torch.is_tensor(case[5]))
    if plan.route == "grid" and not plan.resident:
        return "grid-streamed"
    return plan.route


def check_subsolve_routes(subs):
    """The 128^2 velocity solves take the grid kernel with a resident
    band, the Poisson solve the cluster kernel."""
    routes = {k: pcg_route(v) for k, v in subs.items()}
    if routes != {"helmholtz": "grid", "poisson": "cluster", "mass": "grid"}:
        raise AssertionError(f"sub-solve routes {routes}")


def phase_pcg(st):
    """circulant_pcg against its plain version on both routes: the CPU
    tests' cases, the same construction at n = 65,536 (grid route), a
    streamed band, and the three sub-solves of one step in f32 and f64.
    Returns (max abs error on x at the main path's sub-solves in f32,
    those f32 sub-solves)."""
    cases = [(f"{k}_n{n}", spd_case(k, dtype, st.dev, n=n, W=W), dtype)
             for n, W in ((4096, 128), (65536, 256))
             for k in ("plain", "masked", "meanfree")
             for dtype in (torch.float32, torch.float64)]
    cases.append(("streamed_n1048576", streamed_case(torch.float32, st.dev),
                  torch.float32))
    subs = {}
    for dtype, ops in ((torch.float32, st.fast32.ops),
                       (torch.float64, st.ops64)):
        u, p = st.initial(dtype, st.dev)
        step = step_for(ops)
        subs[dtype] = record_subsolves(
            lambda: step(u, u, p, torch.zeros_like(p), ALPHAS[1], ETAS[1]))
        cases += [(f"{k}_{N_POINTS}", v, dtype)
                  for k, v in subs[dtype].items()]
    report, err_main, seen = [], 0.0, set()
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
        route = pcg_route(case)
        if not ok:
            raise AssertionError(f"circulant_pcg {name} {dtype} ({route}): "
                                 f"rel err {err}, |r| {rn} vs {rn_ref}")
        if name.endswith(f"_{N_POINTS}") and dtype == torch.float32:
            err_main = max(err_main, abs_err(x, x_ref))
        masked, meanfree = torch.is_tensor(case[5]), bool(case[7])
        seen |= {(route, str(dtype)), (route, "masked" if masked else
                                       "meanfree" if meanfree else "plain")}
        report.append({"case": name, "dtype": str(dtype), "route": route,
                       "rel_err": err, "res": rn, "res_plain": rn_ref})
    need = {("cluster", "torch.float32"), ("cluster", "torch.float64"),
            ("grid", "torch.float32"), ("grid", "torch.float64"),
            ("grid-streamed", "torch.float32"), ("cluster", "masked"),
            ("cluster", "meanfree"), ("grid", "masked"), ("grid", "meanfree")}
    if need - seen:
        raise AssertionError(f"routes not exercised: {sorted(need - seen)}")
    for dtype in (torch.float32, torch.float64):
        check_subsolve_routes(subs[dtype])
    emit({"phase": "kernels", "kernel": "circulant_pcg", "cases": report})
    return err_main, subs[torch.float32]


def csr_of(op):
    """The CirculantBand ``op`` as a CSR matrix (for torch.sparse.mm)."""
    n, rows = op.n, torch.arange(op.n, device=op.band.device)
    cols = torch.cat([(rows + o) % n for o in op.offsets])
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.repeat(len(op.offsets)), cols]),
        op.band.reshape(-1), (n, n))
    return coo.coalesce().to_sparse_csr()


def phase_timing(st, subs32, smi, launches_per_step):
    """Times at the main path's shapes (f32): the mass apply of a velocity
    pair, and each of the three sub-solves of one step.  Returns
    {kernel: {case: {...}}} with ms (event-timed wrapper call), device_ms,
    plain_ms, bound_ms, bound_by and library_ms."""
    M = st.fast32.M
    xM = torch.tensor(np.random.default_rng(8).standard_normal((2, M.n)),
                      dtype=torch.float32, device=st.dev)
    A, xT = csr_of(M), xM.t().contiguous()
    y = cuda_band.circulant_apply(M.band, M.offsets, xM)
    lib_err = rel_err(torch.sparse.mm(A, xT).t(), y)
    if not lib_err <= 1e-6:
        raise AssertionError(f"torch.sparse.mm disagrees: {lib_err}")
    b_ms, b_by = bound(*apply_work(len(M.offsets), M.n, 2, 4), torch.float32)
    times = {"circulant_apply": {"M_b2": {
        "ms": time_ms(lambda: cuda_band.circulant_apply(M.band, M.offsets,
                                                        xM)),
        "device_ms": device_ms(lambda: cuda_band.circulant_apply(
            M.band, M.offsets, xM)),
        "plain_ms": time_ms(lambda: cuda_band.circulant_apply_plain(
            M.band, M.offsets, xM)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.sparse.mm(A, xT)),
        "launches_per_step": launches_per_step["circulant_apply"]}},
        "circulant_pcg": {}}
    for name, case in subs32.items():
        b_ms, b_by = bound(*pcg_work(case), torch.float32)
        times["circulant_pcg"][name] = {
            "route": pcg_route(case), "iters": case[6],
            "ms": time_ms(lambda c=case: cuda_band.circulant_pcg(*c)),
            "device_ms": device_ms(lambda c=case: cuda_band.circulant_pcg(*c)),
            "plain_ms": time_ms(lambda c=case: cuda_band.circulant_pcg_plain(
                *c)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_step": 1}
    # the three solves of a step as one piece of work
    work = [pcg_work(c) for c in subs32.values()]
    b_ms, b_by = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                       torch.float32)
    per = times["circulant_pcg"].values()
    times["circulant_pcg_step"] = {
        key: sum(t[key] for t in per)
        for key in ("ms", "device_ms", "plain_ms")}
    times["circulant_pcg_step"].update(
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        launches_per_step=launches_per_step["circulant_pcg"])
    emit({"phase": "timing", "unit": "ms", "nvidia_smi": smi,
          "ms": "median of CUDA-event times of one wrapper call",
          "device_ms": "torch.profiler kernel time per launch",
          "shapes": {"M_b2": f"band {len(M.offsets)}x{M.n}, x 2x{M.n}, f32",
                     "circulant_pcg": f"the sub-solves of one {N_POINTS}^2 "
                                      "step, f32"},
          "library": "torch.sparse.mm(CSR of M, x^T)",
          "times": times})
    return times


def phase_baseline(st, subs32, smi, baseline_dir):
    """The kernels of another checkout against this one on the same
    inputs, in the order baseline, this, this, baseline."""
    import importlib.util

    path = os.path.join(baseline_dir, "navierstokes_tpu_torch", "assembly",
                        "cuda_band.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_band", path)
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    base.load_library()
    M = st.fast32.M
    xM = torch.tensor(np.random.default_rng(8).standard_normal((2, M.n)),
                      dtype=torch.float32, device=st.dev)
    calls = {"circulant_apply/M_b2": lambda mod: (
        lambda: mod.circulant_apply(M.band, M.offsets, xM))}
    for name, case in subs32.items():
        calls[f"circulant_pcg/{name}"] = lambda mod, c=case: (
            lambda: mod.circulant_pcg(*c))
    out = {}
    for name, make in calls.items():
        rows = {"baseline": [], "this": []}
        for who in ("baseline", "this", "this", "baseline"):
            fn = make(base if who == "baseline" else cuda_band)
            rows[who].append({"ms": time_ms(fn), "device_ms": device_ms(fn)})
        out[name] = rows
    emit({"phase": "baseline", "dir": baseline_dir, "nvidia_smi": smi,
          "unit": "ms", "times": out})


def phase_main(st, smi, profile_dir):
    """The main path; returns the launch counts of its run and its ms per
    step."""
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
        box = [state]

        def advance():
            u_new, p_new, phi = step(*box[0], ALPHAS[1], ETAS[1])
            box[0] = (u_new, box[0][0], p_new, phi)

        write_profile(advance, smi, profile_dir, "profile_main.txt",
                      f"taylor-green {N_POINTS}^2 f32, banded step")
    return launches, 1e3 * elapsed / N_STEPS


def write_profile(advance, smi, profile_dir, filename, title):
    """torch.profiler table of N_BUSY calls of ``advance`` (one step each)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_BUSY):
            advance()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(profile_dir, filename), "w") as f:
        f.write(f"{smi}\n{N_BUSY} steps, {title}\n{table}")


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


def spectral_steps(step, state, n):
    """``n`` spectral steps: BDF-1 first, then BDF-2."""
    for i in range(n):
        state = step(state, ALPHAS[min(i, 1)], ETAS[min(i, 1)])
    return state


def vortex3d(space):
    """A smooth divergence-free 3D velocity with non-zero convection and
    pressure (the shear wave has neither), flat, for the parity phase."""
    g = 2.0 * math.pi
    return space.interpolate_velocity(lambda x: np.stack(
        [np.sin(g * x[:, 1]) * np.cos(g * x[:, 2]),
         np.sin(g * x[:, 2]) * np.cos(g * x[:, 0]),
         np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])], axis=1)).reshape(-1)


class StructuredSetup:
    """One structured configuration: the host setup (timed, NumPy f64) and
    the user-facing f32 spectral step on the card."""

    def __init__(self, name, dev):
        self.name, self.dev = name, dev
        self.cfg = cfg = STRUCTURED[name]
        t0 = time.perf_counter()
        self.space, self.u0, self.p0 = taylor_green_setup(cfg["n"],
                                                          dim=cfg["dim"])
        t1 = time.perf_counter()
        self.sgrid = PeriodicStructuredTH(self.space)
        t2 = time.perf_counter()
        self.step, self.init_state, self.read_state = \
            build_spectral_projection_step(self.sgrid, visc=1.0 / RE, dt=DT,
                                           dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.setup_seconds = {"mesh_and_space": t1 - t0,
                              "class_grids": t2 - t1,
                              "symbols_and_eigenbasis": t3 - t2,
                              "total": t3 - t0}
        self.config = (f"{'taylor-green' if cfg['dim'] == 2 else 'shear-wave'}"
                       f" {cfg['n']}^{cfg['dim']} f32, spectral step")
        self.state = None

    def advance(self):
        self.state = self.step(self.state, ALPHAS[1], ETAS[1])


def phase_structured(ss, smi, profile_dir):
    """bench.py's structured path in its per-step dispatch form; returns
    its ms per step."""
    cfg = ss.cfg
    torch.cuda.reset_peak_memory_stats()
    flat = ss.u0.reshape(-1)
    ss.state = spectral_steps(ss.step, ss.init_state(flat, flat, ss.p0),
                              N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cfg["steps"]):
        ss.advance()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    u_flat, p_flat = ss.read_state(ss.state)
    space = ss.space
    if u_flat.shape != (space.n_velocity_dofs,) or \
            p_flat.shape != (space.n_pnodes,):
        raise AssertionError(f"{ss.name}: read_state shapes {u_flat.shape}, "
                             f"{p_flat.shape}")
    finite = bool(np.isfinite(u_flat).all() and np.isfinite(p_flat).all())
    n_total = N_WARMUP + cfg["steps"]
    expected = math.exp(-cfg["rate"] * (1.0 / RE) * (2.0 * math.pi) ** 2
                        * n_total * DT)
    amp_err = abs(float(np.abs(u_flat).max()) - expected) / expected
    emit({"phase": ss.name, "config": ss.config, "n_dofs": space.n_dofs,
          "grid": list(ss.sgrid.shape), "steps_timed": cfg["steps"],
          "seconds": elapsed, "ms_per_step": 1e3 * elapsed / cfg["steps"],
          "dof_steps_per_s": cfg["steps"] * space.n_dofs / elapsed,
          "amp_rel_err": amp_err, "finite": finite,
          "setup_seconds": ss.setup_seconds,
          "peak_device_bytes": peak, "nvidia_smi": smi})
    if not finite:
        raise AssertionError(f"{ss.name} produced non-finite values")
    if not amp_err < 0.05:
        raise AssertionError(f"{ss.name}: amp_rel_err {amp_err} >= 0.05")
    if profile_dir:
        write_profile(ss.advance, smi, profile_dir,
                      f"profile_{ss.name}.txt", ss.config)
    return 1e3 * elapsed / cfg["steps"]


def busy_share(ss):
    """Device-busy share of N_BUSY steps: torch.profiler kernel time over
    the host-clock time of the same window, with the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    ss.advance()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_BUSY):
            ss.advance()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
        if t > 0.0:
            rows.append((t, e.count, e.key))
    device = sum(r[0] for r in rows)
    if device <= 0.0:
        raise RuntimeError("torch.profiler recorded no kernel time")
    rows.sort(reverse=True)
    return {"steps": N_BUSY, "wall_ms_per_step": 1e3 * wall / N_BUSY,
            "device_ms_per_step": device / N_BUSY / 1e3,
            "busy_share": device / 1e6 / wall,
            "launches_per_step": sum(r[1] for r in rows) / N_BUSY,
            "top_kernels": [{"kernel": key[:72],
                             "ms_per_step": t / N_BUSY / 1e3,
                             "calls_per_step": count / N_BUSY}
                            for t, count, key in rows[:8]]}


def step_ms_per_lowering(ss, n_steps):
    """Host-clock ms per step with NS_TPU_BLOCK_APPLY forced to each
    _cmatmul lowering, in the order vpu, einsum, einsum, vpu."""
    out = {"vpu": [], "einsum": []}
    saved = os.environ.get("NS_TPU_BLOCK_APPLY")
    try:
        for mode in ("vpu", "einsum", "einsum", "vpu"):
            os.environ["NS_TPU_BLOCK_APPLY"] = mode
            ss.advance()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                ss.advance()
            torch.cuda.synchronize()
            out[mode].append(1e3 * (time.perf_counter() - t0) / n_steps)
    finally:
        if saved is None:
            os.environ.pop("NS_TPU_BLOCK_APPLY", None)
        else:
            os.environ["NS_TPU_BLOCK_APPLY"] = saved
    return out


def phase_structured_timing(setups, smi):
    """Per-call times of the structured step's parts at both shapes, the
    library FFT beside MatmulDFT, both _cmatmul lowerings, and the
    device-busy share of the step."""
    report = {}
    for ss in setups:
        ops, dim = ss.step.ops, ss.cfg["dim"]
        conv = StructuredConvection(ss.sgrid, dtype=torch.float32,
                                    device=ss.dev)
        U, Uh = ss.state[0], ss.state[2]
        axes = tuple(range(1, 1 + dim))
        mine, Z = ops.dft.fwd(U), torch.fft.fftn(U, dim=axes)
        fft_err = float((torch.complex(mine.re, mine.im) - Z).abs().max()
                        / Z.abs().max())
        if not fft_err <= 1e-4:
            raise AssertionError(f"{ss.name}: MatmulDFT vs torch.fft.fftn "
                                 f"rel err {fft_err} > 1e-4")
        back = ops.dft.inv_real(mine)
        ifft_err = max(rel_err(back, torch.fft.ifftn(Z, dim=axes).real),
                       rel_err(back, U))
        if not ifft_err <= 1e-4:
            raise AssertionError(f"{ss.name}: inverse DFT rel err "
                                 f"{ifft_err} > 1e-4")
        lowered = {m: _cmatmul(ops.Mhat, Uh, mode=m)
                   for m in ("vpu", "einsum")}
        low_err = max(rel_err(lowered["vpu"].re, lowered["einsum"].re),
                      rel_err(lowered["vpu"].im, lowered["einsum"].im))
        if not low_err <= 1e-5:
            raise AssertionError(f"{ss.name}: _cmatmul lowerings differ by "
                                 f"{low_err} > 1e-5")
        a0k = ALPHAS[1][0] / DT
        report[ss.name] = {
            "config": ss.config,
            "ms": {
                "convection": time_ms(lambda: conv(U)),
                "fwd_u_matmul_dft": time_ms(lambda: ops.fwd_u(U)),
                "inv_u_matmul_dft": time_ms(lambda: ops.inv_u(Uh)),
                "torch_fft_fftn": time_ms(
                    lambda: torch.fft.fftn(U, dim=axes)),
                "torch_fft_ifftn_real": time_ms(
                    lambda: torch.fft.ifftn(Z, dim=axes).real),
                "cmatmul_vpu": time_ms(
                    lambda: _cmatmul(ops.Mhat, Uh, mode="vpu")),
                "cmatmul_einsum": time_ms(
                    lambda: _cmatmul(ops.Mhat, Uh, mode="einsum")),
                "helmholtz_solve": time_ms(
                    lambda: ops.helmholtz_solve(a0k, 1.0 / RE, Uh))},
            "rel_err": {"matmul_dft_vs_fftn": fft_err,
                        "inverse_dft": ifft_err,
                        "cmatmul_vpu_vs_einsum": low_err},
            "step_ms_by_block_apply": step_ms_per_lowering(
                ss, max(N_BUSY, ss.cfg["steps"] // 4)),
            "busy": busy_share(ss)}
    emit({"phase": "structured_timing", "unit": "ms", "nvidia_smi": smi,
          "ms": "median of CUDA-event times of one call",
          "library": "torch.fft.fftn / ifftn over the grid axes of the "
                     "(2^dim, *grid, d) class grids",
          "shapes": report})
    return report


def phase_structured_parity(setups):
    """f64 spectral steps on the card against the CPU from the same
    state."""
    for ss in setups:
        cfg = ss.cfg
        n, dim = cfg["n_parity"], cfg["dim"]
        if n == cfg["n"]:
            space, sgrid, u0, p0 = ss.space, ss.sgrid, ss.u0, ss.p0
        else:
            space, u0, p0 = taylor_green_setup(n, dim=dim)
            sgrid = PeriodicStructuredTH(space)
        flat = vortex3d(space) if dim == 3 else u0.reshape(-1)
        out, seconds = {}, {}
        for where in (ss.dev, "cpu"):
            t0 = time.perf_counter()
            step, init_state, read_state = build_spectral_projection_step(
                sgrid, visc=1.0 / RE, dt=DT, dtype=torch.float64,
                device=where)
            state = spectral_steps(step, init_state(flat, flat, p0),
                                   N_PARITY)
            out[where] = [torch.from_numpy(a) for a in read_state(state)]
            seconds[str(where)] = time.perf_counter() - t0
        errs = {"u": rel_err(out[ss.dev][0], out["cpu"][0]),
                "p": rel_err(out[ss.dev][1], out["cpu"][1])}
        emit({"phase": "structured_parity", "config": f"{n}^{dim}",
              "steps": N_PARITY, "dtype": "float64", "rel_err": errs,
              "seconds": seconds})
        for name, err in errs.items():
            if not err <= 1e-9:
                raise AssertionError(f"structured f64 parity {n}^{dim} "
                                     f"{name}: rel err {err} > 1e-9")


# ---------------------------------------------------------------------------
# the product solver API
# ---------------------------------------------------------------------------

def pulsed_inlet(x, t=0.0):
    t = 0.0 if t is None else t
    return math.sin(math.pi * t) * parabolic_inlet(x)


def make_solver(problem, n, device, dtype, **kw):
    """``(solver, ts)`` for ``problem`` through the documented hooks: the
    lid-driven ``cavity`` at Re = SOLVER["re"] with n^2 cells, the
    ``channel`` of n = (nx, ny) cells with a pulsed parabolic inflow, or
    the ``periodic`` Taylor-Green vortex at Re = RE with n^2 cells."""
    if problem == "cavity":
        mesh, markers, bcs = lid_driven_cavity_setup(n)
        dt, visc, ic = 0.25 / (2.0 * n), 1.0 / SOLVER["re"], \
            {"velocity": (0.0, 0.0)}
    elif problem == "channel":
        mesh, markers, bcs = channel_setup(*n, inlet=pulsed_inlet)
        dt, visc, ic = 0.02, 0.1, {"velocity": (0.0, 0.0)}
    else:
        g = 2.0 * math.pi
        mesh, markers = hyper_cube(2, n)
        bcs = ((PressureBCType.mean_value, None, 0.0),)
        dt, visc = DT, 1.0 / RE
        ic = {"velocity": lambda x: np.stack(
                  [np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                   -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])], axis=1),
              "pressure": lambda x: -0.25 * (np.cos(2 * g * x[:, 0])
                                             + np.cos(2 * g * x[:, 1]))}
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=dt)
    solver = ProjectionSolver(mesh, markers, "standard", ts, device=device,
                              dtype=dtype, **kw)
    if problem == "periodic":
        solver.set_periodic_boundary_conditions(
            [axis_periodic(0), axis_periodic(1)],
            constrained_boundary_ids=(1, 2, 3, 4))
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": visc,
         "pressure_term": 1.0})
    solver.set_initial_conditions(ic)
    return solver, ts


def advance(solver, ts, n=1, dts=None):
    """``n`` steps of the manual loop (variable sizes ``dts`` if given)."""
    for i in range(n):
        if dts is not None:
            ts.set_desired_next_step_size(dts[i])
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()


def describe_op(op):
    """Format, size and bytes of one engine operator."""
    name = type(op).__name__
    if name == "CirculantBand":
        return {"format": name, "K": len(op.offsets), "n": op.n,
                "bytes": op.nbytes}
    if name == "AffineBand":
        return {"format": name, "W": op.W, "blocks": op.nblk,
                "bytes": op.nbytes}
    if name == "GatherOp":
        return {"format": name, "nnz": int(op.vals.numel()),
                "bytes": op.nbytes}
    return {"format": name, "taps": len(op.offs)}


def engine_formats(fast):
    out = {k: describe_op(getattr(fast, k)) for k in ("M", "K", "L", "Mp")}
    out["G"] = [describe_op(op) for op in fast.G]
    out["D"] = [describe_op(op) for op in fast.D]
    out["conv_strided"] = fast.conv_strided is not None
    return out


def setup_seconds(solver):
    return {r["label"]: r["seconds"] for r in solver.monitor.records
            if r["kind"] == "timing"}


def timed_steps(solver, ts, n_steps):
    """N_WARMUP steps, then ``n_steps`` on the host clock between two
    synchronisations, with the launch counts of all of them."""
    cuda_band.reset_launch_counts()
    advance(solver, ts, N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(solver, ts, n_steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return elapsed, dict(cuda_band.LAUNCHES)


def solver_busy(solver, ts, ms_per_step):
    """Kernel launches, host synchronisations and device time per step over
    N_BUSY profiled steps (torch.profiler, CPU and CUDA activities); the
    busy share is the device time over ``ms_per_step`` of the unprofiled
    run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        advance(solver, ts, N_BUSY)
        torch.cuda.synchronize()
    device, launches, counts = 0.0, 0, {}
    for e in prof.key_averages():
        # kernel and memcpy rows only: an operator's row repeats the time
        # of the kernels it launched
        if e.device_type == DeviceType.CUDA:
            device += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            launches += e.count
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                     "cudaLaunchKernel", "aten::copy_"):
            counts[e.key] = e.count / N_BUSY
    if device <= 0.0:
        raise RuntimeError("torch.profiler recorded no kernel time")
    device_ms = device / N_BUSY / 1e3
    return {"steps": N_BUSY, "device_ms_per_step": device_ms,
            "busy_share": device_ms / ms_per_step,
            "device_ops_per_step": launches / N_BUSY,
            # one aten::_local_scalar_dense is one float()/item() read of
            # a device scalar: a host synchronisation
            "host_syncs_per_step": counts.get("aten::_local_scalar_dense",
                                              0.0),
            "per_step": counts}


def residual_records(solver):
    """(n_steps, 3) recorded residual triples (reads them off the card)."""
    return np.array([r["residuals"].double().cpu().numpy()
                     for r in solver.monitor.records
                     if r["kind"] == "linear_solve"])


def cavity_guards(solver, name):
    """Finite state, lid nodes at 1 and wall nodes at 0 to 1e-6; returns
    ||div u|| and the centre-line minimum of u_x with its height."""
    space = solver.space
    x = solver.solution
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: non-finite state")
    u, _ = space.split(x)
    div_l2 = solver.operator.divergence_l2(u)
    u = u.double().cpu().numpy()
    c = space.u_coords
    lid = np.abs(c[:, 1] - 1.0) < 1e-12
    inner_lid = lid & (c[:, 0] > 1e-12) & (c[:, 0] < 1 - 1e-12)
    walls = (np.abs(c[:, 1]) < 1e-12) | (np.abs(c[:, 0]) < 1e-12) \
        | (np.abs(c[:, 0] - 1.0) < 1e-12)
    lid_err = float(np.abs(u[inner_lid, 0] - 1.0).max())
    wall_err = float(np.abs(u[walls & ~lid]).max())
    if not (lid_err <= 1e-6 and wall_err <= 1e-6):
        raise AssertionError(f"{name}: lid error {lid_err}, wall error "
                             f"{wall_err} > 1e-6")
    on_cl = np.abs(c[:, 0] - 0.5) < 1e-9
    i = int(np.argmin(u[on_cl, 0]))
    return {"lid_err": lid_err, "wall_err": wall_err, "div_l2": div_l2,
            "centerline_u_min": float(u[on_cl, 0][i]),
            "centerline_u_min_y": float(c[on_cl, 1][i])}


def phase_solver_cavity(dev, smi, profile_dir):
    """The solver API's path at full width; returns (ms per step, launches)."""
    n, n_steps = SOLVER["n"], SOLVER["steps"]
    t0 = time.perf_counter()
    solver, ts = make_solver("cavity", n, dev, torch.float32,
                             cg_rtol=SOLVER["cg_rtol"])
    t_ic = time.perf_counter() - t0
    elapsed, launches = timed_steps(solver, ts, n_steps)
    ms = 1e3 * elapsed / n_steps
    if solver._step_kind != "fast":
        raise AssertionError(f"solver_cavity: step_kind "
                             f"{solver._step_kind!r}, expected 'fast'")
    res = residual_records(solver)
    if res.shape != (N_WARMUP + n_steps, 3) or not np.isfinite(res).all():
        raise AssertionError("solver_cavity: residual records missing or "
                             "non-finite")
    guards = cavity_guards(solver, "solver_cavity")
    busy = solver_busy(solver, ts, ms)
    space = solver.space
    emit({"phase": "solver_cavity",
          "config": f"lid-driven cavity {n}^2 f32, Re {SOLVER['re']:g}, "
                    f"dt {0.25 / (2.0 * n):g}, amg, cg_iters (40, 40, 20), "
                    f"cg_rtol {SOLVER['cg_rtol']:g} (1e-8 is below f32 "
                    "roundoff)",
          "step_kind": solver._step_kind, "n_dofs": space.n_dofs,
          "operators": engine_formats(solver._fast),
          "steps_timed": n_steps, "seconds": elapsed, "ms_per_step": ms,
          "dof_steps_per_s": n_steps * space.n_dofs / elapsed,
          "launches_per_step": {k: v / (N_WARMUP + n_steps)
                                for k, v in launches.items()},
          "busy": busy, "residuals_last": res[-1].tolist(),
          "residuals_max": res.max(axis=0).tolist(), "guards": guards,
          "setup_seconds": dict(setup_seconds(solver),
                                through_initial_conditions=t_ic),
          "nvidia_smi": smi})
    if launches["circulant_apply"] <= 0:
        raise AssertionError("solver_cavity launched no circulant_apply")
    if profile_dir:
        write_profile(lambda: advance(solver, ts), smi, profile_dir,
                      "profile_solver_cavity.txt",
                      f"lid-driven cavity {n}^2 f32, solver API")
    return ms, launches


def phase_solver_cavity_kernels(dev, smi):
    """The cavity with every solve in the whole-solve PCG kernel; returns
    (launches, times of the three solves at these shapes, max abs error)."""
    n, n_steps = SOLVER["n"], SOLVER["kernel_steps"]
    solver, ts = make_solver("cavity", n, dev, torch.float32, cg_rtol=None,
                             poisson_precond=None,
                             cg_iters=SOLVER["kernel_cg_iters"])
    elapsed, launches = timed_steps(solver, ts, n_steps)
    steps = N_WARMUP + n_steps
    if launches["circulant_pcg"] != 3 * steps:
        raise AssertionError(
            f"solver_cavity_kernels: {launches['circulant_pcg']} "
            f"circulant_pcg launches in {steps} steps, expected 3 per step")
    if launches["circulant_apply"] <= 0:
        raise AssertionError("solver_cavity_kernels launched no "
                             "circulant_apply")
    guards = cavity_guards(solver, "solver_cavity_kernels")
    subs = record_subsolves(lambda: advance(solver, ts))
    report, err_max = {}, 0.0
    for name, case in subs.items():
        x, r = cuda_band.circulant_pcg(*case)
        x_ref, r_ref = cuda_band.circulant_pcg_plain(*case)
        torch.cuda.synchronize()
        err = rel_err(x, x_ref)
        rn = float(torch.linalg.vector_norm(r.double()))
        rn_ref = float(torch.linalg.vector_norm(r_ref.double()))
        band, _, b = case[:3]
        b_ms, b_by = bound(*pcg_work(case), torch.float32)
        report[name] = {
            "route": pcg_route(case), "iters": case[6],
            "K": band.shape[0], "n": band.shape[1],
            "planes": b.numel() // band.shape[1],
            "masked": torch.is_tensor(case[5]), "meanfree": bool(case[7]),
            "rel_err": err, "res": rn, "res_plain": rn_ref,
            "ms": time_ms(lambda c=case: cuda_band.circulant_pcg(*c)),
            "device_ms": device_ms(lambda c=case: cuda_band.circulant_pcg(*c)),
            "plain_ms": time_ms(lambda c=case: cuda_band.circulant_pcg_plain(
                *c)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if not (err < 1e-5 and abs(rn - rn_ref) <= 1e-4 * rn_ref + 1e-6):
            emit({"phase": "solver_cavity_kernels", "failed": name,
                  "solves": report})
            raise AssertionError(
                f"solver_cavity_kernels {name} ({report[name]['route']}): "
                f"rel err {err}, |r| {rn} vs {rn_ref}")
        err_max = max(err_max, abs_err(x, x_ref))
    # the band matvec at the cavity's shapes (M on both velocity planes, L)
    fast = solver._fast
    rng = np.random.default_rng(9)
    applies = {}
    for name, op, batch in (("M_b2", fast.M, 2), ("L_b1", fast.L, 1)):
        x = torch.tensor(rng.standard_normal((batch, op.n)),
                         dtype=torch.float32, device=dev)
        call = lambda o=op, v=x: cuda_band.circulant_apply(o.band, o.offsets,
                                                           v)
        plain = lambda o=op, v=x: cuda_band.circulant_apply_plain(
            o.band, o.offsets, v)
        err = rel_err(call(), plain())
        if not err <= 1e-6:
            raise AssertionError(f"circulant_apply {name} at the cavity's "
                                 f"shape: rel err {err} > 1e-6")
        b_ms, b_by = bound(*apply_work(len(op.offsets), op.n, batch, 4),
                           torch.float32)
        applies[name] = {"K": len(op.offsets), "n": op.n, "rel_err": err,
                         "ms": time_ms(call), "device_ms": device_ms(call),
                         "plain_ms": time_ms(plain), "bound_ms": b_ms,
                         "bound_by": b_by}
    emit({"phase": "solver_cavity_kernels",
          "config": f"lid-driven cavity {n}^2 f32, cg_rtol None, no "
                    f"preconditioner, cg_iters {SOLVER['kernel_cg_iters']}",
          "step_kind": solver._step_kind, "steps_timed": n_steps,
          "ms_per_step": 1e3 * elapsed / n_steps,
          "dof_steps_per_s": n_steps * solver.space.n_dofs / elapsed,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "guards": guards, "solves": report, "applies": applies,
          "unit": "ms", "nvidia_smi": smi})
    return launches, report, err_max


def phase_solver_periodic(dev, smi, raw_ms):
    """Taylor-Green 128^2 through the solver API on both of its paths."""
    n, n_steps = N_POINTS, SOLVER["periodic_steps"]
    out, launches = {}, None
    for want, kw in (("spectral", {}),
                     ("fast", {"prefer_spectral": False,
                               "cg_rtol": SOLVER["cg_rtol"]})):
        t0 = time.perf_counter()
        solver, ts = make_solver("periodic", n, dev, torch.float32, **kw)
        t_ic = time.perf_counter() - t0
        elapsed, counts = timed_steps(solver, ts, n_steps)
        if solver._step_kind != want:
            raise AssertionError(f"solver_periodic: step_kind "
                                 f"{solver._step_kind!r}, expected {want!r}")
        x = solver.solution
        u, _ = solver.space.split(x)
        finite = bool(torch.isfinite(x).all())
        expected = math.exp(-2.0 * (1.0 / RE) * (2.0 * math.pi) ** 2
                            * ts.current_time)
        amp_err = abs(float(u.abs().max()) - expected) / expected
        out[want] = {"step_kind": solver._step_kind, "steps_timed": n_steps,
                     "ms_per_step": 1e3 * elapsed / n_steps,
                     "dof_steps_per_s": n_steps * solver.space.n_dofs
                     / elapsed,
                     "amp_rel_err": amp_err, "finite": finite,
                     "launches_per_step": {k: v / (N_WARMUP + n_steps)
                                           for k, v in counts.items()},
                     "setup_seconds": dict(setup_seconds(solver),
                                           through_initial_conditions=t_ic)}
        if want == "fast":
            launches = counts
            fast = solver._fast
            out[want]["operators"] = engine_formats(fast)
            out[want]["residuals_last"] = residual_records(solver)[-1] \
                .tolist()
            if fast.conv_strided is None or any(
                    type(op).__name__ != "StencilCoupling"
                    for op in fast.G + fast.D):
                raise AssertionError("solver_periodic: the torus engine did "
                                     "not take stencil couplings and the "
                                     "strided convection")
        if not finite or not amp_err < 0.05:
            raise AssertionError(f"solver_periodic {want}: finite {finite}, "
                                 f"amp_rel_err {amp_err}")
    emit({"phase": "solver_periodic",
          "config": f"taylor-green {n}^2 f32 through ProjectionSolver; the "
                    f"banded path with amg and cg_rtol {SOLVER['cg_rtol']:g}",
          "paths": out, "raw_step_ms": raw_ms, "nvidia_smi": smi})
    return launches


def parity_pair(problem, n, dev, n_steps, dts=None, **kw):
    """The same f64 run on the card (twice) and on the CPU: the relative
    differences of u and p, whether the card repeats itself bit for bit,
    and the card solver."""
    runs = []
    for where in (dev, dev, "cpu"):
        solver, ts = make_solver(problem, n, where, torch.float64, **kw)
        advance(solver, ts, n_steps, dts)
        runs.append(solver)
    a, b, c = (s.space.split(s.solution.cpu()) for s in runs)
    errs = {"u": rel_err(a[0], c[0]), "p": rel_err(a[1], c[1])}
    rerun = {"u": rel_err(b[0], a[0]), "p": rel_err(b[1], a[1]),
             "bitwise": bool(torch.equal(runs[0].solution,
                                         runs[1].solution))}
    return errs, rerun, runs[0]


def phase_solver_parity(dev):
    """f64 card against CPU through the solver API, both rim formats, and
    the checkpoint round trip on the card."""
    n, n_steps = SOLVER["n_parity"], N_PARITY
    dts = [0.02, 0.02, 0.03, 0.025, 0.02, 0.02, 0.015, 0.02, 0.03, 0.02]
    cases = {}
    saved = os.environ.get("NS_FASTOP_RIM_BYTES")
    for name, problem, size, rim, kw in (
            ("cavity_affine", "cavity", n, None, {"cg_rtol": 1e-10}),
            ("cavity_gather", "cavity", n, "1", {"cg_rtol": 1e-10}),
            ("channel", "channel", SOLVER["channel"], None,
             {"cg_rtol": 1e-10, "cg_iters": (60, 600, 30)})):
        try:
            if rim is not None:
                os.environ["NS_FASTOP_RIM_BYTES"] = rim
            errs, rerun, solver = parity_pair(
                problem, size, dev, n_steps,
                dts[:n_steps] if problem == "channel" else None, **kw)
        finally:
            if saved is None:
                os.environ.pop("NS_FASTOP_RIM_BYTES", None)
            else:
                os.environ["NS_FASTOP_RIM_BYTES"] = saved
        formats = sorted({type(op).__name__
                          for op in solver._fast.G + solver._fast.D})
        cases[name] = {"rel_err": errs, "rerun_on_card": rerun,
                       "step_kind": solver._step_kind,
                       "coupling_formats": formats}
        want = ["GatherOp"] if rim else ["AffineBand"]
        if solver._step_kind != "fast" or formats != want:
            raise AssertionError(f"solver_parity {name}: step_kind "
                                 f"{solver._step_kind}, couplings {formats}")
    # checkpoint round trip on the card (the channel, variable steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        kw = {"cg_rtol": 1e-10, "cg_iters": (60, 600, 30)}
        a, ats = make_solver("channel", SOLVER["channel"], dev,
                             torch.float64, **kw)
        advance(a, ats, 3, dts[:3])
        save_checkpoint(path, a, ats)
        b, bts = make_solver("channel", SOLVER["channel"], dev,
                             torch.float64, **kw)
        b._setup_problem()
        load_checkpoint(path, b, bts)
        advance(a, ats, 3, dts[3:6])
        advance(b, bts, 3, dts[3:6])
        resumed_equal = bool(
            torch.equal(a.solution, b.solution)
            and torch.equal(a._phi, b._phi)
            and torch.equal(a._u_old, b._u_old)
            and ats.current_time == bts.current_time)
    emit({"phase": "solver_parity", "steps": n_steps, "dtype": "float64",
          "cases": cases, "checkpoint_resume_bitwise": resumed_equal})
    for name, case in cases.items():
        for key, err in case["rel_err"].items():
            if not err <= 1e-9:
                raise AssertionError(f"solver f64 parity {name} {key}: rel "
                                     f"err {err} > 1e-9")
        for key in ("u", "p"):
            if not case["rerun_on_card"][key] <= 1e-12:
                raise AssertionError(f"solver_parity {name}: a second card "
                                     f"run differs in {key} by "
                                     f"{case['rerun_on_card'][key]}")
    if not resumed_equal:
        raise AssertionError("solver_parity: the resumed run differs from "
                             "the unbroken one")


GROUPS = ("kernels", "structured", "solver")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler table of 10 steps of "
                         "each path here")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="also time the kernels of the checkout in DIR")
    ap.add_argument("--phases", default=",".join(GROUPS), metavar="LIST",
                    help="comma-separated groups to run, of "
                         f"{', '.join(GROUPS)} (default: all; a subset "
                         "prints no kernels line)")
    args = ap.parse_args()
    groups = set(args.phases.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"--phases takes {', '.join(GROUPS)}")

    smi, kind = phase_device()
    phase_build()
    dev = torch.device(DEVICE)
    raw_ms, by_path = {}, {}
    if "kernels" in groups:
        st = Setup(dev)
        err_apply = phase_apply(st)
        err_pcg, subs32 = phase_pcg(st)
        by_path["main"], raw_ms["main"] = phase_main(st, smi, args.profile)
        steps = N_WARMUP + N_STEPS + 1
        times = phase_timing(st, subs32, smi,
                             {k: v / steps
                              for k, v in by_path["main"].items()})
        if args.baseline:
            phase_baseline(st, subs32, smi, args.baseline)
        phase_parity(st)
    if "structured" in groups:
        setups = []
        for name in STRUCTURED:
            setups.append(StructuredSetup(name, dev))
            raw_ms[name] = phase_structured(setups[-1], smi, args.profile)
        phase_structured_timing(setups, smi)
        phase_structured_parity(setups)
        del setups
    if "solver" in groups:
        _, by_path["solver_cavity"] = phase_solver_cavity(dev, smi,
                                                          args.profile)
        by_path["solver_cavity_kernels"], cavity_t, err_cavity = \
            phase_solver_cavity_kernels(dev, smi)
        by_path["solver_periodic_fast"] = phase_solver_periodic(dev, smi,
                                                                raw_ms)
        phase_solver_parity(dev)

    if groups == set(GROUPS):
        # ``launches`` sums the paths, each counted from 0 by its own phase;
        # every path that a kernel is on must have launched it
        on_path = {"circulant_apply": list(by_path),
                   "circulant_pcg": ["main", "solver_cavity_kernels"]}
        for name, paths in on_path.items():
            for path in paths:
                if by_path[path][name] <= 0:
                    raise AssertionError(f"{name} was not launched by the "
                                         f"path {path}")
        src = "navierstokes_tpu_torch/csrc/band.cu"
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "launches_per_step")
        apply_t = times["circulant_apply"]["M_b2"]
        pcg_t = times["circulant_pcg_step"]
        cavity_keys = ("route", "ms", "device_ms", "plain_ms", "bound_ms",
                       "bound_by")

        def row(name, err, t, extra):
            return {"name": name, "route": "cuda", "source": src,
                    "replaces": REPLACES[name],
                    "launches": sum(c[name] for c in by_path.values()),
                    "launches_by_path": {p: c[name]
                                         for p, c in by_path.items()},
                    "max_abs_err": err, **{k: t[k] for k in keys}, **extra}

        print(json.dumps({"kernels": [
            row("circulant_apply", err_apply, apply_t, {}),
            row("circulant_pcg", max(err_pcg, err_cavity), pcg_t,
                {"cavity_solves": {n: {k: t[k] for k in cavity_keys}
                                   for n, t in cavity_t.items()}})]}),
            flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
