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
               band; masked and mean-free cases on each; two planes,
               masked and not, on the cluster route in both dtypes), with
               each case's route; and both at the 3D cavity's shapes
               (24^3: the apply on three planes with K = 65 and on one
               with K = 15, the velocity PCG B = 3, K = 65 streamed on
               route B, masked and not, the mean-free Poisson K = 15 on
               route A).
4. main     -- the generic banded SBDF-2 projection step on the periodic
               Taylor-Green vortex at 128^2, f32, through the port's bench
               module (navierstokes_tpu_torch/bench.py, bench.py's generic
               path: Re = 100, dt = 1e-3, cg_iters = (10, 60, 6), one BDF-1
               and 3 BDF-2 warm-up steps), in its dispatch loop (200 timed
               eager steps) and then its scan loop (CUDA graphs of 50
               steps: one untimed chunk after the capture, 3 timed).
               Requires, in each loop, finite values, amp_rel_err < 0.05
               and launches of both kernels, and 3 launches of each per
               step in the captured chunk; prints per loop DoF-steps/s, the
               residual triple of one extra step, the launch counts and,
               for scan, the capture seconds and the launches captured.
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
6a. graph   -- one 50-step chunk as a CUDA graph (the scan loop's
               ChunkLoop) against the same 50 eager steps, from the
               warmed-up state, of both paths at 128^2 in f32 and f64: bit
               for bit (or, if two eager chunks differ, within their
               spread); the banded f32 graph replayed again, equal, after
               route B's scratch cache was emptied by 40 other plans; and
               a step with cg_rtol (a host read of ||r||) refused.
6b. bench   -- navierstokes_tpu_torch.bench.main() at its defaults
               (128^2, scan, f32): its JSON line; every path non-zero.
7. structured2d -- the structured spectral projection step (bench.py's
               primary path) on the Taylor-Green vortex at 128^2, f32,
               through the bench module as in phase 4: 200 eager steps,
               then the scan loop (4 chunks of 50).  Requires finite
               values and amp_rel_err < 0.05 in each loop; prints
               DoF-steps/s, the host setup seconds and the peak device
               memory per loop.
8. structured3d -- the same on the triply periodic shear wave at 48^3
               (2.76 M DoFs), f32: 50 eager steps, then 2 chunks of 50.
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
               figures of phases main and structured2d, and per step the
               host-to-device and device-to-host copies and item() reads of
               each path beside the raw steps' (torch.profiler).
14. solver_parity -- f64, card against CPU, 10 steps: cavity 32^2 with the
               defaults (AffineBand couplings) and again with
               NS_FASTOP_RIM_BYTES forcing GatherOp couplings, and the
               channel 20x4 with a time-dependent inflow; u and p must
               agree to 1e-9 relative; a second card run must repeat the
               first (no atomics on the path).  Then a checkpoint round
               trip on the card: save after 3 variable steps, load into a
               fresh solver, 3 more steps equal the unbroken run bit for
               bit.
15. problem_cavity -- the cavity of solver_cavity as an application: an
               InstationaryProblem subclass run by solve_problem() (CFL
               every step, vorticity added to the field output, PVD output
               every 50 steps into a temporary directory), 200 timed steps.
               Requires step_kind "fast", the lid and wall guards, the
               expected output files and circulant_apply launches; prints
               ms/step beside solver_cavity's, ms per output write, host
               syncs per step and the problem's stdout line count.
16. dfg     -- DFG 2D-2 (Schafer-Turek, Re = 100) at resolution 3 (75,509
               DoFs, every square operator an AffineBand under the RCM
               order), f32, through the port's demo class
               (demo/dfg_benchmark_projection.py), seeded by io/checkpoint
               from a saturated state of the
               same mesh: 1,400 steps of dt = 0.005 with the reaction force
               on the card every step, read once at the end.  Requires
               finite forces and, over the last 5 time units, c_D,max in
               [3.15, 3.30], c_L,max in [0.90, 1.05] and a Strouhal number
               (harmonic fit of c_L) in [0.285, 0.315]; prints ms/step,
               DoF-steps/s, the busy share, every operator's format and
               bytes, the AMG levels and the iterations per solve.
17. dfg_parity -- the same application at resolution 1, f64: 10 steps
               from a checkpoint the CPU writes after 40 steps from rest,
               on the card twice and on the CPU: u, p and the force series
               agree to 1e-12 relative in the max-norm and in the 2-norm,
               and the two card runs bit for bit.
18. newton_dfg -- DFG 2D-1 (Re = 20) at resolution 3 (75,509 DoFs), f64,
               configured as benchmarks/dfg_2d1_steady.py::run(3.0):
               StationarySolver(tol=1e-10, linear_solver="host_lu"), the
               Jacobian assembled on the card and factored by SuperLU on
               the host.  Requires ||F||_2 <= 1e-10, c_D in [5.57, 5.59],
               c_L in [0.0104, 0.0110] and within 1e-3 / 2e-5 of the JAX
               package's 5.5796 / 0.010636; prints the Picard and Newton
               counts and per iteration the Jacobian assembly (its first
               call, which also builds the device pattern, apart from the
               median of the rest), the copy to the host, splu, the solve
               and the residual.
19. newton_cavity -- demo/cavity_flow.py's StationaryProblem at 64^2,
               Re = 100, f64, with the card's default linear mode, which
               must resolve to "pcd" (matrix-free PCD + FGMRES + AMG).
               Requires ||F||_2 <= 1e-10 and the vertical centre line's
               u_min within 0.006 of Ghia's -0.2109, and that the first
               solve converged: one nonlinear solve on record
               (StationaryProblem's Reynolds continuation was not taken).
               Prints the counts, FGMRES matvecs per Newton step, host
               syncs (torch's sync debug mode), the AMG setup seconds,
               the gather tables of its hot loop (rows, padded width,
               mean row length of each AMG level and segment sum) and the
               device ms of three forms of the largest table's gather.
20. bdf_dfg -- DFG 2D-2 through ImplicitBDFSolver as
               benchmarks/dfg_monolithic.py runs it (resolution 3,
               do-nothing outflow, frozen LU, tol 1e-6, dt 0.005), the
               BDF-2 ring seeded from the committed t = 315 state, 100
               steps with the reaction force every step.  Requires every
               step to converge and c_D in [3.155, 3.230], c_L in [-1.02,
               0.99] on every step; prints ms/step, DoF-steps/s, Newton
               iterations per step, LU factorizations and the busy share.
21. newton_parity -- f64 at 12^2, the card against the CPU: the stationary
               solver in its dense, host_lu and pcd modes and 5 steps of
               the BDF (host_lu, frozen_lu), Crank-Nicolson, SBDF-2 and
               IPCS solvers; direct paths <= 1e-10, iterative <= 1e-8,
               equal Newton counts, a second card run of every direct path
               bit for bit.
22. cavity3d -- the 3D lid-driven cavity at 24^3 cells (368,572 DoFs;
               the lid (1, 0, 0) on top, no slip elsewhere), Re = 100, dt =
               0.25 / 48, f32, through ProjectionSolver with the solver's
               defaults: 4 warm-up and 20 timed steps.  Requires
               step_kind "fast" (CirculantBand M, K with 65 offsets, L,
               Mp with 15), circulant_apply launches, finite state, lid
               and walls to 1e-6; prints ms/step, DoF-steps/s, launches,
               busy share, peak memory and the host setup by stage.
23. cavity3d_kernels -- cavity3d's engine with cg_rtol None, no
               preconditioner and cg_iters (18, 300, 10), 20 timed steps:
               every solve one circulant_pcg launch (velocity B = 3,
               K = 65 on route B with the band streamed, Poisson K = 15 on
               route A); one step's solves held against their plain
               versions and timed with their bounds, and the applies at
               these shapes beside torch.sparse.mm.
24. duct3d  -- plane Poiseuille flow in tests/test_3d_solver.py's duct at
               (18, 6, 6) cells, f64, 200 steps of 0.05: the exact profile
               to 1e-6, step_kind "fast".
25. shell3d -- spherical Couette flow on spherical_shell(3, (0.5, 1), 16)
               (48,672 cells, 216,046 DoFs), f32, Re = 1, dt = 0.025, 60
               steps: one fastop_fallback record (no band format holds the
               shell), the cell-loop step ("generic"), and u_phi on the
               equatorial plane within 1e-3 Omega r_i of the Stokes
               solution.
26. bfs     -- demo/backward_facing_step.py's StationaryProblem (Re 50),
               f64, host LU, on the built-in mesh and on
               read_geo_msh("meshes/backward_facing_step.geo"): the first
               solve converges (no Reynolds continuation), inflow equals
               outflow to 1e-8, and the mesh's XDMF write and read-back
               through the inline-XML branch is array-equal; prints the
               recirculation length.
27. blasius -- demo/blasius_flow.py's StationaryProblem (Re 200), f64,
               host LU, the same convergence requirement.
28. mesh3d_parity -- f64, the card against the CPU: 10 steps of the
               cavity at 6^3 (banded) and of the cell loop on
               spherical_shell(3, (0.5, 1), 6) forced by
               NS_FASTOP_MAX_BYTES, each <= 1e-12; the backward-facing
               step's stationary solution <= 1e-10.
29. halo_shell -- shell3d's case (the same shell, f32, dt and steps)
               through ProjectionSolver(device_mesh=device_mesh(4)): four
               shards of one card (shard i on cuda:(i % device_count)),
               the domain-decomposed halo step ("halo").  shell3d's u_phi
               guard, and the state within 1e-3 (relative, max-norm) of the
               one-device cell loop's after the same steps (f32: both run
               every solve to its cap); prints ms/step, the halo report,
               the bytes of halo buffers exchanged per step, host syncs and
               ops per step and the peak memory.
30. spectral_sharded -- Taylor-Green 128^2 (structured2d's case) through
               ProjectionSolver(device_mesh=device_mesh(4)) on the
               slab-sharded spectral step, 200 timed steps, beside the
               unsharded solver: amp_rel_err < 0.05 and the two states
               within 1e-5 (f32).
31. stationary_sharded -- newton_cavity's problem at 64^2 (Re 100, f64)
               with solver_options device_mesh=device_mesh(4): the
               cell-sharded residual and Jacobian inside PCD-FGMRES; the
               first solve converges and the solution is within 1e-10 of
               the one-device solve's.
32. multidevice_parity -- f64, 5 steps: the halo step on the 3D cavity
               6^3 and on the shell n = 6, the sharded spectral step at
               16^2 and 8^3, the sharded Newton matvec on the cavity 16^2;
               card vs CPU and 4 shards vs 1 each within 1e-12 (relative,
               max-norm), a second card run bit for bit; a checkpoint of
               the sharded channel resumes bit for bit on one device and
               back, and a resumed sharded run equals the unbroken one.
33. native  -- the g++ mesh helper (navierstokes_tpu_torch/native):
               built from the repository's fastmesh.cpp (the library
               loaded must be that build), then on the 48^3 box's topology
               unique_rows (facets, edges) and build_transpose (the P2
               velocity table) array-equal to the NumPy versions they
               replace; both timed on the card's host.
34. demo_gravity -- the port's demo/gravity_driven_flow.py class at the
               shipped n = 50, f64, host LU: one nonlinear solve,
               ||F|| <= 1e-10, ||u|| and max|u| within 1e-8 and the total
               boundary mass flux within 1e-9 of the JAX package's CPU
               values.
35. demo_taylor_green -- the port's demo/taylor_green_vortex.py class
               (ImplicitBDFSolver, 32^2, 100 steps to t = 1, frozen LU),
               f64: L2(u) against the analytic decay within 1e-8 of the
               JAX package's CPU value.
36. demo_periodic_box_3d -- the port's demo/periodic_box_3d.py class
               (16^3, 50 steps, f32): the spectral step, max|u| within
               1e-3 of the analytic decay.
37. convergence -- the port's convergence_test/taylor_green_vortex.py
               in f64: projection mode at 128^2 over 6 levels on the
               spectral step and on the banded step (prefer_spectral
               False, cg_rtol 1e-12: circulant_apply must launch), then
               bdf mode at 32^2 over 4 levels; every L2(u) within 1e-6 of
               the JAX package's CPU value and the observed orders past
               the first in [1.8, 2.4]; the spectral run also on this
               machine's CPU, every L2(u) of the card within 1e-10 of it.
               Every apps phase prints its launches per step of both
               kernels.
38. the total seconds, the ``kernels`` line, then the card's nvidia-smi
   line, then the last line ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes a torch.profiler table of 10 steps of each
path (banded, structured 2D, structured 3D, solver cavity, problem cavity,
DFG, monolithic DFG, 3D cavity, shell), of one Newton iteration of newton_dfg and of one
10-iteration PCD-FGMRES restart cycle of newton_cavity (by device time,
host time and input shape) to DIR.
``--phases LIST`` runs only the named groups (``kernels``,
``structured``, ``solver``, ``problems``, ``newton``, ``mesh3d``,
``multidevice``, ``apps``; the
device and build phases always run) and then prints no ``kernels`` line.  ``--baseline DIR``
also times the kernels of another checkout of this repository (its ``navierstokes_tpu_torch``, built from its own
source) on the same inputs in the same process, in the order baseline,
this, this, baseline.
"""

import argparse
import contextlib
import functools
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import scipy
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from navierstokes_tpu_torch import bench, native
from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import (FastTaylorHood,
                                                    combine_circulant,
                                                    planar_ops_from_numpy,
                                                    planar_ops_to_numpy)
from navierstokes_tpu_torch.convergence_test import \
    taylor_green_vortex as tg_study
from navierstokes_tpu_torch.demo import (backward_facing_step, blasius_flow,
                                         cavity_flow,
                                         dfg_benchmark_projection,
                                         gravity_driven_flow,
                                         periodic_box_3d)
from navierstokes_tpu_torch.demo import taylor_green_vortex as tg_demo
from navierstokes_tpu_torch.demo.dfg_benchmark_projection import \
    DFGBenchmark2D2Projection
from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.io import load_checkpoint, save_checkpoint
from navierstokes_tpu_torch.mesh import (channel_with_cylinder, hyper_cube,
                                         read_geo_msh, xdmf_io)
from navierstokes_tpu_torch.parallel import device_mesh
from navierstokes_tpu_torch.parallel.halo import HaloCellOperator
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.setups import (channel_setup, duct_profile,
                                           duct_setup,
                                           lid_driven_cavity_setup,
                                           parabolic_inlet,
                                           spherical_couette_setup,
                                           spherical_couette_stokes,
                                           taylor_green_setup)
from navierstokes_tpu_torch.solvers import (ImplicitBDFSolver,
                                            ProjectionSolver,
                                            StationarySolver, planar_step)
from navierstokes_tpu_torch.solvers.halo_step import \
    build_halo_projection_step
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               StructuredConvection,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.structured.spectral import _cmatmul
from navierstokes_tpu_torch.timestepping import BDFTimeStepping
from navierstokes_tpu_torch.utils.graph import CaptureError, ChunkLoop

RE = 100.0
DT = 1.0e-3
N_POINTS = 128
CG_ITERS = (10, 60, 6)
N_WARMUP = 4
N_PARITY = 10
ALPHAS = ((1.0, -1.0, 0.0), (1.5, -2.0, 0.5))
ETAS = ((1.0, 0.0), (2.0, -1.0))
RUNS = 30
PROFILE_LAUNCHES = 20
# the structured spectral path: bench.py's sizes (NS_BENCH_DIM=2 / 3), the
# timed steps and the parity grid sizes
STRUCTURED = {
    "structured2d": {"dim": 2, "n": 128, "steps": 200, "n_parity": 128},
    "structured3d": {"dim": 3, "n": 48, "steps": 50, "n_parity": 16},
}
N_BUSY = 10
# the solver-API phases: the cavity of benchmarks/cavity_re1000.py (its
# Re, step size and fixed-iteration counts) and the parity grids
SOLVER = {"n": 128, "re": 1000.0, "steps": 200, "cg_rtol": 1e-6,
          "kernel_steps": 50, "kernel_cg_iters": (18, 300, 10),
          "periodic_steps": 100, "n_parity": 32, "channel": (20, 4)}
DEVICE = "cuda:0"
# the 3D cavity's size (24^3 cells: 117,649 velocity and 15,625 pressure
# nodes), whose band shapes the kernels phase also holds
MESH3D_KERNEL_N = 24
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
    records, so the trace's own count is the divisor, a trace with fewer
    than half of the launches is taken again, and the third such trace is
    refused)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
        if total > 0.0 and 2 * records >= PROFILE_LAUNCHES:
            return total / records / 1e3
    raise RuntimeError(f"torch.profiler recorded {records} of "
                       f"{PROFILE_LAUNCHES} kernel launches, three times")


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
    if kind == "batch2":
        shape = (2, n)
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


@functools.lru_cache(maxsize=None)
def box_offsets(n, degree):
    """The offsets of the P2 (``degree`` 2) or P1 band of a 3D box of n^3
    cells under the lexicographic order, as FastTaylorHood builds them
    (65 and 15): the stencil read off the engine of a 3^3 box (node grids
    7^3 and 4^3, every stencil component within +-2) and laid on the
    n^3 box's grid of (degree n + 1)^3 nodes."""
    small = box_engine3()
    op = small.M if degree == 2 else small.L
    g_small, g = 2 * 3 + 1 if degree == 2 else 3 + 1, degree * n + 1
    N_small, N = g_small ** 3, g ** 3
    out = []
    for o in op.offsets:
        s = o if o <= N_small // 2 else o - N_small
        comps = []
        for _ in range(2):
            c = (s + g_small // 2) % g_small - g_small // 2
            comps.append(c)
            s = (s - c) // g_small
        dx, dy, dz = comps[0], comps[1], s
        out.append((dz * g * g + dy * g + dx) % N)
    return tuple(sorted(out))


@functools.lru_cache(maxsize=None)
def box_engine3():
    """FastTaylorHood of the 3^3 box on the CPU (f64)."""
    mesh, _ = hyper_cube(3, 3)
    return FastTaylorHood(TaylorHoodSpace(mesh), dtype=torch.float64,
                          device="cpu")


def box_case(kind, dtype, dev, n=MESH3D_KERNEL_N):
    """Kernel cases at the 3D cavity's shapes (n^3 cells): ``apply_M``
    and ``apply_L`` ((band, offsets, x)), the velocity solve on route B
    with the band streamed (``velocity`` / ``velocity_masked``: B = 3,
    K = 65, 10 iterations) and the mean-free Poisson solve on route A
    (``poisson``: B = 1, K = 15, 60 iterations).  A random band with one
    value on each offset pair (so symmetric) and a dominant diagonal; the
    Poisson band a graph Laplacian (row sums 0)."""
    rng = np.random.default_rng(13)
    degree = 1 if kind in ("apply_L", "poisson") else 2
    offs = list(box_offsets(n, degree))
    N = (degree * n + 1) ** 3
    batch = 1 if degree == 1 else 3
    band = np.empty((len(offs), N))
    d = offs.index(0)
    if kind == "poisson":
        band[:] = -1.0
        band[d] = len(offs) - 1.0
    else:
        pair = {}
        for k, o in enumerate(offs):
            key = min(o, (N - o) % N)
            band[k] = pair.setdefault(key, -0.5 - rng.random())
        band[d] = np.abs(np.delete(band, d, axis=0)).sum(0) + 1.0 \
            + rng.random(N)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    if kind.startswith("apply"):
        return t(band), offs, t(rng.standard_normal((batch, N)))
    shape = (batch, N) if batch > 1 else (N,)
    b = rng.standard_normal(shape)
    x0 = np.zeros(shape)
    maskv = 1.0
    if kind == "velocity_masked":
        fixed = np.zeros(shape, bool)
        fixed[:, :N // 20] = True
        g = np.where(fixed, rng.standard_normal(shape), 0.0)
        b, x0 = np.where(fixed, g, b), g
        maskv = t(np.where(fixed, 0.0, 1.0))
    iters = 60 if kind == "poisson" else 10
    return (t(band), offs, t(b), t(x0), t(1.0 / band[d]), maskv, iters,
            kind == "poisson")


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
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "numpy": np.__version__, "scipy": scipy.__version__})
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
    # the 3D cavity's shapes: the velocity pair of planes has three here
    # (the <T, 4> instance with three live planes), K = 65 and 15
    for kind in ("apply_M", "apply_L"):
        band, offs, x = box_case(kind, torch.float64, "cpu")
        cases.append((f"box3d_{kind}_{MESH3D_KERNEL_N}", offs, band.numpy(),
                      x.numpy()))
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
             for k in ("plain", "batch2", "masked", "meanfree")
             for dtype in (torch.float32, torch.float64)]
    cases.append(("streamed_n1048576", streamed_case(torch.float32, st.dev),
                  torch.float32))
    # the 3D cavity's solves: velocity B = 3, K = 65 on route B with the
    # band streamed, masked and not; the mean-free Poisson K = 15 on route A
    cases += [(f"box3d_{k}_{MESH3D_KERNEL_N}", box_case(k, dtype, st.dev),
               dtype)
              for k in ("velocity", "velocity_masked", "poisson")
              for dtype in (torch.float32, torch.float64)]
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
        planes = case[2].numel() // case[0].shape[1]
        seen |= {(route, str(dtype)), (route, "masked" if masked else
                                       "meanfree" if meanfree else "plain"),
                 (route, f"B{planes}", "masked" if masked else "unmasked",
                  str(dtype)),
                 (route, f"B{planes}", f"K{case[0].shape[0]}",
                  "masked" if masked else "meanfree" if meanfree
                  else "unmasked", str(dtype))}
        report.append({"case": name, "dtype": str(dtype), "route": route,
                       "planes": planes, "rel_err": err, "res": rn,
                       "res_plain": rn_ref})
    # route A with two planes in both dtypes, masked and not: the block
    # size band.cu pins (kClusterThreads) is the one these cases run
    need = {("cluster", "torch.float32"), ("cluster", "torch.float64"),
            ("grid", "torch.float32"), ("grid", "torch.float64"),
            ("grid-streamed", "torch.float32"), ("cluster", "masked"),
            ("cluster", "meanfree"), ("grid", "masked"), ("grid", "meanfree")}
    need |= {("cluster", "B2", m, str(dt)) for m in ("masked", "unmasked")
             for dt in (torch.float32, torch.float64)}
    # the 3D cavity's shapes (box_case)
    for dt in (torch.float32, torch.float64):
        need |= {("grid-streamed", "B3", "K65", m, str(dt))
                 for m in ("masked", "unmasked")}
        need.add(("cluster", "B1", "K15", "meanfree", str(dt)))
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


# host<->device copies and host syncs per step of the raw steps (phases
# main and structured2d), read by solver_periodic beside the solver paths
RAW_IO = {}


def io_counts(events, n_steps):
    """Copies each way and ``item()``-style reads (one host
    synchronisation each) per step, from torch.profiler rows."""
    c = {"memcpy_htod": 0, "memcpy_dtoh": 0, "local_scalar_reads": 0}
    for e in events:
        if e.key.startswith("Memcpy HtoD"):
            c["memcpy_htod"] += e.count
        elif e.key.startswith("Memcpy DtoH"):
            c["memcpy_dtoh"] += e.count
        elif e.key == "aten::_local_scalar_dense":
            c["local_scalar_reads"] += e.count
    return {k + "_per_step": v / n_steps for k, v in c.items()}


def io_per_step(advance, n=None):
    """:func:`io_counts` of ``n`` (default N_BUSY) profiled calls of
    ``advance`` (one step each)."""
    from torch.profiler import ProfilerActivity, profile

    n = N_BUSY if n is None else n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            advance()
        torch.cuda.synchronize()
    return io_counts(prof.key_averages(), n)


def bench_row(result, n_dofs, report):
    """One loop's line of a bench path: ``result`` as the path functions
    of navierstokes_tpu_torch/bench.py return it, ``report`` the scan
    loop's capture seconds, captured launches and replays."""
    elapsed, n_timed, finite, quality, _ = result
    return {"steps_timed": n_timed, "seconds": elapsed,
            "ms_per_step": 1e3 * elapsed / n_timed,
            "dof_steps_per_s": n_timed * n_dofs / elapsed,
            "finite": finite, **quality, **report}


def check_bench_row(name, loop, row):
    if not row["finite"]:
        raise AssertionError(f"{name} ({loop} loop) produced non-finite "
                             "values")
    if not row["amp_rel_err"] < 0.05:
        raise AssertionError(f"{name} ({loop} loop): amp_rel_err "
                             f"{row['amp_rel_err']} >= 0.05")


def phase_main(st, smi, profile_dir):
    """The main path: bench.py's generic path through the port's bench
    module (navierstokes_tpu_torch/bench.py), in its dispatch loop and
    then its scan loop (CUDA graphs of bench.CHUNK steps).  Returns the
    launch counts of each loop's run and the dispatch loop's ms per
    step."""
    loops, launches = {}, {}
    for loop in ("dispatch", "scan"):
        report = {}
        cuda_band.reset_launch_counts()
        result = bench.bench_generic(st.space, st.u0, st.p0, loop=loop,
                                     device=st.dev, report=report)
        launches[loop] = dict(cuda_band.LAUNCHES)
        loops[loop] = dict(bench_row(result, st.space.n_dofs, report),
                           launches=launches[loop])
        if loop == "dispatch":
            state = result[4]
    emit({"phase": "main", "config": f"taylor-green {N_POINTS}^2 f32, "
                                     "bench.bench_generic",
          "n_dofs": st.space.n_dofs, "chunk": bench.CHUNK, "loops": loops,
          "nvidia_smi": smi})
    for loop, row in loops.items():
        check_bench_row("main", loop, row)
        for name, count in launches[loop].items():
            if count <= 0:
                raise AssertionError(f"{name} was not launched by the main "
                                     f"path's {loop} loop")
    want = {name: 3 * bench.CHUNK for name in cuda_band.LAUNCHES}
    if loops["scan"]["captured_launches"] != want:
        raise AssertionError(f"captured launches "
                             f"{loops['scan']['captured_launches']}, "
                             f"expected {want}")
    step = step_for(st.fast32.ops)
    box = [state]

    def advance():
        u_new, p_new, phi = step(*box[0], ALPHAS[1], ETAS[1])
        box[0] = (u_new, box[0][0], p_new, phi)

    RAW_IO["main"] = io_per_step(advance)
    if profile_dir:
        write_profile(advance, smi, profile_dir, "profile_main.txt",
                      f"taylor-green {N_POINTS}^2 f32, banded step")
    return launches, loops["dispatch"]["ms_per_step"]


def planar_advance(step):
    """``state -> next state`` of a planar step in BDF-2, the state
    ``(u, u_old, p, phi)``."""
    def advance(state):
        u, u_old, p, phi = state
        u_new, p_new, phi_new = step(u, u_old, p, phi, ALPHAS[1], ETAS[1])
        return (u_new, u, p_new, phi_new)

    return advance


def leaves(state):
    return pytree.tree_leaves(state)


def states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def states_diff(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def eager_chunk(advance, state, n):
    for _ in range(n):
        state = advance(state)
    torch.cuda.synchronize()
    return state


def graph_case(advance, state0, dev):
    """One chunk as a CUDA graph against the same chunk of eager steps
    from ``state0`` (run twice); returns (row, loop, eager state)."""
    n = bench.CHUNK
    eager = eager_chunk(advance, state0, n)
    again = eager_chunk(advance, state0, n)
    cuda_band.reset_launch_counts()
    loop = ChunkLoop(advance, state0, n, dev)
    graph = loop.run()
    torch.cuda.synchronize()
    row = {"graph_equals_eager": states_equal(graph, eager),
           "eager_equals_eager": states_equal(again, eager),
           "max_abs_diff": states_diff(graph, eager),
           "eager_spread": states_diff(again, eager),
           "capture_seconds": loop.capture_seconds,
           "captured_launches": loop.captured_launches}
    return row, loop, eager


def plain_ms_per_step(loop, replays=3):
    """Ms per step of ``replays`` replays of the loop's graph (after one
    more)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    loop.run()
    start.record()
    for _ in range(replays):
        loop.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * loop.n)


def trace_case(loop, attempts=3):
    """The program's tracing of a captured loop: the capture's split and
    node count, each phase's device ms per step from marks in a short
    graph (``ChunkLoop.phase_ms``) and that graph's own ms per step,
    against plain replays of the loop's graph just before and after it.
    The card runs a graph at one of two speeds, about 0.35 us per node
    apart, and may switch within a process, so the reading is taken again
    (up to ``attempts`` times) until the plain replays before and after
    agree within 1 %."""
    for attempt in range(1, attempts + 1):
        before = plain_ms_per_step(loop)
        marked = loop.phase_ms()
        after = plain_ms_per_step(loop)
        if abs(after / before - 1.0) <= 0.01:
            break
    plain = 0.5 * (before + after)
    four = sum(marked.phases[k] for k in ("convection", "helmholtz",
                                          "poisson", "correction"))
    parts = loop.warmup_seconds + loop.record_seconds + \
        loop.instantiate_seconds
    return {"nodes": loop.nodes, "nodes_per_step": loop.nodes / loop.n,
            "warmup_s": loop.warmup_seconds, "record_s": loop.record_seconds,
            "instantiate_s": loop.instantiate_seconds,
            "capture_s": loop.capture_seconds, "phase_ms": marked.phases,
            "marked_ms_per_step": marked.step_ms,
            "plain_ms_per_step": [before, after], "attempts": attempt,
            "phases_vs_marked": four / marked.step_ms - 1.0,
            "marked_vs_plain": marked.step_ms / plain - 1.0,
            "ok": loop.nodes > 0 and parts <= loop.capture_seconds
            and abs(four / marked.step_ms - 1.0) <= 0.03
            and abs(marked.step_ms / plain - 1.0) <= 0.10}


def route_b_evictions(dev, count=40):
    """Route-B solves of ``count`` other plans, each on a stream of its
    own (more than the scratch cache's 32 entries), then the cache
    cleared and the freed memory handed out again, filled with NaN."""
    M = FastTaylorHood(taylor_green_setup(32)[0], dtype=torch.float32,
                       device=dev).M
    rng = np.random.default_rng(9)
    inv = torch.ones(M.n, dtype=torch.float32, device=dev)
    for i in range(count):
        with torch.cuda.stream(torch.cuda.Stream()):
            b = torch.tensor(rng.standard_normal((2, M.n)),
                             dtype=torch.float32, device=dev)
            cuda_band.circulant_pcg(M.band, M.offsets, b, torch.zeros_like(b),
                                    inv, None, 1 + i, False)
    torch.cuda.synchronize()
    cuda_band._grid_scratch.cache_clear()
    torch.cuda.empty_cache()
    return torch.full((1 << 27,), float("nan"), device=dev)


def phase_graph(st, smi):
    """The scan loop's CUDA graphs against the eager steps at 128^2: one
    chunk of each bench path in f32 and f64 from its warmed-up state, bit
    for bit (or, if two eager chunks differ, within their spread); the
    banded f32 graph replayed again after route B's scratch cache was
    emptied; a step that reads the device on the host (cg_rtol set)
    refused; and each graph's tracing (``trace_case``: node count, the
    capture's split within ``capture_seconds``, the four phases within 3 %
    of their marked graph's ms per step, which is within 10 % of the
    plain replay's).  Returns the banded f32 chunk's captured launches."""
    sgrid = PeriodicStructuredTH(st.space)
    flat = st.u0.reshape(-1)
    rows, loops = {}, {}
    for dtype, ops in ((torch.float32, st.fast32.ops),
                       (torch.float64, st.ops64)):
        step = step_for(ops)
        u, p = st.initial(dtype, st.dev)
        state0 = bdf_steps(step, u, p, N_WARMUP)
        key = f"generic_{str(dtype)[6:]}"
        rows[key], loop, eager = graph_case(planar_advance(step), state0,
                                            st.dev)
        rows[key]["trace"] = trace_case(loop)
        loops[key] = (loop, state0, eager)
    for dtype in (torch.float32, torch.float64):
        sstep, init_state, _ = build_spectral_projection_step(
            sgrid, visc=1.0 / RE, dt=DT, dtype=dtype, device=st.dev)
        state0 = spectral_steps(sstep, init_state(flat, flat, st.p0),
                                N_WARMUP)
        key = f"structured_{str(dtype)[6:]}"
        rows[key], loop, _ = graph_case(
            lambda s, sstep=sstep: sstep(s, ALPHAS[1], ETAS[1]), state0,
            st.dev)
        rows[key]["trace"] = trace_case(loop)
        del loop
    # replay after the cache that held route B's eager scratch let go
    loop, state0, eager = loops["generic_float32"]
    junk = route_b_evictions(st.dev)
    for dst, src in zip(leaves(loop.state), leaves(state0)):
        dst.copy_(src)
    evicted = states_equal(loop.run(), eager)
    del junk
    # a step with a residual tolerance reads ||r|| on the host
    u, p = st.initial(torch.float32, st.dev)
    try:
        ChunkLoop(planar_advance(step_for(st.fast32.ops, cg_rtol=1e-6)),
                  (u, u, p, torch.zeros_like(p)), 2, st.dev)
        refused = None
    except CaptureError as exc:
        refused = str(exc)[:300]
    emit({"phase": "graph", "chunk": bench.CHUNK, "cases": rows,
          "replay_after_scratch_eviction_equals_eager": evicted,
          "host_read_refused": refused, "nvidia_smi": smi})
    bad = [k for k, r in rows.items()
           if not (r["graph_equals_eager"]
                   or (not r["eager_equals_eager"]
                       and r["max_abs_diff"] <= r["eager_spread"]))
           or not r["trace"]["ok"]]
    if bad or not evicted or refused is None:
        raise AssertionError(f"graph checks failed: cases {bad}, replay "
                             f"after eviction equal {evicted}, host read "
                             f"refused {refused is not None}")
    return rows["generic_float32"]["captured_launches"]


def phase_bench(smi):
    """``python -m navierstokes_tpu_torch.bench``'s main at its defaults
    (128^2, scan loop, f32), in process: its JSON line, every path
    non-zero and free of errors.  Returns the launch counts of its run."""
    cuda_band.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        record = bench.main()
    launches = dict(cuda_band.LAUNCHES)
    emit({"phase": "bench", "line": record, "launches": launches,
          "nvidia_smi": smi})
    failed = {k: v for k, v in record["paths"].items()
              if k.endswith("_error") or not v > 0}
    if failed:
        raise AssertionError(f"bench paths read 0 or raised: {failed}")
    return launches


def write_profile(advance, smi, profile_dir, filename, title, n=None):
    """torch.profiler table of ``n`` (default N_BUSY) calls of ``advance``
    (one step each)."""
    from torch.profiler import ProfilerActivity, profile

    n = N_BUSY if n is None else n
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            advance()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(profile_dir, filename), "w") as f:
        f.write(f"{smi}\n{n} steps, {title}\n{table}")


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
    """bench.py's structured path through the port's bench module, in its
    dispatch loop and then its scan loop (CUDA graphs of bench.CHUNK
    steps); returns the dispatch loop's ms per step."""
    cfg, space = ss.cfg, ss.space
    loops = {}
    for loop in ("dispatch", "scan"):
        torch.cuda.reset_peak_memory_stats()
        report = {}
        result = bench.bench_structured(space, ss.u0, ss.p0, loop=loop,
                                        n_steps=cfg["steps"], device=ss.dev,
                                        report=report)
        loops[loop] = dict(bench_row(result, space.n_dofs, report),
                           peak_device_bytes=torch.cuda.max_memory_allocated())
        u_flat, p_flat = ss.read_state(result[4])
        if u_flat.shape != (space.n_velocity_dofs,) or \
                p_flat.shape != (space.n_pnodes,):
            raise AssertionError(f"{ss.name}: read_state shapes "
                                 f"{u_flat.shape}, {p_flat.shape}")
        if loop == "dispatch":
            ss.state = result[4]
    emit({"phase": ss.name, "config": ss.config, "n_dofs": space.n_dofs,
          "grid": list(ss.sgrid.shape), "chunk": bench.CHUNK,
          "loops": loops, "setup_seconds": ss.setup_seconds,
          "nvidia_smi": smi})
    for loop, row in loops.items():
        check_bench_row(ss.name, loop, row)
    RAW_IO[ss.name] = io_per_step(ss.advance)
    if profile_dir:
        write_profile(ss.advance, smi, profile_dir,
                      f"profile_{ss.name}.txt", ss.config)
    return loops["dispatch"]["ms_per_step"]


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
        # of the kernels it launched, and a range of the program's phases
        # (a user annotation) spans them on the device's timeline too
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
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
            "per_step": counts,
            "io": io_counts(prof.key_averages(), N_BUSY)}


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


def pcg_solve_row(case, dtype):
    """A whole-solve case held against its plain version and timed."""
    x, r = cuda_band.circulant_pcg(*case)
    x_ref, r_ref = cuda_band.circulant_pcg_plain(*case)
    torch.cuda.synchronize()
    err = rel_err(x, x_ref)
    rn = float(torch.linalg.vector_norm(r.double()))
    rn_ref = float(torch.linalg.vector_norm(r_ref.double()))
    band, _, b = case[:3]
    b_ms, b_by = bound(*pcg_work(case), dtype)
    row = {"route": pcg_route(case), "iters": case[6], "K": band.shape[0],
           "n": band.shape[1], "planes": b.numel() // band.shape[1],
           "masked": torch.is_tensor(case[5]), "meanfree": bool(case[7]),
           "rel_err": err, "res": rn, "res_plain": rn_ref,
           "ms": time_ms(lambda: cuda_band.circulant_pcg(*case)),
           "device_ms": device_ms(lambda: cuda_band.circulant_pcg(*case)),
           "plain_ms": time_ms(lambda: cuda_band.circulant_pcg_plain(*case)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    ok = err < 1e-5 and abs(rn - rn_ref) <= 1e-4 * rn_ref + 1e-6
    return row, ok, abs_err(x, x_ref)


def apply_row(op, batch, dev, seed):
    """circulant_apply of ``op`` on ``batch`` planes against its plain
    version and torch.sparse.mm, with times and bound (f32)."""
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (batch, op.n)), dtype=torch.float32, device=dev)
    call = lambda: cuda_band.circulant_apply(op.band, op.offsets, x)
    plain = lambda: cuda_band.circulant_apply_plain(op.band, op.offsets, x)
    err = rel_err(call(), plain())
    if not err <= 1e-6:
        raise AssertionError(f"circulant_apply K = {len(op.offsets)}, "
                             f"n = {op.n}: rel err {err} > 1e-6")
    A, xT = csr_of(op), x.t().contiguous()
    lib_err = rel_err(torch.sparse.mm(A, xT).t(), call())
    if not lib_err <= 1e-6:
        raise AssertionError(f"torch.sparse.mm disagrees: {lib_err}")
    b_ms, b_by = bound(*apply_work(len(op.offsets), op.n, batch, 4),
                       torch.float32)
    return {"K": len(op.offsets), "n": op.n, "planes": batch,
            "rel_err": err, "max_abs_err": abs_err(call(), plain()),
            "ms": time_ms(call), "device_ms": device_ms(call),
            "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.sparse.mm(A, xT))}


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
        report[name], ok, err = pcg_solve_row(case, torch.float32)
        if not ok:
            emit({"phase": "solver_cavity_kernels", "failed": name,
                  "solves": report})
            raise AssertionError(
                f"solver_cavity_kernels {name} ({report[name]['route']}): "
                f"rel err {report[name]['rel_err']}, |r| "
                f"{report[name]['res']} vs {report[name]['res_plain']}")
        err_max = max(err_max, err)
    # the band matvec at the cavity's shapes (M on both velocity planes, L)
    fast = solver._fast
    applies = {"M_b2": apply_row(fast.M, 2, dev, 9),
               "L_b1": apply_row(fast.L, 1, dev, 10)}
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
        # the solver layer's copies and syncs per step beside the raw
        # step's (ROADMAP C: the solver layer's cost per step)
        out[want]["io_per_step"] = solver_busy(
            solver, ts, 1e3 * elapsed / n_steps)["io"]
        out[want]["raw_io_per_step"] = RAW_IO.get(
            "structured2d" if want == "spectral" else "main")
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


# ---------------------------------------------------------------------------
# the application layer: Problem classes, postprocessing, field output
# ---------------------------------------------------------------------------

# problem_cavity mirrors solver_cavity as an application; dfg is DFG 2D-2
# (Schafer-Turek, Re = 100) at resolution 3 seeded from a saturated state
# of the JAX package's monolithic solver on the same (symmetric) mesh;
# dfg_parity is the same application at resolution 1 in f64.
PROBLEMS = {"cavity_n": 128, "cavity_steps": 200, "output_every": 50,
            "dfg_res": 3.0, "dfg_dt": 0.005, "dfg_steps": 1400,
            "dfg_window": 5.0,
            "dfg_seed": "benchmarks/states/dfg_2d2_state_mono_res3_sym.npz",
            "dfg_dofs": (67008, 8501), "parity_res": 1.0,
            "parity_warm_steps": 40, "parity_steps": 10}
# literature 3.22-3.24 / 0.99-1.01 / 0.295-0.305 (Schafer & Turek 1996);
# the JAX package's projection chain gives 3.2163-3.2233 / 0.970 / 0.3000
DFG_GUARDS = {"cd_max": (3.15, 3.30), "cl_max": (0.90, 1.05),
              "strouhal": (0.285, 0.315)}
H_DFG = dfg_benchmark_projection.H


class CavityProblem(InstationaryProblem):
    """The lid-driven cavity of solver_cavity as an application: CFL every
    step (the reference default), vorticity added to the field output."""

    def __init__(self, main_dir, n, n_steps, output_every, **kw):
        super().__init__(main_dir, start_time=0.0, end_time=1.0e6,
                         desired_start_time_step=0.25 / (2.0 * n),
                         n_max_steps=n_steps, **kw)
        self._output_format = "pvd"
        self._problem_name = "cavity"
        self._n = n
        self._output_frequency = output_every
        self._postprocessing_frequency = output_every
        self.set_solver_class(ProjectionSolver)

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._cavity_bcs = \
            lid_driven_cavity_setup(self._n)

    def set_boundary_conditions(self):
        self._bcs = self._cavity_bcs

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(
            Re=SOLVER["re"])

    def set_initial_conditions(self):
        self._initial_conditions = {"velocity": (0.0, 0.0)}

    def postprocess_solution(self):
        self._add_to_field_output(self._compute_vorticity())


class Instrumented:
    """Mixin for a Problem: the host clock over steps ``warm`` ..
    ``warm + steps`` of the time loop (synchronised at both ends), the
    time of each field-output write, and a torch.profiler window over the
    ``profile`` steps after that, in which the matvecs of every _pcg call
    are counted (iterations per solve)."""

    def instrument(self, warm, steps, profile):
        self._clock = {"warm": warm, "steps": steps, "profile": profile,
                       "writes": [], "t0": None, "t1": None, "prof": None,
                       "iters": []}
        self._n_max_steps = warm + steps + profile

    def _set_next_step_size(self):
        c, k = self._clock, self._time_stepping.step_number
        if k == c["warm"]:
            torch.cuda.synchronize()
            c["t0"] = time.perf_counter()
        elif k == c["warm"] + c["steps"]:
            torch.cuda.synchronize()
            c["t1"] = time.perf_counter()
            self._start_profile()
        super()._set_next_step_size()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        c = self._clock
        launch = planar_step._pcg

        def counted(matvec, *args, **kw):
            calls = [0]

            def mv(v):
                calls[0] += 1
                return matvec(v)

            out = launch(mv, *args, **kw)
            c["iters"].append(calls[0] - 1)
            return out

        c["pcg"] = launch
        planar_step._pcg = counted
        c["prof"] = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        c["prof"].__enter__()

    def finish_profile(self):
        """Close the profiler window; its per-step figures."""
        from torch.autograd import DeviceType

        c = self._clock
        torch.cuda.synchronize()
        c["prof"].__exit__(None, None, None)
        planar_step._pcg = c["pcg"]
        device, launches, syncs = 0.0, 0, 0
        for e in c["prof"].key_averages():
            # the program's phase ranges are drawn on the device's
            # timeline too: not device work
            if e.device_type == DeviceType.CUDA and \
                    not e.is_user_annotation:
                device += getattr(e, "self_device_time_total", None) or \
                    getattr(e, "self_cuda_time_total", 0.0)
                launches += e.count
            if e.key == "aten::_local_scalar_dense":
                syncs += e.count
        n = c["profile"]
        iters = np.asarray(c["iters"]).reshape(n, -1)
        return {"steps": n, "device_ms_per_step": device / n / 1e3,
                "device_ops_per_step": launches / n,
                "host_syncs_per_step": syncs / n,
                "iterations_per_solve_mean": iters.mean(axis=0).tolist(),
                "iterations_per_solve_max": iters.max(axis=0).tolist()}

    def write_profile_table(self, smi, profile_dir, filename, title):
        """The profiler window as a table (as write_profile writes)."""
        os.makedirs(profile_dir, exist_ok=True)
        table = self._clock["prof"].key_averages().table(
            sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, filename), "w") as f:
            f.write(f"{smi}\n{self._clock['profile']} steps, {title}\n"
                    f"{table}")

    def _write_xdmf_file(self, current_time=0.0):
        t0 = time.perf_counter()
        super()._write_xdmf_file(current_time)
        self._clock["writes"].append(time.perf_counter() - t0)

    def ms_per_step(self):
        c = self._clock
        return 1e3 * (c["t1"] - c["t0"]) / c["steps"]


class InstrumentedCavity(Instrumented, CavityProblem):
    pass


class InstrumentedDFG(Instrumented, DFGBenchmark2D2Projection):
    pass


def run_quietly(problem):
    """``problem.solve_problem()`` with its per-step printing sent to a
    buffer; returns the number of lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        problem.solve_problem()
    return buf.getvalue().count("\n")


def output_files(directory):
    """The field-output files under ``directory``: names and total bytes."""
    files = sorted(os.listdir(directory))
    return {"files": len(files), "bytes": sum(
        os.path.getsize(os.path.join(directory, f)) for f in files),
        "formats": sorted({os.path.splitext(f)[1] for f in files})}


def phase_problem_cavity(dev, smi, cavity_ms, profile_dir):
    """The cavity as an application; returns its launch counts."""
    n, n_steps = PROBLEMS["cavity_n"], PROBLEMS["cavity_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        problem = InstrumentedCavity(
            tmp, n, 0, PROBLEMS["output_every"], device=dev,
            dtype=torch.float32,
            solver_options={"cg_rtol": SOLVER["cg_rtol"]})
        problem.instrument(N_WARMUP, n_steps, N_BUSY)
        cuda_band.reset_launch_counts()
        t0 = time.perf_counter()
        lines = run_quietly(problem)
        busy = problem.finish_profile()
        total = time.perf_counter() - t0
        launches = dict(cuda_band.LAUNCHES)
        out = output_files(os.path.join(tmp, "results"))
        solver = problem._get_solver()
        guards = cavity_guards(solver, "problem_cavity")
        if profile_dir:
            problem.write_profile_table(smi, profile_dir,
                                        "profile_problem_cavity.txt",
                                        f"lid-driven cavity {n}^2 f32, "
                                        "application")
    ms = problem.ms_per_step()
    writes = problem._clock["writes"]
    steps = N_WARMUP + n_steps + N_BUSY
    emit({"phase": "problem_cavity",
          "config": f"lid-driven cavity {n}^2 f32 as an InstationaryProblem"
                    f": Re {SOLVER['re']:g}, ProjectionSolver, amg, cg_rtol "
                    f"{SOLVER['cg_rtol']:g}, CFL every step, vorticity and "
                    f"PVD output every {PROBLEMS['output_every']} steps",
          "step_kind": solver._step_kind, "n_dofs": solver.space.n_dofs,
          "steps_timed": n_steps, "ms_per_step": ms,
          "dof_steps_per_s": 1e3 * solver.space.n_dofs / ms,
          "solver_cavity_ms_per_step": cavity_ms,
          "application_ms_per_step": None if cavity_ms is None
          else ms - cavity_ms,
          "output_writes": len(writes),
          "output_ms_per_write": 1e3 * statistics.mean(writes),
          "output": out, "busy": dict(busy, busy_share=busy[
              "device_ms_per_step"] / ms),
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "stdout_lines": lines, "guards": guards,
          "seconds_total": total,
          "setup_seconds": setup_seconds(solver), "nvidia_smi": smi})
    if solver._step_kind != "fast":
        raise AssertionError(f"problem_cavity: step_kind "
                             f"{solver._step_kind!r}")
    if len(writes) != 1 + (N_WARMUP + n_steps + N_BUSY) \
            // PROBLEMS["output_every"] or out["formats"] != [".pvd", ".vtu"]:
        raise AssertionError(f"problem_cavity: {len(writes)} writes, "
                             f"files {out}")
    if launches["circulant_apply"] <= 0:
        raise AssertionError("problem_cavity launched no circulant_apply")
    return launches


def dfg_seeded_solver(seed_path, ckpt_path):
    """A ProjectionSolver class that starts from the saturated state in
    ``seed_path`` (the JAX package's dof order, which the port's space
    shares): ``set_initial_conditions`` takes the hook's (zero) data, then
    loads a checkpoint written from the state with io/checkpoint."""

    class Seeded(ProjectionSolver):
        def set_initial_conditions(self, initial_conditions):
            super().set_initial_conditions(initial_conditions)
            with np.load(seed_path) as d:
                u, u_old, p = d["u"], d["u_old"], d["p"]
            space = self.space
            want = PROBLEMS["dfg_dofs"]
            if (space.n_velocity_dofs, space.n_pressure_dofs) != want \
                    or (len(u), len(p)) != want:
                raise AssertionError(
                    f"dfg seed: space ({space.n_velocity_dofs}, "
                    f"{space.n_pressure_dofs}), state ({len(u)}, {len(p)}),"
                    f" expected {want}")
            x, x_old = np.concatenate([u, p]), np.concatenate([u_old, p])
            state = types.SimpleNamespace(
                _solutions=[x, x_old, x_old], _u=u, _u_old=u_old,
                _u_old2=u_old, _p=p, _phi=np.zeros_like(p))
            save_checkpoint(ckpt_path, state, self._time_stepping)
            load_checkpoint(ckpt_path, self, self._time_stepping)

    return Seeded


def crossing_frequency(t, y):
    """Frequency of ``y`` from the mean spacing of the sign changes of
    y - mean(y), each located by linear interpolation."""
    yc = y - y.mean()
    i = np.nonzero(np.signbit(yc[:-1]) != np.signbit(yc[1:]))[0]
    tc = t[i] - yc[i] * (t[i + 1] - t[i]) / (yc[i + 1] - yc[i])
    if len(tc) < 2:
        raise AssertionError("dfg: c_L changes sign fewer than twice")
    return 0.5 / float(np.mean(np.diff(tc)))


def dfg_summary(coefficients, window):
    """Raw window maxima of c_D and c_L and the Strouhal number of the
    harmonic fit of c_L (diameter 1, mean inflow 1).  The fit starts from
    the zero-crossing frequency of the whole run: an FFT of a few periods
    resolves frequency only to 1 / window."""
    from navierstokes_tpu_torch.utils.signal import periodic_fit

    series = np.asarray(coefficients)
    win = series[series[:, 0] > series[-1, 0] - window]
    f0 = crossing_frequency(series[:, 0], series[:, 2])
    fit_l = periodic_fit(win[:, 0], win[:, 2], f0=f0, refine=0.1)
    fit_d = periodic_fit(win[:, 0], win[:, 1], f0=2.0 * fit_l["freq"],
                         refine=0.02)
    return {"cd_max": float(win[:, 1].max()),
            "cl_max": float(win[:, 2].max()),
            "strouhal": fit_l["freq"], "strouhal_crossings": f0,
            "cd_max_fit": fit_d["max"],
            "cl_max_fit": fit_l["max"], "samples": len(win),
            "finite": bool(np.isfinite(series).all())}


def phase_dfg(dev, smi, profile_dir):
    """DFG 2D-2 at resolution 3 through the application layer; returns
    its launch counts."""
    dt, n_steps = PROBLEMS["dfg_dt"], PROBLEMS["dfg_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        problem = InstrumentedDFG(
            tmp, end_time=1.0e6, resolution=PROBLEMS["dfg_res"], dt=dt,
            device=dev, dtype=torch.float32,
            solver_options={"cg_rtol": SOLVER["cg_rtol"]})
        problem.set_solver_class(dfg_seeded_solver(
            PROBLEMS["dfg_seed"], os.path.join(tmp, "seed.npz")))
        problem._write_output = False
        problem.instrument(N_WARMUP, n_steps - N_WARMUP - N_BUSY, N_BUSY)
        mesh_t = {}
        setup_mesh = problem.setup_mesh

        def timed_mesh():
            t = time.perf_counter()
            setup_mesh()
            mesh_t["mesh"] = time.perf_counter() - t

        problem.setup_mesh = timed_mesh
        cuda_band.reset_launch_counts()
        lines = run_quietly(problem)
        busy = problem.finish_profile()
        total = time.perf_counter() - t0
        launches = dict(cuda_band.LAUNCHES)
    solver = problem._get_solver()
    ms = problem.ms_per_step()
    t_read = time.perf_counter()
    coeffs = problem.materialize_coefficients()
    t_read = time.perf_counter() - t_read
    summary = dfg_summary(coeffs, PROBLEMS["dfg_window"])
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        np.savetxt(os.path.join(profile_dir, "dfg_forces.csv"),
                   np.asarray(coeffs), delimiter=",", header="t,c_D,c_L")
    amg =solver._fast_step.static["p_precond"].__self__
    emit({"phase": "dfg",
          "config": f"DFG 2D-2 (Re 100) resolution {PROBLEMS['dfg_res']:g} "
                    f"symmetric mesh, f32, dt {dt:g}, {n_steps} steps from "
                    f"{PROBLEMS['dfg_seed']} (saturated, t = 315; loaded "
                    "with io/checkpoint), ProjectionSolver, amg, cg_rtol "
                    f"{SOLVER['cg_rtol']:g}, force every step",
          "n_dofs": solver.space.n_dofs, "step_kind": solver._step_kind,
          "operators": engine_formats(solver._fast),
          "amg_rows_per_level": [lv["dinv"].numel() for lv in amg.levels]
          + [amg.coarse_inv.shape[0]],
          "steps": len(coeffs), "ms_per_step": ms,
          "dof_steps_per_s": 1e3 * solver.space.n_dofs / ms,
          "busy": dict(busy, busy_share=busy["device_ms_per_step"] / ms),
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "force_read_seconds": t_read, "stdout_lines": lines,
          "summary": summary, "guards": DFG_GUARDS,
          "setup_seconds": dict(setup_seconds(solver), **mesh_t),
          "seconds_total": total, "nvidia_smi": smi})
    if solver._step_kind != "fast" or len(coeffs) != n_steps:
        raise AssertionError(f"dfg: step_kind {solver._step_kind!r}, "
                             f"{len(coeffs)} force samples")
    if not summary["finite"]:
        raise AssertionError("dfg: non-finite forces")
    for key, (lo, hi) in DFG_GUARDS.items():
        if not lo <= summary[key] <= hi:
            raise AssertionError(f"dfg: {key} {summary[key]} outside "
                                 f"[{lo}, {hi}]")
    if profile_dir:
        problem.write_profile_table(smi, profile_dir, "profile_dfg.txt",
                                    "DFG 2D-2 resolution 3 f32, "
                                    "application")
    return launches


def resumed_solver(path):
    """A ProjectionSolver class that starts from the checkpoint at
    ``path`` (written by a Problem's ``write_checkpoint``)."""

    class Resumed(ProjectionSolver):
        def set_initial_conditions(self, initial_conditions):
            super().set_initial_conditions(initial_conditions)
            load_checkpoint(path, self, self._time_stepping)

    return Resumed


def dfg_run(device, n_steps, resume=None, checkpoint_dir=None):
    """The DFG application at PROBLEMS['parity_res'] in f64 up to step
    ``n_steps``, from rest or from the checkpoint ``resume``: (u, p, forces)
    on the host and the launch counts.  With ``checkpoint_dir`` the run
    writes its last step's checkpoint there."""
    with tempfile.TemporaryDirectory() as tmp:
        problem = DFGBenchmark2D2Projection(
            checkpoint_dir or tmp, end_time=1.0e6, n_max_steps=n_steps,
            resolution=PROBLEMS["parity_res"], dt=PROBLEMS["dfg_dt"],
            device=device, dtype=torch.float64)
        problem._write_output = False
        if resume:
            problem.set_solver_class(resumed_solver(resume))
        if checkpoint_dir:
            problem._checkpoint_frequency = n_steps
        cuda_band.reset_launch_counts()
        run_quietly(problem)
        launches = dict(cuda_band.LAUNCHES)
    solver = problem._get_solver()
    u, p = solver.space.split(solver.solution.cpu())
    forces = torch.tensor(np.asarray(problem.materialize_coefficients()))
    return u, p, forces, launches


def phase_dfg_parity(dev):
    """f64 card against CPU (and a second card run) of the DFG application
    over PROBLEMS['parity_steps'] steps from a checkpoint that the CPU
    writes after PROBLEMS['parity_warm_steps'] steps from rest; returns
    the first card run's launch counts.  The warm start takes the
    comparison past the impulsive start, whose pressure peaks at
    max|p| ~ 4.5e3 in step 1 and relaxes to ~ 3 by step 10: the absolute
    roundoff gap of those first steps (~ 1e-10 between any two summation
    orders) would otherwise be read against the relaxed pressure.  From
    the warm start p still differs by ~ 5e-13 between two summation orders
    on this graded mesh (the JAX package against the port on the CPU), so
    both the max-norm and the 2-norm relative errors are held to 1e-12."""
    warm, n_steps = PROBLEMS["parity_warm_steps"], PROBLEMS["parity_steps"]
    seconds = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dfg_run("cpu", warm, checkpoint_dir=tmp)
        path = os.path.join(tmp, "results",
                            "DFGBenchmark2D2Projection_checkpoint.npz")
        a, b, c = (dfg_run(where, warm + n_steps, resume=path)
                   for where in (dev, dev, "cpu"))
    seconds = time.perf_counter() - seconds
    if len(c[2]) != n_steps:
        raise AssertionError(f"dfg_parity: {len(c[2])} force samples")
    keys = ("u", "p", "forces")
    errs = {k: rel_err(a[i], c[i]) for i, k in enumerate(keys)}
    errs_l2 = {k: float(torch.linalg.vector_norm(a[i] - c[i])
                        / torch.linalg.vector_norm(c[i]))
               for i, k in enumerate(keys)}
    bitwise = all(torch.equal(a[i], b[i]) for i in range(3))
    emit({"phase": "dfg_parity", "steps": n_steps, "warm_steps_cpu": warm,
          "dtype": "float64", "resolution": PROBLEMS["parity_res"],
          "rel_err_max": errs, "rel_err_l2": errs_l2,
          "rerun_bitwise": bitwise, "launches": a[3], "seconds": seconds})
    for norm, table in (("max-norm", errs), ("2-norm", errs_l2)):
        for key, err in table.items():
            if not err <= 1e-12:
                raise AssertionError(f"dfg_parity {key}: relative {norm} "
                                     f"error {err} > 1e-12")
    if not bitwise:
        raise AssertionError("dfg_parity: a second card run differs")
    return a[3]


# ---------------------------------------------------------------------------
# group "newton": the stationary and monolithic solvers, f64 on the card
# ---------------------------------------------------------------------------

# newton_cavity at 64^2: cut from 128^2 (155-199 s of host-bound
# PCD-FGMRES on an H100 at 700 W) and then from 96^2 (86.7 s) to keep the
# whole script inside its time limit with the multidevice and apps
# groups; Ghia's centre-line minimum holds at 64^2 (-0.2080 on the CPU)
NEWTON = {"dfg_res": 3.0, "cavity_n": 64, "cavity_re": 100.0,
          "bdf_res": 3.0, "bdf_dt": 0.005, "bdf_steps": 100,
          "bdf_seed": "benchmarks/states/dfg_2d2_state_mono_res3_sym.npz",
          "parity_n": 12, "parity_steps": 5,
          "parity_restart": 20}
# Schafer & Turek (1996) intervals, and the JAX package's f64 figures on
# the resolution-3 mesh (docs/VALIDATION.md) with their allowances
NEWTON_DFG_GUARDS = {"cd": (5.57, 5.59), "cl": (0.0104, 0.0110),
                     "cd_ref": (5.5796, 1e-3), "cl_ref": (0.010636, 2e-5)}
# the committed monolithic series' envelope over its last 5 time units,
# 3.1608-3.2230 / -1.0134-0.9789, widened slightly
BDF_GUARDS = {"cd": (3.155, 3.230), "cl": (-1.02, 0.99)}
# Ghia et al. (1982): u_x minimum on the vertical centre line at Re 100
GHIA_UMIN = (-0.2109, 0.006)
# FGMRES iterations in the profiled restart cycle of newton_cavity
PCD_PROFILE_ITERATIONS = 10


class StageTimer:
    """Wall seconds per stage, each stage closed by a device
    synchronisation so that it holds the device work it queued."""

    def __init__(self):
        self.seconds = {}

    def run(self, label, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def wrap(self, obj, name, label):
        """Time every call of ``obj.name`` under ``label``."""
        fn = getattr(obj, name)
        setattr(obj, name, lambda *a, **k: self.run(label, fn, *a, **k))

    def summary(self):
        """Per stage: calls, total, mean, the first call and the median of
        the later ones (the first may hold one-time setup)."""
        return {k: {"calls": len(v), "total_s": sum(v),
                    "mean_ms": 1e3 * sum(v) / len(v),
                    "first_ms": 1e3 * v[0],
                    "rest_median_ms": (1e3 * statistics.median(v[1:])
                                       if len(v) > 1 else None)}
                for k, v in self.seconds.items()}


@contextlib.contextmanager
def timed_host_lu(timer):
    """``solvers.stationary`` factors through a HostSparseLU whose copy
    off the card, SuperLU factorization and solves are timed apart."""
    from navierstokes_tpu_torch.linalg import direct
    from navierstokes_tpu_torch.solvers import stationary

    class TimedLU(direct.HostSparseLU):
        def __init__(self, csr):
            t0 = time.perf_counter()
            super().__init__(csr)
            timer.seconds.setdefault("splu", []).append(
                time.perf_counter() - t0 - timer.seconds["csr_copy"][-1])

        @staticmethod
        def host_matrix(csr):
            return timer.run("csr_copy", direct.HostSparseLU.host_matrix,
                             csr)

        def solve(self, b):
            return timer.run("lu_solve", super().solve, b)

    saved = stationary.HostSparseLU
    stationary.HostSparseLU = TimedLU
    try:
        yield
    finally:
        stationary.HostSparseLU = saved


def count_syncs(fn):
    """``(fn(), n)``: the number of synchronizing CUDA calls it made, as
    torch's sync debug mode reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def dfg_steady_solver(res, device, **kw):
    """DFG 2D-1 (Re = 20) configured as benchmarks/dfg_2d1_steady.py:
    the inflow 4 Um s (1 - s) with Um = 0.3, visc 0.01, no outflow
    condition."""
    mesh, markers, bm = channel_with_cylinder(res)

    def inlet(x):
        s = x[:, 1] / H_DFG
        return np.stack([1.2 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    solver = StationarySolver(mesh, markers, device=device,
                              dtype=torch.float64, **kw)
    solver.set_boundary_conditions(
        ((VelocityBCType.function, bm["inlet"], inlet),
         (VelocityBCType.no_slip, bm["cylinder"], None),
         (VelocityBCType.no_slip, bm["upper wall"], None),
         (VelocityBCType.no_slip, bm["lower wall"], None)))
    solver.set_equation_coefficients({"convective_term": 1.0,
                                      "viscous_term": 0.01,
                                      "pressure_term": 1.0})
    return solver, bm


def nonlinear_record(solver):
    return dict(solver.monitor.last("nonlinear_solve"))


def phase_newton_dfg(dev, smi, profile_dir):
    """DFG 2D-1 at resolution 3 through the Picard->Newton solver with the
    Jacobian assembled on the card and factored by SuperLU on the host."""
    g = NEWTON_DFG_GUARDS
    cuda_band.reset_launch_counts()
    t0 = time.perf_counter()
    solver, bm = dfg_steady_solver(NEWTON["dfg_res"], dev, tol=1e-10,
                                   linear_solver="host_lu")
    solver._setup_problem()
    setup_s = time.perf_counter() - t0
    timer = StageTimer()
    op = solver.operator
    timer.wrap(op, "jacobian_csr", "jacobian_assembly")
    timer.wrap(op, "residual", "residual")
    t0 = time.perf_counter()
    with timed_host_lu(timer), contextlib.redirect_stdout(io.StringIO()):
        solver.solve()
    solve_s = time.perf_counter() - t0
    launches = dict(cuda_band.LAUNCHES)
    rec = nonlinear_record(solver)
    force = 50.0 * np.asarray(solver.boundary_reaction_force(bm["cylinder"]))
    cd, cl = float(force[0]), float(force[1])
    its = rec["picard_iterations"] + rec["newton_iterations"]
    stages = timer.summary()
    out = {"phase": "newton_dfg",
           "config": f"DFG 2D-1 Re 20, resolution {NEWTON['dfg_res']:g}, "
                     "f64, StationarySolver(tol=1e-10, "
                     "linear_solver='host_lu')",
           "dofs": solver.space.n_dofs, "cells": solver._n_cells,
           "nnz": op.pattern.nnz,
           "picard_iterations": rec["picard_iterations"],
           "newton_iterations": rec["newton_iterations"],
           "residual": rec["residual"], "c_D": cd, "c_L": cl,
           "seconds": {"setup": setup_s, "solve": solve_s},
           "per_iteration_ms": {
               "jacobian_assembly":
                   stages["jacobian_assembly"]["rest_median_ms"],
               "jacobian_assembly_first":
                   stages["jacobian_assembly"]["first_ms"],
               "csr_copy_to_host": stages["csr_copy"]["mean_ms"],
               "splu_s": stages["splu"]["total_s"] / stages["splu"]["calls"],
               "lu_solve": stages["lu_solve"]["mean_ms"],
               "residual": stages["residual"]["mean_ms"]},
           "stages": stages, "launches": launches, "nvidia_smi": smi}
    if profile_dir:
        x = solver.solution

        def one_iteration():
            with contextlib.redirect_stdout(io.StringIO()):
                solver._linear_step(x, *solver._residual_context()[1:],
                                    picard=False)

        write_profile(one_iteration, smi, profile_dir,
                      "profile_newton_dfg.txt",
                      "one Newton iteration of newton_dfg (Jacobian on the "
                      "card, SuperLU on the host)", n=1)
    emit(out)
    bad = [not rec["residual"] <= 1e-10, its != stages["splu"]["calls"],
           not g["cd"][0] <= cd <= g["cd"][1],
           not g["cl"][0] <= cl <= g["cl"][1],
           not abs(cd - g["cd_ref"][0]) <= g["cd_ref"][1],
           not abs(cl - g["cl_ref"][0]) <= g["cl_ref"][1]]
    if any(bad):
        raise AssertionError(f"newton_dfg guards failed: {bad}")
    return launches


class NewtonCavity(cavity_flow.CavityProblem):
    """demo/cavity_flow.py's problem (the port's demo class) at ``n``^2
    cells and Reynolds number ``re``."""

    def __init__(self, main_dir, n, re, **kw):
        super().__init__(n, main_dir, **kw)
        self._re = re

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=self._re)


@contextlib.contextmanager
def timed_pcd_setup(seconds):
    """Record the seconds of every MatrixFreePCD construction (its AMG
    hierarchies are built on the host)."""
    from navierstokes_tpu_torch.linalg import block_precond

    saved = block_precond.MatrixFreePCD

    class Timed(saved):
        def __init__(self, *a, **k):
            t0 = time.perf_counter()
            super().__init__(*a, **k)
            seconds.append(time.perf_counter() - t0)

    block_precond.MatrixFreePCD = Timed
    try:
        yield
    finally:
        block_precond.MatrixFreePCD = saved


def gather_table(name, table, pad):
    """Rows, padded width K and mean row length of a padded gather table
    whose empty slots hold ``pad``."""
    rows, width = table.shape
    filled = int((table != pad).sum())
    return {"table": name, "rows": int(rows), "K": int(width),
            "mean_row": filled / max(rows, 1)}


def pcd_gather_tables(ctx):
    """The gather tables that one PCD-FGMRES inner iteration reads: each
    AMG level's operator (dense levels listed as such) and restriction,
    and the mixed operator's cell-to-node segment sums."""
    out = []
    for amg_name, amg in (("amg_p", ctx.amg), ("amg_u", ctx.amg_u)):
        for k, lvl in enumerate(amg.levels):
            A = lvl["A"]
            if hasattr(A, "cols"):
                out.append(gather_table(f"{amg_name}[{k}].A", A.cols,
                                        A.n_cols))
            else:
                out.append({"table": f"{amg_name}[{k}].A (dense)",
                            "rows": A.n_rows, "K": A.n_cols,
                            "mean_row": float(A.n_cols)})
            seg = lvl["restrict"]
            out.append(gather_table(f"{amg_name}[{k}].restrict", seg.table,
                                    int(np.prod(seg.index_shape))))
    for name in ("_scatter_u", "_scatter_p"):
        seg = getattr(ctx.op, name)
        out.append(gather_table(f"op.{name[1:]}", seg.table,
                                int(np.prod(seg.index_shape))))
    return out


def gather_forms_ms(cols, k):
    """Median ms (CUDA events) of three ways to gather the rows of an
    (n + 1, k) f64 tensor through the padded table ``cols``: advanced
    indexing of its rows, ``index_select`` on the flat table, and one
    gather per column of the transposed tensor (the port's form,
    ``utils.segment.padded_row_sum``)."""
    n_pad = int(cols.max()) + 1
    xp = torch.randn(n_pad, k, dtype=torch.float64, device=cols.device)
    xt = xp.T.contiguous()
    flat = cols.reshape(-1)
    forms = {"index": lambda: xp[cols],
             "index_select": lambda: torch.index_select(xp, 0, flat).view(
                 cols.shape + (k,)),
             "per_column": lambda: xt[:, cols]}
    if not torch.equal(forms["index"](), forms["index_select"]()):
        raise AssertionError("index_select gathered other values")
    return {name: time_ms(fn) for name, fn in forms.items()}


def profile_pcd_cycle(solver, smi, profile_dir):
    """torch.profiler tables (by device time, by host time and by input
    shape) of one short Newton restart cycle of the solver's PCD-FGMRES
    context, linearized at its solution with the initial state's
    residual as right-hand side."""
    from torch.profiler import ProfilerActivity, profile

    op, scalars, source, bc_values, extra = solver._residual_context()
    x = solver.solution
    x0 = solver._apply_bc_values_to_x(torch.zeros_like(x))
    rhs = -op.residual(x0, bc_values, scalars, source, extra)
    ctx = solver._pcd_ctx
    # a short cycle: the profiler's tables of the 80-iteration cycle (1.6 M
    # ops) take minutes to build, and every iteration repeats the same ops
    restart, ctx.restart = ctx.restart, PCD_PROFILE_ITERATIONS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            _, _, its = ctx.solve(x, rhs, scalars, source, picard=False,
                                  tol=1e-12, max_cycles=1)
            torch.cuda.synchronize()
    finally:
        ctx.restart = restart
    seconds = time.perf_counter() - t0
    events = prof.key_averages()
    aten_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    os.makedirs(profile_dir, exist_ok=True)
    with open(os.path.join(profile_dir, "profile_newton_cavity.txt"),
              "w") as f:
        f.write(f"{smi}\none Newton restart cycle of newton_cavity "
                f"(PCD-FGMRES, {its} iterations, {seconds:.3f} s profiled, "
                f"{aten_ops} aten ops)\n")
        f.write(events.table(sort_by="cuda_time_total", row_limit=25))
        f.write("\n")
        f.write(events.table(sort_by="cpu_time_total", row_limit=25))
        f.write("\nby input shape:\n")
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="cuda_time_total", row_limit=25))


def phase_newton_cavity(dev, smi, profile_dir):
    """The cavity demo as a StationaryProblem at 64^2 with the card's own
    linear mode: matrix-free PCD + FGMRES + AMG, no factorization."""
    n, re = NEWTON["cavity_n"], NEWTON["cavity_re"]
    cuda_band.reset_launch_counts()
    amg_s = []
    with tempfile.TemporaryDirectory() as tmp:
        problem = NewtonCavity(tmp, n, re, device=dev, dtype=torch.float64)
        problem._write_output = False
        t0 = time.perf_counter()
        with timed_pcd_setup(amg_s), contextlib.redirect_stdout(
                io.StringIO()):
            _, syncs = count_syncs(problem.solve_problem)
        seconds = time.perf_counter() - t0
    launches = dict(cuda_band.LAUNCHES)
    solver = problem._get_solver()
    mode = solver._resolved_linear_mode()
    solves = [r for r in solver.monitor.records
              if r["kind"] == "nonlinear_solve"]
    # StationaryProblem falls back to a Reynolds continuation when its
    # first solve raises; the phase holds the first solve alone
    if len(solves) != 1:
        raise AssertionError(
            f"newton_cavity: {len(solves)} nonlinear solves on record: the "
            f"first solve at Re {re:g} did not converge and the Reynolds "
            "continuation ran")
    rec = dict(solves[0])
    lin = [r["iterations"] for r in solver.monitor.records
           if r["kind"] == "linear_solve"]
    u, _ = solver.space.split(solver.solution)
    u = u.cpu().numpy()
    centre = np.abs(solver.space.u_coords[:, 0] - 0.5) < 1e-9
    u_min = float(u[centre, 0].min())
    steps = rec["picard_iterations"] + rec["newton_iterations"]
    # the velocity AMG's finest operator: the largest gather of the cycle
    level0 = solver._pcd_ctx.amg_u.levels[0]["A"]
    out = {"phase": "newton_cavity",
           "config": f"lid-driven cavity {n}^2 Re {re:g} f64 as a "
                     "StationaryProblem (demo/cavity_flow.py), the card's "
                     "default linear mode",
           "dofs": solver.space.n_dofs, "linear_mode": mode,
           "picard_iterations": rec["picard_iterations"],
           "newton_iterations": rec["newton_iterations"],
           "residual": rec["residual"], "u_min_centre_line": u_min,
           "fgmres_matvecs_per_linear_solve": lin,
           "fgmres_matvecs_per_newton_step":
               sum(lin[rec["picard_iterations"]:])
               / max(rec["newton_iterations"], 1),
           "host_syncs": syncs, "host_syncs_per_linearized_step":
               syncs / max(steps, 1),
           "amg_setup_s": amg_s, "seconds": seconds,
           "gather_tables": pcd_gather_tables(solver._pcd_ctx),
           "level0_gather_ms": (gather_forms_ms(level0.cols,
                                                solver.space.dim)
                                if hasattr(level0, "cols") else None),
           "launches": launches, "nvidia_smi": smi}
    if profile_dir:
        profile_pcd_cycle(solver, smi, profile_dir)
    emit(out)
    bad = [mode != "pcd", not rec["residual"] <= 1e-10,
           len(lin) != steps,
           not abs(u_min - GHIA_UMIN[0]) <= GHIA_UMIN[1]]
    if any(bad):
        raise AssertionError(f"newton_cavity guards failed: {bad}")
    return launches


def dfg_monolithic_solver(device):
    """DFG 2D-2 through ImplicitBDFSolver as benchmarks/dfg_monolithic.py
    runs it: resolution 3, do-nothing outflow, frozen LU, tol 1e-6, the
    BDF-2 ring seeded from the committed saturated state."""
    res, dt = NEWTON["bdf_res"], NEWTON["bdf_dt"]
    mesh, markers, bm = channel_with_cylinder(res)

    def inlet(x):
        s = x[:, 1] / H_DFG
        return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    with np.load(NEWTON["bdf_seed"]) as d:
        if float(d["resolution"]) != res:
            raise AssertionError("bdf_dfg: seed resolution mismatch")
        t0 = float(d["t"])
        u, u_old, p = (np.asarray(d[k], np.float64)
                       for k in ("u", "u_old", "p"))
    ts = BDFTimeStepping(t0, t0 + 1.0e6, desired_start_time_step=dt)
    solver = ImplicitBDFSolver(mesh, markers, "standard", ts, tol=1e-6,
                               linear_solver="frozen_lu", device=device,
                               dtype=torch.float64)
    solver.set_boundary_conditions(
        ((VelocityBCType.function, bm["inlet"], inlet),
         (VelocityBCType.no_slip, bm["cylinder"], None),
         (VelocityBCType.no_slip, bm["upper wall"], None),
         (VelocityBCType.no_slip, bm["lower wall"], None)))
    solver.set_equation_coefficients({"convective_term": 1.0,
                                      "viscous_term": 0.01,
                                      "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    x_now = solver._tensor(np.concatenate([u, p]))
    x_prev = solver._tensor(np.concatenate([u_old, p]))
    solver._solutions[0] = solver._solutions[1] = x_now
    solver._solutions[2] = x_prev
    return solver, ts, bm["cylinder"]


def phase_bdf_dfg(dev, smi, profile_dir):
    """DFG 2D-2 through the monolithic BDF-2 solver on the card, 100 steps
    with the reaction force every step."""
    n_steps, dt = NEWTON["bdf_steps"], NEWTON["bdf_dt"]
    cuda_band.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        solver, ts, cyl = dfg_monolithic_solver(dev)
    setup_s = time.perf_counter() - t0
    series = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ts.update_coefficients()
        solver.solve()
        force = solver.boundary_reaction_force(cyl)
        series.append((ts.next_time, 2.0 * float(force[0]),
                       2.0 * float(force[1])))
        ts.advance_time()
        solver.advance_time()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_band.LAUNCHES)
    its = [r["iterations"] for r in solver.monitor.records
           if r["kind"] == "nonlinear_solve"]
    ms = 1e3 * elapsed / n_steps
    busy = solver_busy(solver, ts, ms)
    arr = np.asarray(series)
    out = {"phase": "bdf_dfg",
           "config": f"DFG 2D-2 Re 100 resolution {NEWTON['bdf_res']:g} "
                     f"f64 through ImplicitBDFSolver(frozen_lu, tol=1e-6), "
                     f"dt {dt:g}, seeded at t = {arr[0, 0] - dt:g}",
           "dofs": solver.space.n_dofs, "steps": n_steps,
           "ms_per_step": ms,
           "dof_steps_per_s": n_steps * solver.space.n_dofs / elapsed,
           "newton_iterations_per_step": float(np.mean(its[:n_steps])),
           "newton_iterations_max": int(max(its[:n_steps])),
           "lu_factorizations": solver.lu_factorizations,
           "c_D_range": [float(arr[:, 1].min()), float(arr[:, 1].max())],
           "c_L_range": [float(arr[:, 2].min()), float(arr[:, 2].max())],
           "setup_s": setup_s, "busy": busy, "launches": launches,
           "nvidia_smi": smi}
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        np.savetxt(os.path.join(profile_dir, "bdf_dfg_forces.csv"), arr,
                   delimiter=",", header="t,c_D,c_L")
        write_profile(lambda: advance(solver, ts), smi, profile_dir,
                      "profile_bdf_dfg.txt",
                      "monolithic BDF-2 steps of bdf_dfg (frozen LU)")
    emit(out)
    g = BDF_GUARDS
    bad = [not (g["cd"][0] <= arr[:, 1].min()
                and arr[:, 1].max() <= g["cd"][1]),
           not (g["cl"][0] <= arr[:, 2].min()
                and arr[:, 2].max() <= g["cl"][1]),
           len(its) < n_steps]
    if any(bad):
        raise AssertionError(f"bdf_dfg guards failed: {bad}")
    return launches


def cavity_transient(cls_name, scheme, device, n, steps, **kw):
    """The lid-driven cavity at Re 100 from rest through one transient
    solver, ``steps`` steps of 0.02."""
    from navierstokes_tpu_torch import solvers, timestepping

    mesh, markers, bcs = lid_driven_cavity_setup(n)
    if cls_name == "ThetaSolver":
        ts = timestepping.GeneralThetaTimeStepping(
            0.0, 1.0, getattr(timestepping.ThetaTimeSteppingType, scheme),
            desired_start_time_step=0.02)
    elif cls_name == "IMEXSolver":
        ts = timestepping.IMEXTimeStepping(
            0.0, 1.0, getattr(timestepping.IMEXType, scheme),
            desired_start_time_step=0.02)
    else:
        ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.02)
    solver = getattr(solvers, cls_name)(mesh, markers, "standard", ts,
                                        device=device, dtype=torch.float64,
                                        **kw)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients({"convective_term": 1.0,
                                      "viscous_term": 0.01,
                                      "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    advance(solver, ts, steps)
    return solver


def cavity_stationary(mode, device, n):
    mesh, markers, bcs = lid_driven_cavity_setup(n)
    solver = StationarySolver(mesh, markers, linear_solver=mode,
                              device=device, dtype=torch.float64)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients({"convective_term": 1.0,
                                      "viscous_term": 0.01,
                                      "pressure_term": 1.0})
    solver.solve()
    return solver


def phase_newton_parity(dev):
    """f64, the card against the CPU at 12^2: the stationary solver in
    its three linear modes and 5 steps of each transient solver; a second
    card run of every direct path must repeat the first bit for bit."""
    n, steps = NEWTON["parity_n"], NEWTON["parity_steps"]
    cases = {"stationary_dense": (True, "dense"),
             "stationary_host_lu": (True, "host_lu"),
             "stationary_pcd": (False, "pcd"),
             "bdf_host_lu": (True, ("ImplicitBDFSolver", None,
                                    {"linear_solver": "host_lu"})),
             "bdf_frozen_lu": (True, ("ImplicitBDFSolver", None,
                                      {"linear_solver": "frozen_lu"})),
             "theta_crank_nicolson": (True, ("ThetaSolver", "CrankNicolson",
                                             {"linear_solver": "host_lu"})),
             "imex_sbdf2": (True, ("IMEXSolver", "SBDF2",
                                   {"linear_solver": "host_lu"})),
             "ipcs": (False, ("IPCSSolver", None, {}))}
    cuda_band.reset_launch_counts()
    out, bad = {}, []
    saved = os.environ.get("NS_TPU_FGMRES_RESTART")
    # restart cycles of 20: the default 80 costs the CPU side minutes
    os.environ["NS_TPU_FGMRES_RESTART"] = str(NEWTON["parity_restart"])
    try:
        for name, (direct, spec) in cases.items():
            t0 = time.perf_counter()
            runs = []
            for where in ((dev, dev, "cpu") if direct else (dev, "cpu")):
                with contextlib.redirect_stdout(io.StringIO()):
                    runs.append(
                        cavity_stationary(spec, where, n)
                        if isinstance(spec, str) else
                        cavity_transient(spec[0], spec[1], where, n, steps,
                                         **spec[2]))
            counts = [[r.get("iterations") for r in s.monitor.records
                       if r["kind"] == "nonlinear_solve"] for s in runs]
            card, cpu = runs[0].solution.cpu(), runs[-1].solution
            err = rel_err(card, cpu)
            row = {"rel_err": err, "newton_counts_equal":
                   counts[0] == counts[-1], "seconds":
                   time.perf_counter() - t0}
            if direct:
                row["rerun_bitwise"] = bool(torch.equal(
                    runs[0].solution, runs[1].solution))
            out[name] = row
            tol = 1e-10 if direct else 1e-8
            if not err <= tol or counts[0] != counts[-1] or \
                    not row.get("rerun_bitwise", True):
                bad.append(name)
    finally:
        if saved is None:
            os.environ.pop("NS_TPU_FGMRES_RESTART")
        else:
            os.environ["NS_TPU_FGMRES_RESTART"] = saved
    launches = dict(cuda_band.LAUNCHES)
    emit({"phase": "newton_parity",
          "config": f"cavity {n}^2 Re 100 f64, card vs CPU; transient "
                    f"solvers {steps} steps of 0.02; pcd restart "
                    f"{NEWTON['parity_restart']}",
          "cases": out, "launches": launches})
    if bad:
        raise AssertionError(f"newton_parity failed: {bad}")
    return launches


# ---------------------------------------------------------------------------
# group mesh3d: the 3D banded engine, the cell-loop step, the external mesh
# workflow and the stationary demos of the rest of the mesh layer
# ---------------------------------------------------------------------------

# the sizes of the mesh3d phases.  The duct at (18, 6, 6) cells approaches
# its steady state by a factor of about 0.978 per step of 0.05 (the same
# digits on the card and on the CPU): 5.7e-6 from the exact profile after
# 100 steps, 6.6e-7 after 200, so it runs 200.  ``shell_guard`` bounds the
# deviation of
# u_phi on the equatorial plane from the Stokes solution, relative to
# Omega r_i: the port's own CPU run at the same size, steps and step size
# reads 4.88e-4 in f64 from t = 1.25 on (the Re = 1 convection and the
# discretization), so twice that, rounded up
MESH3D = {"cavity_n": MESH3D_KERNEL_N, "cavity_re": 100.0, "cavity_steps": 20,
          "kernel_steps": 20, "kernel_cg_iters": (18, 300, 10),
          "duct": (18, 6, 6), "duct_steps": 200, "shell_n": 16,
          "shell_dt": 0.025, "shell_steps": 60, "shell_guard": 1.0e-3,
          "parity_cavity_n": 6,
          "parity_shell_n": 6, "parity_steps": 10}
SHELL_RE = 1.0
SHELL_RADII = (0.5, 1.0)


def make_cavity3d(n, device, dtype, **kw):
    """The 3D lid-driven cavity (tests/test_3d_solver.py's boundary
    conditions) at n^3 cells and Re MESH3D["cavity_re"] through
    ProjectionSolver; dt = 0.25 / (2 n), from rest."""
    mesh, markers, bcs = lid_driven_cavity_setup(n, dim=3)
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=0.25 / (2 * n))
    solver = ProjectionSolver(mesh, markers, "standard", ts, device=device,
                              dtype=dtype, **kw)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / MESH3D["cavity_re"],
         "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0, 0.0)})
    return solver, ts


def cavity3d_guards(solver, name):
    """Finite state; lid nodes (inside the top face) at (1, 0, 0) and the
    other wall nodes at 0, each to 1e-6."""
    x = solver.solution
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: non-finite state")
    u, _ = solver.space.split(x)
    div_l2 = solver.operator.divergence_l2(u)
    u = u.double().cpu().numpy()
    c = solver.space.u_coords
    on = (np.abs(c) < 1e-12) | (np.abs(c - 1.0) < 1e-12)
    lid = on[:, 1] & (c[:, 1] > 0.5)
    inner_lid = lid & ~on[:, 0] & ~on[:, 2]
    walls = on.any(axis=1) & ~lid
    lid_err = float(np.abs(u[inner_lid] - [1.0, 0.0, 0.0]).max())
    wall_err = float(np.abs(u[walls]).max())
    if not (lid_err <= 1e-6 and wall_err <= 1e-6):
        raise AssertionError(f"{name}: lid error {lid_err}, wall error "
                             f"{wall_err} > 1e-6")
    return {"lid_err": lid_err, "wall_err": wall_err, "div_l2": div_l2,
            "u_max": float(np.abs(u).max())}


def phase_cavity3d(dev, smi, profile_dir):
    """The 3D lid-driven cavity at 24^3 through ProjectionSolver on the
    banded engine, f32, the solver's default tolerances; returns (solver,
    ts, launches)."""
    n, n_steps = MESH3D["cavity_n"], MESH3D["cavity_steps"]
    t0 = time.perf_counter()
    solver, ts = make_cavity3d(n, dev, torch.float32)
    t_ic = time.perf_counter() - t0
    # the first step builds the space, the engine and the AMG hierarchy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    advance(solver, ts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    if solver._step_kind != "fast":
        raise AssertionError(f"cavity3d: step_kind {solver._step_kind!r}, "
                             "expected 'fast'")
    fast = solver._fast
    # the kernels phase's synthetic 3D cases have this engine's shapes
    if tuple(fast.M.offsets) != box_offsets(n, 2) or \
            tuple(fast.L.offsets) != box_offsets(n, 1):
        raise AssertionError("cavity3d: band offsets differ from the "
                             "kernels phase's 3D cases")
    elapsed, launches = timed_steps(solver, ts, n_steps)
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * elapsed / n_steps
    res = residual_records(solver)
    if res.shape != (1 + N_WARMUP + n_steps, 3) or \
            not np.isfinite(res).all():
        raise AssertionError("cavity3d: residual records missing or "
                             "non-finite")
    guards = cavity3d_guards(solver, "cavity3d")
    busy = solver_busy(solver, ts, ms)
    space = solver.space
    emit({"phase": "cavity3d",
          "config": f"lid-driven cavity {n}^3 f32 (P2: {2 * n + 1}^3 "
                    f"velocity nodes), Re {MESH3D['cavity_re']:g}, dt "
                    f"{0.25 / (2 * n):g}, the solver's defaults (amg, "
                    "cg_iters (40, 40, 20), cg_rtol 1e-8: below f32 "
                    "roundoff, so the solves run to their caps)",
          "step_kind": solver._step_kind, "n_dofs": space.n_dofs,
          "operators": engine_formats(fast), "steps_timed": n_steps,
          "seconds": elapsed, "ms_per_step": ms,
          "dof_steps_per_s": n_steps * space.n_dofs / elapsed,
          "launches_per_step": {k: v / (N_WARMUP + n_steps)
                                for k, v in launches.items()},
          "busy": busy, "peak_device_bytes": peak,
          "residuals_last": res[-1].tolist(),
          "residuals_max": res.max(axis=0).tolist(), "guards": guards,
          "setup_seconds": dict(setup_seconds(solver),
                                through_initial_conditions=t_ic,
                                first_step=t_first),
          "nvidia_smi": smi})
    if launches["circulant_apply"] <= 0:
        raise AssertionError("cavity3d launched no circulant_apply")
    if profile_dir:
        write_profile(lambda: advance(solver, ts), smi, profile_dir,
                      "profile_cavity3d.txt",
                      f"lid-driven cavity {n}^3 f32, solver API")
    return solver, ts, launches


def phase_cavity3d_kernels(solver, ts, smi):
    """cavity3d's engine with fixed iterations, no preconditioner and no
    tolerance: the step ``ProjectionSolver(..., cg_rtol=None,
    poisson_precond=None, cg_iters=...)`` builds, set on the same solver
    so the 24^3 host setup runs once.  Every solve is one circulant_pcg
    launch.  Returns (launches, solve rows, apply rows, max abs error)."""
    n_steps = MESH3D["kernel_steps"]
    old = solver._fast_step
    v_free, v_vals, p_free = old.masks
    solver._fast_step = build_planar_projection_step(
        solver._fast, visc=solver._visc, dt=float(solver._next_step_size),
        cg_iters=MESH3D["kernel_cg_iters"],
        vel_bc=((v_free == 0).cpu().numpy(), v_vals.cpu().numpy()),
        pres_bc_mask=None if p_free is None else
        (p_free == 0).cpu().numpy(),
        conv_coeff=solver._conv_coeff, cg_rtol=None, with_residuals=True)
    elapsed, launches = timed_steps(solver, ts, n_steps)
    steps = N_WARMUP + n_steps
    if launches["circulant_pcg"] != 3 * steps:
        raise AssertionError(
            f"cavity3d_kernels: {launches['circulant_pcg']} circulant_pcg "
            f"launches in {steps} steps, expected 3 per step")
    guards = cavity3d_guards(solver, "cavity3d_kernels")
    subs = record_subsolves(lambda: advance(solver, ts))
    routes = {k: pcg_route(v) for k, v in subs.items()}
    if routes != {"helmholtz": "grid-streamed", "poisson": "cluster",
                  "mass": "grid-streamed"}:
        raise AssertionError(f"cavity3d_kernels: sub-solve routes {routes}")
    solves, err_max, failed = {}, 0.0, []
    for name, case in subs.items():
        solves[name], ok, err = pcg_solve_row(case, torch.float32)
        err_max = max(err_max, err)
        if not ok:
            failed.append(name)
    fast = solver._fast
    applies = {"M_b3": apply_row(fast.M, 3, fast.device, 9),
               "L_b1": apply_row(fast.L, 1, fast.device, 10)}
    emit({"phase": "cavity3d_kernels",
          "config": f"cavity3d's engine, cg_rtol None, no preconditioner, "
                    f"cg_iters {MESH3D['kernel_cg_iters']}",
          "step_kind": solver._step_kind, "steps_timed": n_steps,
          "ms_per_step": 1e3 * elapsed / n_steps,
          "dof_steps_per_s": n_steps * solver.space.n_dofs / elapsed,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "guards": guards, "solves": solves, "applies": applies,
          "unit": "ms", "nvidia_smi": smi})
    if failed:
        raise AssertionError(f"cavity3d_kernels: {failed} disagree with "
                             "their plain versions")
    return launches, solves, applies, err_max


def make_duct(device, dtype, n_points):
    """tests/test_3d_solver.py's duct through ProjectionSolver: cg_iters
    (60, 600, 30), cg_rtol 1e-12, dt 0.05, visc 0.1, from rest."""
    mesh, markers, bcs = duct_setup(n_points)
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=0.05)
    solver = ProjectionSolver(mesh, markers, "standard", ts, device=device,
                              dtype=dtype, cg_iters=(60, 600, 30),
                              cg_rtol=1e-12)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients({"convective_term": 1.0,
                                      "viscous_term": 0.1,
                                      "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0, 0.0)})
    return solver, ts


def phase_duct3d(dev, smi):
    """Plane Poiseuille flow in the 3D duct (f64): after the steps the
    state is the exact profile to 1e-6."""
    n_steps = MESH3D["duct_steps"]
    t0 = time.perf_counter()
    solver, ts = make_duct(dev, torch.float64, MESH3D["duct"])
    cuda_band.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    advance(solver, ts)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    advance(solver, ts, n_steps - 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_band.LAUNCHES)
    space = solver.space
    u, _ = space.split(solver.solution)
    err = float(np.abs(u.cpu().numpy()
                       - duct_profile(space.u_coords)).max())
    ms = 1e3 * seconds / (n_steps - 1)
    emit({"phase": "duct3d",
          "config": f"duct {MESH3D['duct']} cells f64, plane Poiseuille, "
                    "no-normal-flux side walls, cg_rtol 1e-12, dt 0.05",
          "step_kind": solver._step_kind, "n_dofs": space.n_dofs,
          "operators": engine_formats(solver._fast), "steps": n_steps,
          "ms_per_step": ms,
          "dof_steps_per_s": (n_steps - 1) * space.n_dofs / seconds,
          "max_err_vs_exact": err,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "busy": solver_busy(solver, ts, ms), "peak_device_bytes": peak,
          "setup_seconds": dict(setup_seconds(solver),
                                through_first_step=t_setup),
          "nvidia_smi": smi})
    if solver._step_kind != "fast" or not err < 1e-6:
        raise AssertionError(f"duct3d: step_kind {solver._step_kind!r}, "
                             f"error {err} (needs 'fast' and < 1e-6)")
    if launches["circulant_apply"] <= 0:
        raise AssertionError("duct3d launched no circulant_apply")
    return launches


def make_shell(n, device, dtype, dt, **kw):
    """Spherical Couette flow on spherical_shell(3, SHELL_RADII, n): the
    inner sphere turning at Omega = 1 about z, Re = Omega r_i^2 / nu."""
    mesh, markers, bcs = spherical_couette_setup(n, SHELL_RADII)
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=dt)
    solver = ProjectionSolver(mesh, markers, "standard", ts, device=device,
                              dtype=dtype, **kw)
    solver.set_boundary_conditions(bcs)
    solver.set_equation_coefficients(
        {"convective_term": 1.0,
         "viscous_term": SHELL_RADII[0] ** 2 / SHELL_RE,
         "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0, 0.0)})
    return solver, ts


def shell_deviation(solver):
    """Largest |u_phi - u_phi(Stokes)| over the velocity nodes on the
    equatorial plane z = 0, relative to Omega r_i, and the node count."""
    u, _ = solver.space.split(solver.solution)
    u = u.double().cpu().numpy()
    x = solver.space.u_coords
    eq = np.abs(x[:, 2]) < 1e-9
    stokes = spherical_couette_stokes(x[eq], SHELL_RADII)
    rho = np.hypot(x[eq, 0], x[eq, 1])

    def phi(v):
        return (-x[eq, 1] * v[:, 0] + x[eq, 0] * v[:, 1]) / rho

    dev = np.abs(phi(u[eq]) - phi(stokes)).max() / SHELL_RADII[0]
    return float(dev), int(eq.sum())


def phase_shell3d(dev, smi, profile_dir):
    """Spherical Couette flow on a shell that no banded format holds in
    f32: one fastop_fallback record, the cell-loop step, and near the
    steady state u_phi on the equatorial plane against the Stokes
    solution."""
    n, n_steps = MESH3D["shell_n"], MESH3D["shell_steps"]
    t0 = time.perf_counter()
    solver, ts = make_shell(n, dev, torch.float32, MESH3D["shell_dt"])
    cuda_band.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    advance(solver, ts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    fallbacks = [r for r in solver.monitor.records
                 if r["kind"] == "fastop_fallback"]
    if solver._step_kind != "generic" or len(fallbacks) != 1:
        raise AssertionError(
            f"shell3d: step_kind {solver._step_kind!r} after "
            f"{len(fallbacks)} fastop_fallback records (expected 'generic' "
            "after one)")
    t2 = time.perf_counter()
    advance(solver, ts, n_steps - 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_band.LAUNCHES)
    ms = 1e3 * elapsed / (n_steps - 1)
    # the state after n_steps, for halo_shell's comparison
    state = (solver._u.clone(), solver._p.clone())
    busy = solver_busy(solver, ts, ms)
    deviation, n_eq = shell_deviation(solver)
    res = residual_records(solver)
    space = solver.space
    emit({"phase": "shell3d",
          "config": f"spherical Couette flow, spherical_shell(3, "
                    f"{SHELL_RADII}, {n}) f32, Re {SHELL_RE:g}, dt "
                    f"{MESH3D['shell_dt']}, the solver's defaults",
          "step_kind": solver._step_kind,
          "fastop_fallback": fallbacks[0]["reason"],
          "n_cells": space.mesh.n_cells, "n_dofs": space.n_dofs,
          "steps": n_steps, "t_end": ts.current_time, "ms_per_step": ms,
          "dof_steps_per_s": (n_steps - 1) * space.n_dofs / elapsed,
          "busy": busy, "peak_device_bytes": peak,
          "residuals_last": res[-1].tolist(),
          "u_phi_deviation_vs_stokes": deviation,
          "equatorial_nodes": n_eq, "guard": MESH3D["shell_guard"],
          "launches": launches,
          "setup_seconds": dict(setup_seconds(solver),
                                through_initial_conditions=t1 - t0,
                                first_step=t_first),
          "nvidia_smi": smi})
    if not np.isfinite(res).all() or \
            not deviation <= MESH3D["shell_guard"]:
        raise AssertionError(f"shell3d: u_phi deviation {deviation} > "
                             f"{MESH3D['shell_guard']} or non-finite "
                             "residuals")
    if profile_dir:
        write_profile(lambda: advance(solver, ts), smi, profile_dir,
                      "profile_shell3d.txt",
                      f"spherical Couette flow, shell n = {n}, cell loop")
    return launches, state


class BackwardFacingStep(backward_facing_step.BackwardFacingStepProblem):
    """demo/backward_facing_step.py's problem (the port's demo class) on
    its built-in mesh or on a mesh passed in."""

    def __init__(self, main_dir, mesh=None, **kw):
        super().__init__(main_dir, **kw)
        self._given_mesh = mesh

    def setup_mesh(self):
        if self._given_mesh is None:
            super().setup_mesh()
        else:
            self._mesh, self._boundary_markers, \
                self._boundary_marker_map = self._given_mesh


def solve_stationary(problem, name):
    """Run ``problem`` quietly; raise unless its first solve converged (one
    nonlinear_solve record: no Reynolds continuation).  Returns (solver,
    record, seconds)."""
    problem._write_output = False
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        problem.solve_problem()
    seconds = time.perf_counter() - t0
    solver = problem._get_solver()
    solves = [r for r in solver.monitor.records
              if r["kind"] == "nonlinear_solve"]
    if len(solves) != 1:
        raise AssertionError(f"{name}: {len(solves)} nonlinear solves on "
                             "record: the first solve did not converge and "
                             "the Reynolds continuation ran")
    return solver, dict(solves[0]), seconds


def boundary_flux(solver, marker):
    """Outward flux of u through the facets marked ``marker``: Simpson's
    rule on each straight P2 edge (2D), exact for P2."""
    space = solver.space
    mesh = space.mesh
    u, _ = space.split(solver.solution)
    u = u.double().cpu().numpy()
    fids = solver._boundary_markers.ids_with_value(marker)
    ends = space._u_node_map[mesh.facets[fids]]            # (nf, 2)
    mids = space._u_node_map[mesh.n_vertices + fids]      # edge == facet
    pts = mesh.points[mesh.facets[fids]]
    length = np.linalg.norm(pts[:, 1] - pts[:, 0], axis=1)
    normal = mesh.facet_outward_normals(fids)

    def un(nodes):
        return np.einsum("fd,fd->f", u[nodes], normal)

    return float(np.sum(length / 6.0 * (un(ends[:, 0]) + un(ends[:, 1])
                                         + 4.0 * un(mids))))


def recirculation_length(solver):
    """Length of the recirculation behind the step (x = 2): where u_x on
    the lowest row of velocity nodes above the floor turns positive,
    minus 2."""
    u, _ = solver.space.split(solver.solution)
    u = u.double().cpu().numpy()
    x = solver.space.u_coords
    ys = np.unique(np.round(x[:, 1], 12))
    row = (np.abs(x[:, 1] - ys[1]) < 1e-12) & (x[:, 0] > 2.0)
    order = np.argsort(x[row, 0])
    xs, ux = x[row, 0][order], u[row, 0][order]
    back = np.nonzero(ux < 0.0)[0]
    if len(back) == 0:
        return 0.0
    i = back[-1]
    if i + 1 >= len(xs):
        return float(xs[-1] - 2.0)
    # linear interpolation of the sign change
    t = ux[i] / (ux[i] - ux[i + 1])
    return float(xs[i] + t * (xs[i + 1] - xs[i]) - 2.0)


def xdmf_round_trip(mesh, markers):
    """Write and read back ``mesh`` through the inline-XML branch of
    mesh/xdmf_io.py (the card's machine has no h5py); True when every
    array comes back equal."""
    saved = xdmf_io._h5py
    xdmf_io._h5py = lambda: None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mesh.xdmf")
            xdmf_io.write_xdmf_mesh(path, mesh, facet_markers=markers)
            inline = not os.path.exists(path[:-5] + ".h5")
            m2, k2 = xdmf_io.read_xdmf_mesh(path)
    finally:
        xdmf_io._h5py = saved
    return inline and all(np.array_equal(getattr(mesh, a), getattr(m2, a))
                          for a in ("points", "cells", "facets")) \
        and np.array_equal(markers.facet_ids, k2.facet_ids) \
        and np.array_equal(markers.values, k2.values)


def bfs_problem(device, mesh=None):
    return BackwardFacingStep(None, mesh=mesh, device=device,
                              dtype=torch.float64,
                              solver_options={"linear_solver": "host_lu"})


def phase_bfs(dev, smi):
    """demo/backward_facing_step.py's StationaryProblem on the card (f64,
    host LU) on the built-in mesh and on the shipped gmsh mesh; returns
    (launches, the built-in mesh's solver)."""
    cuda_band.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, solvers = {}, {}
    geo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshes",
                       "backward_facing_step.geo")
    for name, mesh in (("builtin", None), ("gmsh", read_geo_msh(geo))):
        problem = bfs_problem(dev, mesh)
        solver, rec, seconds = solve_stationary(problem, f"bfs {name}")
        bm = problem._boundary_marker_map
        q_in = -boundary_flux(solver, bm["inlet"])
        q_out = boundary_flux(solver, bm["outlet"])
        solvers[name] = solver
        out[name] = {"n_cells": solver.space.mesh.n_cells,
                     "n_dofs": solver.space.n_dofs, "seconds": seconds,
                     "picard_iterations": rec["picard_iterations"],
                     "newton_iterations": rec["newton_iterations"],
                     "residual": rec["residual"], "inflow": q_in,
                     "outflow": q_out,
                     "flux_rel_err": abs(q_out - q_in) / abs(q_in),
                     "recirculation_length": recirculation_length(solver),
                     "xdmf_inline_round_trip": xdmf_round_trip(
                         solver.space.mesh, solver._boundary_markers)}
    launches = dict(cuda_band.LAUNCHES)
    emit({"phase": "bfs",
          "config": "backward-facing step, Re 50, f64, StationaryProblem "
                    "(demo/backward_facing_step.py), linear_solver host_lu",
          "meshes": out, "launches": launches,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": smi})
    bad = [name for name, o in out.items()
           if not (o["flux_rel_err"] <= 1e-8 and o["residual"] <= 1e-10
                   and o["xdmf_inline_round_trip"])]
    if bad:
        raise AssertionError(f"bfs guards failed on {bad}")
    return launches, solvers["builtin"]


def phase_blasius(dev, smi):
    """demo/blasius_flow.py's StationaryProblem on the card (f64, host
    LU)."""
    cuda_band.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    problem = blasius_flow.BlasiusFlowProblem(
        None, device=dev, dtype=torch.float64,
        solver_options={"linear_solver": "host_lu"})
    solver, rec, seconds = solve_stationary(problem, "blasius")
    u, _ = solver.space.split(solver.solution)
    u = u.double().cpu().numpy()
    x = solver.space.u_coords
    plate = (np.abs(x[:, 1] - 0.5) < 1e-12) & (x[:, 0] > -1e-12) \
        & (x[:, 0] < 1 + 1e-12)
    launches = dict(cuda_band.LAUNCHES)
    out = {"phase": "blasius",
           "config": "flat plate, Re 200, f64, StationaryProblem "
                     "(demo/blasius_flow.py), linear_solver host_lu",
           "n_dofs": solver.space.n_dofs, "seconds": seconds,
           "picard_iterations": rec["picard_iterations"],
           "newton_iterations": rec["newton_iterations"],
           "residual": rec["residual"],
           "plate_velocity_max": float(np.abs(u[plate]).max()),
           "u_x_max": float(u[:, 0].max()), "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "nvidia_smi": smi}
    emit(out)
    if not (rec["residual"] <= 1e-10 and out["plate_velocity_max"] <= 1e-12
            and np.isfinite(u).all()):
        raise AssertionError(f"blasius guards failed: {out}")
    return launches


def phase_mesh3d_parity(dev, smi, bfs_card):
    """f64, the card against the CPU: 10 steps of the 3D cavity at 6^3 on
    the banded path, 10 cell-loop steps on the shell at n = 6 (forced by a
    band budget no format meets), and the backward-facing step's
    stationary solution."""
    steps = MESH3D["parity_steps"]
    cuda_band.reset_launch_counts()
    out = {}
    for name, build in (
            ("cavity3d", lambda d: make_cavity3d(
                MESH3D["parity_cavity_n"], d, torch.float64)),
            ("shell_cell_loop", lambda d: make_shell(
                MESH3D["parity_shell_n"], d, torch.float64, 0.05))):
        saved = os.environ.get("NS_FASTOP_MAX_BYTES")
        if name == "shell_cell_loop":
            os.environ["NS_FASTOP_MAX_BYTES"] = "1e4"
        try:
            runs = []
            for where in (dev, "cpu"):
                solver, ts = build(where)
                advance(solver, ts, steps)
                runs.append(solver)
        finally:
            if saved is None:
                os.environ.pop("NS_FASTOP_MAX_BYTES", None)
            else:
                os.environ["NS_FASTOP_MAX_BYTES"] = saved
        kinds = [s._step_kind for s in runs]
        out[name] = {"step_kind": kinds[0],
                     "u": rel_err(runs[0]._u, runs[1]._u),
                     "p": rel_err(runs[0]._p, runs[1]._p)}
        want = "fast" if name == "cavity3d" else "generic"
        if kinds != [want, want]:
            raise AssertionError(f"mesh3d_parity {name}: step kinds {kinds}")
    launches = dict(cuda_band.LAUNCHES)
    cpu, _, _ = solve_stationary(bfs_problem("cpu"), "bfs (CPU)")
    out["bfs"] = {"x": rel_err(bfs_card.solution, cpu.solution)}
    emit({"phase": "mesh3d_parity",
          "config": f"f64, card vs CPU: cavity {MESH3D['parity_cavity_n']}^3 "
                    f"and the shell n = {MESH3D['parity_shell_n']} (cell "
                    f"loop) {steps} steps each, the backward-facing step's "
                    "stationary solution",
          "rel_err": out, "launches": launches, "nvidia_smi": smi})
    bad = [k for k in ("cavity3d", "shell_cell_loop")
           if not max(out[k]["u"], out[k]["p"]) <= 1e-12]
    if not out["bfs"]["x"] <= 1e-10:
        bad.append("bfs")
    if bad:
        raise AssertionError(f"mesh3d_parity failed: {bad}")
    return launches


# the multidevice group: shards of one card (device_mesh(n) puts shard i
# on cuda:(i % device_count): every shard on cuda:0 on one card); the
# shell and its steps are shell3d's, the spectral case structured2d's, the
# stationary cavity newton_cavity's at 64^2 (its one-device solve at 128^2
# alone took 155-199 s on an H100 at 700 W), the parity cases small and f64
MULTIDEVICE = {"shards": 4, "shell_tol": 1e-3, "spectral_n": 128,
               "spectral_steps": 200, "spectral_tol": 1e-5,
               "stationary_n": 64, "stationary_re": 100.0,
               "stationary_tol": 1e-10, "parity_box_n": 6,
               "parity_shell_n": 6, "parity_steps": 5,
               "parity_cg_iters": (20, 60, 10), "parity_spectral": (16, 8),
               "parity_cavity_n": 16, "parity_tol": 1e-12}


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while active, and among them the
    reads of a device scalar (``item()``, ``float()``): each one a host
    synchronisation."""

    def __init__(self):
        super().__init__()
        self.ops = self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def shard_mesh(dev, n=None):
    """``device_mesh(n)`` over the cards (the CPU's n shards for a CPU
    ``dev``)."""
    n = MULTIDEVICE["shards"] if n is None else n
    return device_mesh(n) if dev.type == "cuda" else device_mesh(n,
                                                                 device=dev)


def mesh_info(mesh):
    """What every multidevice line prints about its mesh."""
    return {"shards": len(mesh),
            "physical_devices": [str(d) for d in mesh.physical_devices],
            "device_names": [torch.cuda.get_device_name(d)
                             if d.type == "cuda" else str(d)
                             for d in mesh.physical_devices]}


def state_diff(solver, ref):
    """Largest |u - u_ref| and |p - p_ref| relative to max |.| of the
    reference."""
    return {"u": rel_err(solver._u, ref[0]), "p": rel_err(solver._p, ref[1])}


def worst(errs):
    """The largest of ``errs``, or inf if any is not finite."""
    errs = list(errs)
    return max(errs) if all(math.isfinite(e) for e in errs) else math.inf


def phase_halo_shell(dev, smi, reference):
    """shell3d's case through ProjectionSolver(device_mesh=...): the
    domain-decomposed halo step on the shell's full size, held to
    shell3d's u_phi guard and to the one-device cell-loop state after the
    same steps (``reference``: shell3d's (u, p), or None to run it)."""
    n, n_steps = MESH3D["shell_n"], MESH3D["shell_steps"]
    mesh = shard_mesh(dev)
    cuda_band.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, ts = make_shell(n, dev, torch.float32, MESH3D["shell_dt"],
                            device_mesh=mesh)
    t1 = time.perf_counter()
    advance(solver, ts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    if solver._step_kind != "halo":
        raise AssertionError(f"halo_shell: step_kind {solver._step_kind!r}, "
                             "expected 'halo'")
    hops = solver._hops
    bytes0 = hops.halo_bytes
    t2 = time.perf_counter()
    advance(solver, ts, n_steps - 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated()
    halo_bytes = (hops.halo_bytes - bytes0) / (n_steps - 1)
    ms = 1e3 * elapsed / (n_steps - 1)
    if reference is None:
        one, one_ts = make_shell(n, dev, torch.float32, MESH3D["shell_dt"])
        advance(one, one_ts, n_steps)
        reference = (one._u, one._p)
        del one, one_ts
    diff = state_diff(solver, reference)
    res = residual_records(solver)
    # one more step under an op counter: torch.profiler took 41-58 s to
    # trace one step of this path (~34,000 device ops) beside an H100
    counter = OpCounter()
    with counter:
        advance(solver, ts)
    torch.cuda.synchronize()
    deviation, n_eq = shell_deviation(solver)
    launches = dict(cuda_band.LAUNCHES)
    space = solver.space
    emit({"phase": "halo_shell",
          "config": f"shell3d's spherical Couette flow (spherical_shell(3, "
                    f"{SHELL_RADII}, {n}) f32, dt {MESH3D['shell_dt']}) "
                    f"through ProjectionSolver(device_mesh=device_mesh("
                    f"{len(mesh)}))",
          **mesh_info(mesh), "step_kind": solver._step_kind,
          "n_dofs": space.n_dofs, "steps": n_steps, "ms_per_step": ms,
          "dof_steps_per_s": (n_steps - 1) * space.n_dofs / elapsed,
          "halo_report": hops.halo_report(),
          "halo_bytes_per_step": halo_bytes,
          "aten_ops_per_step": counter.ops,
          "host_syncs_per_step": counter.reads,
          "peak_device_bytes": peak, "residuals_last": res[-1].tolist(),
          "u_phi_deviation_vs_stokes": deviation, "guard":
              MESH3D["shell_guard"], "equatorial_nodes": n_eq,
          "vs_one_device_cell_loop": diff,
          "vs_one_device_tol": MULTIDEVICE["shell_tol"],
          "t_end": ts.current_time, "launches": launches,
          "setup_seconds": dict(setup_seconds(solver),
                                through_initial_conditions=t1 - t0,
                                first_step=t_first),
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    if not np.isfinite(res).all() or \
            not deviation <= MESH3D["shell_guard"]:
        raise AssertionError(f"halo_shell: u_phi deviation {deviation} > "
                             f"{MESH3D['shell_guard']} or non-finite "
                             "residuals")
    if not worst(diff.values()) <= MULTIDEVICE["shell_tol"]:
        raise AssertionError(f"halo_shell: {diff} from the one-device cell "
                             f"loop > {MULTIDEVICE['shell_tol']}")
    return launches


def phase_spectral_sharded(dev, smi):
    """Taylor-Green 128^2 (structured2d's case) through
    ProjectionSolver(device_mesh=...) on the slab-sharded spectral step,
    beside the unsharded solver in the same run."""
    n, n_steps = MULTIDEVICE["spectral_n"], MULTIDEVICE["spectral_steps"]
    t_start = time.perf_counter()
    mesh = shard_mesh(dev)
    cuda_band.reset_launch_counts()
    runs = {}
    for name, kw in (("sharded", {"device_mesh": mesh}), ("one_device", {})):
        torch.cuda.reset_peak_memory_stats()
        solver, ts = make_solver("periodic", n, dev, torch.float32, **kw)
        elapsed, _ = timed_steps(solver, ts, n_steps)
        u, _ = solver.space.split(solver.solution)
        expected = math.exp(-2.0 * (1.0 / RE) * (2.0 * math.pi) ** 2
                            * ts.current_time)
        runs[name] = {"solver": solver,
                      "step_kind": solver._step_kind,
                      "ms_per_step": 1e3 * elapsed / n_steps,
                      "dof_steps_per_s": n_steps * solver.space.n_dofs
                      / elapsed,
                      "amp_rel_err": abs(float(u.abs().max()) - expected)
                      / expected,
                      "finite": bool(torch.isfinite(solver.solution).all()),
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
    launches = dict(cuda_band.LAUNCHES)
    sharded = runs["sharded"].pop("solver")
    one = runs["one_device"].pop("solver")
    diff = state_diff(sharded, (one._u, one._p))
    slabs = len(sharded._spectral_state)
    emit({"phase": "spectral_sharded",
          "config": f"taylor-green {n}^2 f32, Re {RE:g}, dt {DT:g}, through "
                    f"ProjectionSolver(device_mesh=device_mesh({len(mesh)}))"
                    ", the slab-sharded spectral step, beside the unsharded "
                    "solver",
          **mesh_info(mesh), "slabs": slabs, "steps_timed": n_steps,
          "runs": runs, "vs_unsharded": diff,
          "vs_unsharded_tol": MULTIDEVICE["spectral_tol"],
          "launches": launches, "seconds": time.perf_counter() - t_start,
          "nvidia_smi": smi})
    bad = [runs["sharded"]["step_kind"] != "spectral", slabs != len(mesh),
           not runs["sharded"]["finite"],
           not runs["sharded"]["amp_rel_err"] < 0.05,
           not worst(diff.values()) <= MULTIDEVICE["spectral_tol"]]
    if any(bad):
        raise AssertionError(f"spectral_sharded guards failed: {bad}")
    return launches


def phase_stationary_sharded(dev, smi):
    """newton_cavity's problem at 64^2 through StationarySolver(
    device_mesh=...): the cell-sharded residual and Jacobian inside
    PCD-FGMRES (the default linear mode with a mesh), f64, beside the
    one-device solve in the same run."""
    from navierstokes_tpu_torch.parallel.sharded_mixed import \
        ShardedMixedOperator

    n, re = MULTIDEVICE["stationary_n"], MULTIDEVICE["stationary_re"]
    mesh = shard_mesh(dev)
    cuda_band.reset_launch_counts()
    out, solvers = {}, {}
    # "pcd" is the card's default mode with or without a mesh; named here
    # so that both runs take it on any device
    for name, opts in (("sharded", {"device_mesh": mesh,
                                    "linear_solver": "pcd"}),
                       ("one_device", {"linear_solver": "pcd"})):
        with tempfile.TemporaryDirectory() as tmp:
            problem = NewtonCavity(tmp, n, re, device=dev,
                                   dtype=torch.float64,
                                   solver_options=opts)
            problem._write_output = False
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                problem.solve_problem()
            seconds = time.perf_counter() - t0
        solver = problem._get_solver()
        solves = [r for r in solver.monitor.records
                  if r["kind"] == "nonlinear_solve"]
        lin = [r["iterations"] for r in solver.monitor.records
               if r["kind"] == "linear_solve"]
        out[name] = {"seconds": seconds, "nonlinear_solves": len(solves),
                     "linear_mode": solver._resolved_linear_mode(),
                     "picard_iterations": solves[0]["picard_iterations"],
                     "newton_iterations": solves[0]["newton_iterations"],
                     "residual": solves[-1]["residual"],
                     "fgmres_matvecs_per_linear_solve": lin}
        solvers[name] = solver
    launches = dict(cuda_band.LAUNCHES)
    sharded = solvers["sharded"]
    diff = rel_err(sharded.solution, solvers["one_device"].solution)
    emit({"phase": "stationary_sharded",
          "config": f"lid-driven cavity {n}^2 Re {re:g} f64 as a "
                    "StationaryProblem (newton_cavity's problem at 64^2) "
                    "with solver_options device_mesh=device_mesh("
                    f"{len(mesh)}), beside the one-device solve",
          **mesh_info(mesh), "dofs": sharded.space.n_dofs, "runs": out,
          "vs_one_device": diff,
          "vs_one_device_tol": MULTIDEVICE["stationary_tol"],
          "launches": launches, "nvidia_smi": smi})
    bad = [not isinstance(sharded._operator, ShardedMixedOperator),
           out["sharded"]["linear_mode"] != "pcd",
           # StationaryProblem falls back to a Reynolds continuation when
           # its first solve raises: the first solve must converge
           out["sharded"]["nonlinear_solves"] != 1,
           not out["sharded"]["residual"] <= 1e-10,
           not diff <= MULTIDEVICE["stationary_tol"]]
    if any(bad):
        raise AssertionError(f"stationary_sharded guards failed: {bad}")
    return launches


def dirichlet_masks(space, markers, bcs):
    """Full-length velocity mask and values, and the pressure mask (None
    for a mean-value pressure), of a case's boundary conditions."""
    from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs

    vel = [b for b in bcs if not isinstance(b[0], PressureBCType)]
    pres = [b for b in bcs if isinstance(b[0], PressureBCType)
            and b[0] is not PressureBCType.mean_value]
    vbc, _ = compile_dirichlet_bcs(space, markers, vel, [])
    vmask = np.zeros(space.n_velocity_dofs, bool)
    vmask[np.asarray(vbc.dofs, np.int64)] = True
    vvals = np.zeros(space.n_velocity_dofs)
    vvals[np.asarray(vbc.dofs, np.int64)] = np.asarray(vbc.values(0.0))
    pmask = None
    if pres:
        pbc, _ = compile_dirichlet_bcs(space, markers, [], pres)
        pmask = np.zeros(space.n_pnodes, bool)
        pmask[np.asarray(pbc.dofs, np.int64) - space.pressure_offset] = True
    return (vmask, vvals), pmask


def halo_steps(case, mesh, n_steps):
    """``n_steps`` halo steps from rest of a (space, masks, visc, dt) case
    over ``mesh`` in f64, fixed iterations; (u, p) in the space layout."""
    space, (vel_bc, pmask), visc, dt = case
    ops = HaloCellOperator(space, mesh, dtype=torch.float64)
    step = build_halo_projection_step(
        ops, visc=visc, dt=dt, cg_iters=MULTIDEVICE["parity_cg_iters"],
        vel_bc=vel_bc, pres_bc_mask=pmask)
    dev = mesh.devices[0]
    u = ops.pad_velocity(torch.zeros(space.n_velocity_dofs,
                                     dtype=torch.float64, device=dev))
    p = ops.pad_pressure(torch.zeros(space.n_pnodes, dtype=torch.float64,
                                     device=dev))
    phi, u_old = 0.0 * p, u
    for i in range(n_steps):
        u_new, p, phi = step(u, u_old, p, phi, ALPHAS[min(i, 1)],
                             ETAS[min(i, 1)])
        u_old, u = u, u_new
    return ops.unpad_velocity(u), ops.unpad_pressure(p)


def parity_row(card, card_again, cpu, one):
    """card vs CPU and 4 shards vs 1 (relative, max-norm; the worst over
    the fields, inf if any is not finite) of (u, p) pairs, and whether a
    second card run repeated the first bit for bit."""
    return {"card_vs_cpu": worst(rel_err(a, b) for a, b in zip(card, cpu)),
            "shards_vs_one": worst(rel_err(a, b) for a, b in zip(card, one)),
            "rerun_bitwise": all(torch.equal(a, b)
                                 for a, b in zip(card, card_again))}


def checkpoint_crossing(dev, mesh, directory):
    """The channel on ``mesh`` (halo) and on one device (banded), f64:
    sharded -> checkpoint -> one device -> checkpoint -> sharded, each
    reader holding the writer's state bit for bit; and a sharded run
    resumed from the first checkpoint equal to the unbroken run."""
    def state(s):
        return (s._u, s._u_old, s._p, s._phi)

    def fresh(**kw):
        s, ts = make_solver("channel", SOLVER["channel"], dev,
                            torch.float64, **kw)
        s._setup_problem()
        return s, ts

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(state(a), state(b)))

    a, ats = make_solver("channel", SOLVER["channel"], dev, torch.float64,
                         device_mesh=mesh)
    advance(a, ats, 3)
    first = os.path.join(directory, "sharded.npz")
    save_checkpoint(first, a, ats)
    one, one_ts = fresh()
    load_checkpoint(first, one, one_ts)
    to_one = same(one, a)
    advance(one, one_ts, 2)
    second = os.path.join(directory, "one.npz")
    save_checkpoint(second, one, one_ts)
    b, bts = fresh(device_mesh=mesh)
    load_checkpoint(second, b, bts)
    to_sharded = same(b, one)
    c, cts = fresh(device_mesh=mesh)
    load_checkpoint(first, c, cts)
    advance(a, ats, 2)
    advance(c, cts, 2)
    kinds = [a._step_kind, one._step_kind, b._step_kind]
    return {"step_kinds": kinds, "sharded_to_one_bitwise": to_one,
            "one_to_sharded_bitwise": to_sharded,
            "resumed_equals_unbroken_bitwise": same(a, c)}, \
        kinds == ["halo", "fast", "halo"]


def phase_multidevice_parity(dev, smi):
    """f64: each multi-device path on the card against the CPU and over 4
    shards against 1, a second card run bit for bit, and a checkpoint
    crossing between 4 shards and one device."""
    from navierstokes_tpu_torch.assembly.operators import MixedOperator
    from navierstokes_tpu_torch.parallel.sharded_mixed import \
        ShardedMixedOperator
    from navierstokes_tpu_torch.structured.spectral import \
        shard_spectral_step

    steps = MULTIDEVICE["parity_steps"]
    t_start = time.perf_counter()
    mesh, cpu_mesh = shard_mesh(dev), shard_mesh(torch.device("cpu"))
    one_mesh = shard_mesh(dev, 1)
    cuda_band.reset_launch_counts()
    rows = {}
    # the halo step: a 3D box (the lid-driven cavity) and the shell
    for name, (mesh_bcs, visc, dt) in {
            "halo_box3d": (lid_driven_cavity_setup(
                MULTIDEVICE["parity_box_n"], dim=3), 0.01, 0.02),
            "halo_shell": (spherical_couette_setup(
                MULTIDEVICE["parity_shell_n"], SHELL_RADII),
                SHELL_RADII[0] ** 2 / SHELL_RE, 0.05)}.items():
        t0 = time.perf_counter()
        m, markers, bcs = mesh_bcs
        space = TaylorHoodSpace(m)
        case = (space, dirichlet_masks(space, markers, bcs), visc, dt)
        rows[name] = parity_row(halo_steps(case, mesh, steps),
                                halo_steps(case, mesh, steps),
                                halo_steps(case, cpu_mesh, steps),
                                halo_steps(case, one_mesh, steps))
        rows[name]["seconds"] = time.perf_counter() - t0
    # the slab-sharded spectral step, 2D and 3D
    for dim, n in zip((2, 3), MULTIDEVICE["parity_spectral"]):
        t0 = time.perf_counter()
        space = TaylorHoodSpace(hyper_cube(dim, n)[0], periodic=[
            axis_periodic(a) for a in range(dim)])
        sg = PeriodicStructuredTH(space)
        u0 = (space.interpolate_velocity(lambda x: np.stack(
            [np.cos(2 * math.pi * x[:, 0]) * np.sin(2 * math.pi * x[:, 1]),
             -np.sin(2 * math.pi * x[:, 0])
             * np.cos(2 * math.pi * x[:, 1])], axis=1)).reshape(-1)
              if dim == 2 else vortex3d(space))
        p0 = np.zeros(space.n_pnodes)

        def run(where, on_mesh):
            step, init, read = build_spectral_projection_step(
                sg, visc=1.0 / RE, dt=DT, dtype=torch.float64,
                device=where)
            state = init(u0, u0, p0)
            if on_mesh is None:
                state = spectral_steps(step, state, steps)
                return tuple(torch.as_tensor(a) for a in read(state))
            sharded, shard_state = shard_spectral_step(step, sg, on_mesh)
            state = spectral_steps(sharded, shard_state(state), steps)
            return tuple(torch.as_tensor(a)
                         for a in read(sharded.gather_state(state)))

        rows[f"spectral_{n}^{dim}"] = parity_row(
            run(dev, mesh), run(dev, mesh), run("cpu", cpu_mesh),
            run(dev, None))
        rows[f"spectral_{n}^{dim}"]["seconds"] = time.perf_counter() - t0
    # the sharded Newton system's matvec (the Jacobian action)
    n = MULTIDEVICE["parity_cavity_n"]
    m, markers, bcs = lid_driven_cavity_setup(n)
    space = TaylorHoodSpace(m)
    (vmask, _), _ = dirichlet_masks(space, markers, bcs)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(space.n_dofs)
    v = rng.standard_normal(space.n_dofs)
    scalars = {"cv": 1.0 / 100.0, "cc": 1.0, "cp": 1.0, "accel0": 0.0}

    def jvp(where, on_mesh):
        op = MixedOperator(space, device=where, dtype=torch.float64)
        op.set_bc_dofs(np.nonzero(vmask)[0])
        if on_mesh is not None:
            op = ShardedMixedOperator(op, on_mesh)
        _, f = op.linearize_at(torch.tensor(x, device=where), scalars)
        return (f(torch.tensor(v, device=where)),)

    rows["newton_jvp"] = parity_row(jvp(dev, mesh), jvp(dev, mesh),
                                    jvp("cpu", cpu_mesh), jvp(dev, None))
    launches = dict(cuda_band.LAUNCHES)
    # the crossing's one-device leg is the channel's banded step
    # (solver_parity's case), which applies its bands; counted apart
    cuda_band.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, kinds_ok = checkpoint_crossing(dev, mesh, tmp)
    ckpt["one_device_leg_launches"] = dict(cuda_band.LAUNCHES)
    ckpt["seconds"] = time.perf_counter() - t0
    emit({"phase": "multidevice_parity",
          "config": f"f64, {steps} steps: the halo step on the 3D cavity "
                    f"{MULTIDEVICE['parity_box_n']}^3 and the shell n = "
                    f"{MULTIDEVICE['parity_shell_n']} (cg_iters "
                    f"{MULTIDEVICE['parity_cg_iters']}), the sharded "
                    f"spectral step at {MULTIDEVICE['parity_spectral'][0]}^2"
                    f" and {MULTIDEVICE['parity_spectral'][1]}^3, the "
                    f"Newton matvec on the cavity {n}^2; card vs CPU and "
                    f"{len(mesh)} shards vs 1; the channel "
                    f"{SOLVER['channel']} checkpoint crossing",
          **mesh_info(mesh), "rows": rows, "tol": MULTIDEVICE["parity_tol"],
          "checkpoint": ckpt, "launches": launches,
          "seconds": time.perf_counter() - t_start, "nvidia_smi": smi})
    tol = MULTIDEVICE["parity_tol"]
    bad = [k for k, r in rows.items()
           if not (r["card_vs_cpu"] <= tol and r["shards_vs_one"] <= tol
                   and r["rerun_bitwise"])]
    if not kinds_ok or not all(ckpt[k] for k in (
            "sharded_to_one_bitwise", "one_to_sharded_bitwise",
            "resumed_equals_unbroken_bitwise")):
        bad.append("checkpoint")
    if bad:
        raise AssertionError(f"multidevice_parity failed: {bad}")
    return launches


# ---------------------------------------------------------------------------
# group "apps": the native helper and the shipped applications on the card
# ---------------------------------------------------------------------------

# demo_gravity and demo_taylor_green solve with host LU / frozen LU, as
# bfs, blasius and bdf_dfg do: the card's default pcd stalls on the open
# cube (the JAX package's PCD-FGMRES too; no end in 1,190 s at n = 50 on
# an H100 at 700 W) and took 9.2 s per step of the Taylor-Green demo
APPS = {"native_n": 48, "gravity_n": 50, "gravity_linear_solver": "host_lu",
        "taylor_green_linear_solver": "frozen_lu",
        "box_tol": 1e-3, "study_n": 128, "study_levels": 6,
        "study_banded_rtol": 1e-12, "study_bdf_n": 32, "study_bdf_levels": 4,
        "study_bdf_linear_solver": "frozen_lu", "study_tol": 1e-6,
        "study_host_tol": 1e-10, "study_orders": (1.8, 2.4),
        "reference_tol": 1e-8}
# The JAX package's values on the CPU in float64 at the same settings (its
# default linear solvers there: SuperLU on the host), printed by
#   JAX_PLATFORMS=cpu python - <<'PY'
#   import importlib.util, tempfile, jax, numpy as np
#   jax.config.update("jax_enable_x64", True)
#   from navierstokes_tpu.mesh.core import extract_all_boundary_markers
#   from navierstokes_tpu.solvers import ProjectionSolver
#   def load(path):
#       spec = importlib.util.spec_from_file_location(path[:-3], path)
#       mod = importlib.util.module_from_spec(spec)
#       spec.loader.exec_module(mod)
#       return mod
#   g = load("demo/gravity_driven_flow.py")
#   t = load("demo/taylor_green_vortex.py")
#   c = load("convergence_test/taylor_green_vortex.py")
#   for n in (50, 32):
#       with tempfile.TemporaryDirectory() as d:
#           pr = g.GravityDrivenFlowProblem(n, d)
#           pr._write_output = False
#           pr.solve_problem()
#       s, u = pr._get_solver(), pr._get_velocity()
#       flux = 0.0
#       for b in extract_all_boundary_markers(pr._mesh,
#                                             pr._boundary_markers):
#           f = pr._boundary_markers.ids_with_value(b)
#           if len(f):
#               flux += float(s.operator.boundary_velocity_flux(
#                   s.operator.facet_batch_device(s.space.facet_batch(f)),
#                   u))
#       print(n, np.linalg.norm(u), np.abs(u).max(), flux)
#   with tempfile.TemporaryDirectory() as d:
#       pr = t.TaylorGreenVortex(d)
#       pr._write_output = False
#       pr.solve_problem()
#   s = pr._get_solver()
#   u, _ = s.space.split(s.solution)
#   print(s.operator.l2_error_velocity(
#       u, lambda x: c.exact_velocity(x, pr._time_stepping.current_time)))
#   class Banded(ProjectionSolver):
#       def __init__(self, *a, **k):
#           super().__init__(*a, **k, prefer_spectral=False, cg_rtol=1e-12)
#   print(c.main(128, 6, "projection")[1], c.main(32, 4, "bdf")[1])
#   for i in range(6):
#       pr = c.TaylorGreenVortex(0.5 ** i, 128, Banded)
#       pr.solve_problem()
#       print(pr.compute_errors()[0])
#   PY
APPS_REF = {
    "gravity": {50: {"u_norm": 0.5550938957668103,
                     "u_max": 0.041453817126450535,
                     "flux": -9.974659986866641e-18},
                32: {"u_norm": 0.39478879704430647,
                     "u_max": 0.04602552768205622,
                     "flux": 3.903127820947816e-18}},
    "taylor_green_l2_u": 5.142190302237536e-05,
    "study": {"spectral": [0.0740716968360464, 0.0274830918651524,
                           0.007373337225034709, 0.0016972762187026627,
                           0.00040505756325691475, 9.935121525005588e-05],
              "banded": [0.07407169683555731, 0.027483091864559425,
                         0.0073733461416853495, 0.0016972767476142363,
                         0.00040505757303153087, 9.935121460160213e-05],
              "bdf": [0.07406490563931953, 0.027460008553494366,
                      0.007211326008703994, 0.0016478869459417098]}}


class Clocked:
    """Mixin for an InstationaryProblem: the host clock over its time loop,
    from the start of its first step (synchronised)."""

    def _set_next_step_size(self):
        if not hasattr(self, "_loop_t0"):
            torch.cuda.synchronize()
            self._loop_t0 = time.perf_counter()
        super()._set_next_step_size()

    def loop_seconds(self):
        torch.cuda.synchronize()
        return time.perf_counter() - self._loop_t0


class ClockedTaylorGreen(Clocked, tg_demo.TaylorGreenVortex):
    pass


class ClockedPeriodicBox(Clocked, periodic_box_3d.PeriodicBox3D):
    pass


def per_step(launches, n_steps):
    return {k: v / max(n_steps, 1) for k, v in launches.items()}


def ab_times(fn_a, fn_b, rounds=2):
    """Host seconds of ``fn_a`` and ``fn_b`` in the order a, b, b, a per
    round: the medians and each one's last result."""
    times, outs = {"a": [], "b": []}, {}
    for _ in range(rounds):
        for who, fn in (("a", fn_a), ("b", fn_b), ("b", fn_b),
                        ("a", fn_a)):
            t0 = time.perf_counter()
            outs[who] = fn()
            times[who].append(time.perf_counter() - t0)
    return (statistics.median(times["a"]), statistics.median(times["b"]),
            outs["a"], outs["b"])


def phase_native(smi):
    """The g++ mesh helper: its build from the repository's source, and
    on the 48^3 box's topology unique_rows (facets, edges) and
    build_transpose (the P2 velocity table) against the NumPy versions it
    replaces: array-equal, both timed on this host."""
    from navierstokes_tpu_torch.mesh import core as mesh_core
    from navierstokes_tpu_torch.parallel import sharded

    # a fresh build of the repository's source (the process's own build
    # happened at its first mesh), timed; then the library in use must
    # be the one built from the source's hash
    build_dir = native.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        native.BUILD_DIR = pathlib.Path(tmp)
        try:
            t0 = time.perf_counter()
            fresh = native.build_library()
            build_s = time.perf_counter() - t0
        finally:
            native.BUILD_DIR = build_dir
    path = native.build_library()
    lib = native.get_library()
    if lib is None or lib._name != str(path) \
            or path.name != fresh.name:
        raise AssertionError(f"native: the library loaded ({lib}) is not "
                             f"the build of {native.SOURCE} ({path})")
    n = APPS["native_n"]
    t0 = time.perf_counter()
    mesh, _ = hyper_cube(3, n)
    mesh_s = time.perf_counter() - t0
    nv = mesh.cells.shape[1]
    facets = np.sort(mesh.cells[:, mesh_core._facet_local_indices(nv)]
                     .reshape(-1, 3), axis=1)
    edges = np.sort(mesh.cells[:, mesh_core._edge_local_indices(nv)]
                    .reshape(-1, 2), axis=1)
    flat = np.concatenate([mesh.cells, mesh.n_vertices + mesh.cell_edges],
                          axis=1).astype(np.int32).ravel()
    n_nodes = mesh.n_vertices + len(mesh.edges)
    cases = {
        "unique_rows_facets": (native.unique_rows, mesh_core.unique_rows,
                               (facets,)),
        "unique_rows_edges": (native.unique_rows, mesh_core.unique_rows,
                              (edges,)),
        "build_transpose_velocity": (native.build_transpose,
                                     sharded._numpy_scatter_transpose,
                                     (flat, n_nodes))}
    rows, bad = {}, []
    for name, (fast, plain, args) in cases.items():
        numpy_s, native_s, want, got = ab_times(lambda: plain(*args),
                                                lambda: fast(*args))
        equal = all(np.array_equal(a, b)
                    and np.asarray(a).dtype == np.asarray(b).dtype
                    for a, b in zip(got, want))
        rows[name] = {"rows": int(len(args[0])), "native_s": native_s,
                      "numpy_s": numpy_s, "speedup": numpy_s / native_s,
                      "equal": bool(equal)}
        if not equal:
            bad.append(name)
    emit({"phase": "native",
          "config": f"hyper_cube(3, {n}) (Kuhn cells): its facet and edge "
                    "rows and the ELL table of its P2 velocity nodes "
                    "(vertices, then edges); host medians of 4 timed calls "
                    "each, in the order numpy, native, native, numpy",
          "library": os.path.relpath(path), "build_seconds": build_s,
          "compiler": native._compiler(), "flags": list(native.CXX_FLAGS),
          "mesh_seconds": mesh_s, "n_cells": mesh.n_cells,
          "cases": rows, "no_slower": {k: r["native_s"] <= r["numpy_s"]
                                      for k, r in rows.items()},
          "nvidia_smi": smi})
    if bad:
        raise AssertionError(f"native: arrays differ from the NumPy "
                             f"versions in {bad}")


def relative(got, want):
    return abs(got - want) / abs(want)


def phase_demo_gravity(dev, smi):
    """demo/gravity_driven_flow.py (the port's demo class) at the shipped
    n = 50, f64, host LU, its output into a temporary directory."""
    n = APPS["gravity_n"]
    cuda_band.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        problem = gravity_driven_flow.GravityDrivenFlowProblem(
            n, tmp, device=dev, dtype=torch.float64,
            solver_options={"linear_solver": APPS["gravity_linear_solver"]})
        t0 = time.perf_counter()
        lines = run_quietly(problem)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        files = output_files(os.path.join(tmp, "results"))
    launches = dict(cuda_band.LAUNCHES)
    solver = problem._get_solver()
    solves = [r for r in solver.monitor.records
              if r["kind"] == "nonlinear_solve"]
    rec = dict(solves[0]) if solves else {}
    iters = rec.get("picard_iterations", 0) + rec.get("newton_iterations", 0)
    u = problem._get_velocity().double().cpu().numpy()
    ref = APPS_REF["gravity"][n]
    errs = {"u_norm": relative(float(np.linalg.norm(u)), ref["u_norm"]),
            "u_max": relative(float(np.abs(u).max()), ref["u_max"])}
    flux = problem.mass_flux
    emit({"phase": "demo_gravity",
          "config": f"demo/gravity_driven_flow.py, open cube n = {n}, Re "
                    "200, Fr 10, f64, linear solver "
                    f"{solver._resolved_linear_mode()}",
          "dofs": solver.space.n_dofs,
          "linear_mode": solver._resolved_linear_mode(),
          "nonlinear_solves": len(solves),
          "picard_iterations": rec.get("picard_iterations"),
          "newton_iterations": rec.get("newton_iterations"),
          "residual": rec.get("residual"), "mass_flux": flux,
          "mass_flux_jax_cpu": ref["flux"], "u_rel_err_jax_cpu": errs,
          "seconds": seconds, "stdout_lines": lines, "output": files,
          "launches": launches,
          "launches_per_linearized_step": per_step(launches, iters),
          "nvidia_smi": smi})
    bad = [len(solves) != 1, not rec.get("residual", 1.0) <= 1e-10,
           not max(errs.values()) <= APPS["reference_tol"],
           not abs(flux - ref["flux"]) <= 1e-9]
    if any(bad):
        raise AssertionError(f"demo_gravity guards failed: {bad} (one "
                             "nonlinear solve, ||F||, u, mass flux)")
    return launches


def phase_demo_taylor_green(dev, smi):
    """demo/taylor_green_vortex.py (the port's demo class: ImplicitBDFSolver
    on the 32^2 torus, 100 steps to t = 1), f64, its output every 10 steps
    into a temporary directory; L2(u) against the analytic decay."""
    options = {"linear_solver": APPS["taylor_green_linear_solver"]}
    cuda_band.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        problem = ClockedTaylorGreen(tmp, device=dev, dtype=torch.float64,
                                     solver_options=options)
        t0 = time.perf_counter()
        lines = run_quietly(problem)
        loop_s = problem.loop_seconds()
        seconds = time.perf_counter() - t0
        files = output_files(os.path.join(tmp, "results"))
    launches = dict(cuda_band.LAUNCHES)
    solver, ts = problem._get_solver(), problem._time_stepping
    u, _ = solver.space.split(solver.solution)
    t = ts.current_time
    l2 = solver.operator.l2_error_velocity(
        u, lambda x: tg_study.exact_velocity(x, t))
    ref = APPS_REF["taylor_green_l2_u"]
    err = relative(l2, ref)
    newton = [r["iterations"] for r in solver.monitor.records
              if r["kind"] == "nonlinear_solve"]
    emit({"phase": "demo_taylor_green",
          "config": "demo/taylor_green_vortex.py, 32^2 torus, Re 100, dt "
                    "0.01, ImplicitBDFSolver, f64, linear solver "
                    f"{solver._resolved_linear_mode()}",
          "dofs": solver.space.n_dofs, "steps": ts.step_number, "t": t,
          "ms_per_step": 1e3 * loop_s / max(ts.step_number, 1),
          "newton_iterations_per_step": float(np.mean(newton)),
          "l2_u_error": l2, "l2_u_error_jax_cpu": ref,
          "rel_err_jax_cpu": err, "seconds": seconds,
          "stdout_lines": lines, "output": files, "launches": launches,
          "launches_per_step": per_step(launches, ts.step_number),
          "nvidia_smi": smi})
    if ts.step_number != 100 or not abs(t - 1.0) <= 1e-12 \
            or not err <= APPS["reference_tol"]:
        raise AssertionError(f"demo_taylor_green: {ts.step_number} steps "
                             f"to t = {t}, L2(u) {l2} against the JAX "
                             f"package's {ref}")
    return launches


def phase_demo_periodic_box_3d(dev, smi):
    """demo/periodic_box_3d.py (the port's demo class) at its shipped 16^3
    and 50 steps, f32, on the spectral step: max|u| against the analytic
    decay of the shear wave."""
    cuda_band.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        problem = ClockedPeriodicBox(tmp, device=dev, dtype=torch.float32,
                                     solver_options={"cg_rtol": 1e-6})
        t0 = time.perf_counter()
        lines = run_quietly(problem)
        loop_s = problem.loop_seconds()
        seconds = time.perf_counter() - t0
    launches = dict(cuda_band.LAUNCHES)
    solver, ts = problem._get_solver(), problem._time_stepping
    amp, expected = periodic_box_3d.amplitude(problem)
    err = abs(amp - expected) / expected
    emit({"phase": "demo_periodic_box_3d",
          "config": "demo/periodic_box_3d.py, shear wave on the 16^3 "
                    "periodic Kuhn box, Re 100, dt 0.01, ProjectionSolver, "
                    "f32",
          "dofs": solver.space.n_dofs, "step_kind": solver._step_kind,
          "steps": ts.step_number, "t": ts.current_time,
          "ms_per_step": 1e3 * loop_s / max(ts.step_number, 1),
          "max_u": amp, "analytic": expected, "rel_err": err,
          "seconds": seconds, "stdout_lines": lines, "launches": launches,
          "launches_per_step": per_step(launches, ts.step_number),
          "nvidia_smi": smi})
    if solver._step_kind != "spectral" or ts.step_number != 50 \
            or not err < APPS["box_tol"]:
        raise AssertionError(f"demo_periodic_box_3d: step_kind "
                             f"{solver._step_kind!r}, {ts.step_number} "
                             f"steps, max|u| rel. error {err}")
    return launches


def run_study(dev, n, levels, solver, options):
    """convergence_test/taylor_green_vortex.py's main (the port's) in f64,
    quietly, in a temporary directory (it may write its plot there):
    ``(dts, u_errors, p_errors, seconds, steps, launches)``."""
    cuda_band.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        dts, eu, ep = tg_study.main(n, levels, solver, device=dev,
                                    dtype=torch.float64,
                                    solver_options=options)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = sum(round(1.0 / dt) for dt in dts)
    return dts, eu, ep, seconds, steps, dict(cuda_band.LAUNCHES)


def phase_convergence(dev, smi):
    """The convergence study (the port's) in f64: projection mode at 128^2
    over 6 levels on the spectral step and on the banded step (a shipped
    application through circulant_apply), then BDF mode at 32^2 over 4
    levels; per level dt, L2(u), L2(p), the observed orders, each run's
    launches per step.  The spectral run also runs on this machine's CPU:
    the card must agree with it to APPS["study_host_tol"] at every level
    (the JAX package's CPU values come from another machine, whose NumPy
    and LAPACK builds give host-built arrays one ulp apart, which the
    study's large steps amplify; ROADMAP section C).  Returns the launch
    counts by run."""
    n, levels = APPS["study_n"], APPS["study_levels"]
    bdf = {"linear_solver": APPS["study_bdf_linear_solver"]}
    runs = (("spectral", n, levels, "projection", None),
            ("banded", n, levels, "projection",
             {"prefer_spectral": False,
              "cg_rtol": APPS["study_banded_rtol"]}),
            ("bdf", APPS["study_bdf_n"], APPS["study_bdf_levels"], "bdf",
             bdf))
    out, by_run, bad = {}, {}, []
    lo, hi = APPS["study_orders"]
    for name, n_pts, n_lev, solver, options in runs:
        dts, eu, ep, seconds, steps, launches = run_study(
            dev, n_pts, n_lev, solver, options)
        orders = np.diff(-np.log2(eu)).tolist()
        ref = APPS_REF["study"][name]
        errs = [abs(a - b) / b for a, b in zip(eu, ref)]
        by_run[name] = launches
        out[name] = {"n_points": n_pts, "solver": solver,
                     "solver_options": options, "dt": dts, "l2_u": eu,
                     "l2_p": ep, "orders_u": orders,
                     "l2_u_jax_cpu": ref, "rel_err_jax_cpu": errs,
                     "steps": steps, "seconds": seconds,
                     "launches": launches,
                     "launches_per_step": per_step(launches, steps)}
        # the first pair (dt 1 -> 0.5) is outside the asymptotic range
        # (1.43 in the JAX package too); 128^2 and 32^2 reach no spatial
        # floor by dt 1/32 and 1/8
        if not (max(errs) <= APPS["study_tol"]
                and all(lo <= o <= hi for o in orders[1:])):
            bad.append(name)
        if name == "spectral":
            host = run_study("cpu", n_pts, n_lev, solver, options)[1]
            host_errs = [abs(a - b) / b for a, b in zip(eu, host)]
            out[name].update(l2_u_host_cpu=host,
                             rel_err_host_cpu=host_errs)
            if not max(host_errs) <= APPS["study_host_tol"]:
                bad.append("spectral against this machine's CPU")
    emit({"phase": "convergence",
          "config": "convergence_test/taylor_green_vortex.py, Re 100, "
                    "dt = 2^-i to t = 1, f64: projection mode (spectral, "
                    "and banded with prefer_spectral False), bdf mode",
          "runs": out, "nvidia_smi": smi})
    if by_run["banded"]["circulant_apply"] <= 0:
        bad.append("banded run launched no circulant_apply")
    if bad:
        raise AssertionError(f"convergence guards failed: {bad}")
    return by_run


GROUPS = ("kernels", "structured", "solver", "problems", "newton", "mesh3d",
          "multidevice", "apps")


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

    t_start = time.perf_counter()
    smi, kind = phase_device()
    phase_build()
    dev = torch.device(DEVICE)
    raw_ms, by_path = {}, {}
    if "kernels" in groups:
        st = Setup(dev)
        err_apply = phase_apply(st)
        err_pcg, subs32 = phase_pcg(st)
        main_launches, raw_ms["main"] = phase_main(st, smi, args.profile)
        by_path["main"] = main_launches["dispatch"]
        by_path["main_scan"] = main_launches["scan"]
        # the dispatch loop's steps: warm-up, timed, the residual step
        steps = bench.N_WARMUP + bench.N_STEPS + 1
        times = phase_timing(st, subs32, smi,
                             {k: v / steps
                              for k, v in by_path["main"].items()})
        if args.baseline:
            phase_baseline(st, subs32, smi, args.baseline)
        phase_parity(st)
        captured = phase_graph(st, smi)
        by_path["bench"] = phase_bench(smi)
    if "structured" in groups:
        setups = []
        for name in STRUCTURED:
            setups.append(StructuredSetup(name, dev))
            raw_ms[name] = phase_structured(setups[-1], smi, args.profile)
        phase_structured_timing(setups, smi)
        phase_structured_parity(setups)
        del setups
    cavity_ms = None
    if "solver" in groups:
        cavity_ms, by_path["solver_cavity"] = phase_solver_cavity(
            dev, smi, args.profile)
        by_path["solver_cavity_kernels"], cavity_t, err_cavity = \
            phase_solver_cavity_kernels(dev, smi)
        by_path["solver_periodic_fast"] = phase_solver_periodic(dev, smi,
                                                                raw_ms)
        phase_solver_parity(dev)
    if "problems" in groups:
        by_path["problem_cavity"] = phase_problem_cavity(dev, smi, cavity_ms,
                                                         args.profile)
        by_path["dfg"] = phase_dfg(dev, smi, args.profile)
        by_path["dfg_parity"] = phase_dfg_parity(dev)
    if "newton" in groups:
        by_path["newton_dfg"] = phase_newton_dfg(dev, smi, args.profile)
        by_path["newton_cavity"] = phase_newton_cavity(dev, smi,
                                                       args.profile)
        by_path["bdf_dfg"] = phase_bdf_dfg(dev, smi, args.profile)
        by_path["newton_parity"] = phase_newton_parity(dev)
    mesh3d_t, shell_state = None, None
    if "mesh3d" in groups:
        t_group = time.perf_counter()
        solver3d, ts3d, by_path["cavity3d"] = phase_cavity3d(dev, smi,
                                                             args.profile)
        by_path["cavity3d_kernels"], solves3d, applies3d, err_3d = \
            phase_cavity3d_kernels(solver3d, ts3d, smi)
        mesh3d_t = {"solves": solves3d, "applies": applies3d}
        del solver3d, ts3d
        by_path["duct3d"] = phase_duct3d(dev, smi)
        by_path["shell3d"], shell_state = phase_shell3d(dev, smi,
                                                         args.profile)
        by_path["bfs"], bfs_card = phase_bfs(dev, smi)
        by_path["blasius"] = phase_blasius(dev, smi)
        by_path["mesh3d_parity"] = phase_mesh3d_parity(dev, smi, bfs_card)
        emit({"phase": "mesh3d", "seconds": time.perf_counter() - t_group})
    if "multidevice" in groups:
        t_group = time.perf_counter()
        by_path["halo_shell"] = phase_halo_shell(dev, smi, shell_state)
        del shell_state
        by_path["spectral_sharded"] = phase_spectral_sharded(dev, smi)
        by_path["stationary_sharded"] = phase_stationary_sharded(dev, smi)
        by_path["multidevice_parity"] = phase_multidevice_parity(dev, smi)
        emit({"phase": "multidevice",
              "seconds": time.perf_counter() - t_group})
    if "apps" in groups:
        t_group = time.perf_counter()
        phase_native(smi)
        by_path["demo_gravity"] = phase_demo_gravity(dev, smi)
        by_path["demo_taylor_green"] = phase_demo_taylor_green(dev, smi)
        by_path["demo_periodic_box_3d"] = phase_demo_periodic_box_3d(dev,
                                                                     smi)
        for name, counts in phase_convergence(dev, smi).items():
            by_path[f"convergence_{name}"] = counts
        emit({"phase": "apps", "seconds": time.perf_counter() - t_group})

    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "groups": sorted(groups)})
    if groups == set(GROUPS):
        # ``launches`` sums the paths, each counted from 0 by its own phase;
        # every path that a kernel is on must have launched it
        # dfg holds no circulant operator at resolution 3 (every square
        # operator is an AffineBand under the RCM order); at resolution 1
        # (dfg_parity) the RCM bands of L and Mp fit the circulant cap
        # the Newton group's paths apply no band operator: their counts
        # are reported (0 expected) and not required
        # the mesh3d group: the banded paths (cavity3d, its kernels twin,
        # duct3d) apply the bands; shell3d takes the cell loop, bfs and
        # blasius the stationary solver, which apply no band operator
        # the multidevice group: the halo and cell-sharded operators, the
        # sharded spectral step and the sharded Newton stack apply none
        # (multidevice_parity prints the launches of its checkpoint
        # crossing's one-device banded leg apart)
        # the apps group: the Newton and BDF demos and the spectral box
        # apply no band operator; the convergence study's banded run must
        newton = ("newton_dfg", "newton_cavity", "bdf_dfg", "newton_parity",
                  "shell3d", "bfs", "blasius", "halo_shell",
                  "spectral_sharded", "stationary_sharded",
                  "multidevice_parity", "demo_gravity", "demo_taylor_green",
                  "demo_periodic_box_3d", "convergence_spectral",
                  "convergence_bdf")
        on_path = {"circulant_apply": [p for p in by_path
                                       if p != "dfg" and p not in newton],
                   "circulant_pcg": ["main", "main_scan", "bench",
                                     "solver_cavity_kernels",
                                     "cavity3d_kernels"]}
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
                    "max_abs_err": err, **{k: t[k] for k in keys},
                    "launches_per_graph_chunk": captured[name], **extra}

        print(json.dumps({"kernels": [
            row("circulant_apply", err_apply, apply_t,
                {"cavity3d_applies": mesh3d_t["applies"]}),
            row("circulant_pcg", max(err_pcg, err_cavity, err_3d), pcg_t,
                {"cavity_solves": {n: {k: t[k] for k in cavity_keys}
                                   for n, t in cavity_t.items()},
                 "cavity3d_solves": {n: {k: t[k] for k in cavity_keys}
                                     for n, t in mesh3d_t["solves"]
                                     .items()}})]}),
            flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
