"""Host-built arrays of the convergence study on one machine, and their
comparison across machines.

    python tools/study_host_arrays.py dump OUT.npz
    python tools/study_host_arrays.py compare A.npz B.npz

``dump`` runs, on this machine's CPU in float64, the port's convergence
study (``navierstokes_tpu_torch/convergence_test/taylor_green_vortex.py``,
projection mode, spectral step, 128^2, 6 levels) and saves its L2(u) per
level, the state of its first level (dt = 1) after 0 and 1 steps, and the
arrays that level's setup builds on the host with NumPy: the Taylor-Hood
space's geometry and quadrature, and the spectral step's symbols,
eigenbasis and convection tables.  ``compare`` prints, for each array of
two dumps (two machines), whether it is equal, its largest difference
and how many entries differ, then the study's L2(u) per level relative
to each other and to the JAX package's CPU values in ``chip_smoke.py``.
It runs in about 30 s on one CPU and writes about 16 MB.
"""

import contextlib
import io
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from navierstokes_tpu_torch.convergence_test import \
    taylor_green_vortex as study  # noqa: E402
from navierstokes_tpu_torch.solvers import ProjectionSolver  # noqa: E402

N_POINTS, LEVELS = 128, 6


def _tensors(prefix, obj, out):
    for name, value in vars(obj).items():
        if torch.is_tensor(value):
            out[f"{prefix}.{name}"] = value.detach().cpu().numpy()
        elif isinstance(value, np.ndarray):
            out[f"{prefix}.{name}"] = value
        elif isinstance(value, (tuple, list)) and value and \
                all(torch.is_tensor(t) for t in value):
            for i, t in enumerate(value):
                out[f"{prefix}.{name}.{i}"] = t.detach().cpu().numpy()


def dump(path):
    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for steps in (0, 1):
            problem = study.TaylorGreenVortex(1.0, N_POINTS, ProjectionSolver,
                                              device="cpu")
            problem._n_max_steps = steps
            problem.solve_problem()
            solver = problem._get_solver()
            out[f"solution{steps}"] = solver.solution.numpy()
            out[f"errors{steps}"] = np.array(problem.compute_errors())
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            out["study_l2_u"] = np.array(study.main(
                N_POINTS, LEVELS, "projection", device="cpu")[1])
    step = solver._spectral[0]
    _tensors("ops", step.ops, out)
    _tensors("conv", step.conv, out)
    _tensors("space", solver.space, out)
    np.savez_compressed(path, **out)


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    for key in a.files:
        x, y = a[key], b[key]
        if x.shape != y.shape:
            print(f"{key:24s} shapes {x.shape} {y.shape}")
            continue
        diff = np.abs(x - y).max() if x.size else 0.0
        scale = np.abs(x).max() if x.size else 0.0
        print(f"{key:24s} equal {np.array_equal(x, y)!s:5s} max|diff| "
              f"{diff:.3e} relative {diff / max(scale, 1e-300):.3e} "
              f"entries {(x != y).sum()}/{x.size}")
    from chip_smoke import APPS_REF

    jax_cpu = np.array(APPS_REF["study"]["spectral"])
    la, lb = a["study_l2_u"], b["study_l2_u"]
    print("study L2(u), A vs B:      ", (np.abs(la - lb) / lb).tolist())
    print("study L2(u), A vs JAX CPU:", (np.abs(la - jax_cpu) / jax_cpu)
          .tolist())
    print("study L2(u), B vs JAX CPU:", (np.abs(lb - jax_cpu) / jax_cpu)
          .tolist())


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
