"""navierstokes_tpu_torch -- the PyTorch/CUDA port of ``navierstokes_tpu``.

The port mirrors the JAX package's module paths so that each function has
an obvious counterpart.  The slice ported so far is the generic banded
SBDF-2 projection step on the periodic Taylor-Green vortex:

    mesh/        ``hyper_cube`` / ``hyper_rectangle`` and the mesh topology
    fem/         P1/P2 elements, quadrature and the Taylor-Hood space
    assembly/    host assembly (NumPy/SciPy f64) and the device operator
                 formats (``fastop``), plus the two hand-written CUDA band
                 kernels (``cuda_band``, sources in ``csrc/band.cu``)
    solvers/     the planar projection step (``planar_step``)
    setups.py    the benchmark's initial state

The package imports ``torch``, NumPy and SciPy only -- never ``jax`` and
never ``navierstokes_tpu``.
"""

from navierstokes_tpu_torch import config as config  # noqa: F401

__version__ = "0.1.0"
