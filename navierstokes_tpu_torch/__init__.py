"""navierstokes_tpu_torch -- the PyTorch/CUDA port of ``navierstokes_tpu``.

The port mirrors the JAX package's module paths so that each function has
an obvious counterpart.  Ported so far are the two projection steps of
the periodic benchmark (the generic banded SBDF-2 step in 2D, the
structured spectral step in 2D and 3D) and the time-stepping bookkeeping:

    mesh/        ``hyper_cube`` / ``hyper_rectangle`` (2D and 3D) and the
                 mesh topology
    fem/         P1/P2 elements, quadrature and the Taylor-Hood space
    assembly/    host assembly (NumPy/SciPy f64) and the device operator
                 formats (``fastop``), plus the two hand-written CUDA band
                 kernels (``cuda_band``, sources in ``csrc/band.cu``)
    solvers/     the planar projection step (``planar_step``)
    structured/  class grids of a periodic structured space (``grid``),
                 stencil applies and convection (``ops``), the DFT
                 block-diagonal solves and the spectral projection step
                 (``spectral``)
    timestepping/  ``DiscreteTime`` and the BDF, theta and IMEX coefficient
                 generators (pure Python)
    setups.py    the benchmark's initial states (2D Taylor-Green vortex,
                 3D shear wave)

The package imports ``torch``, NumPy and SciPy only -- never ``jax`` and
never ``navierstokes_tpu``.
"""

from navierstokes_tpu_torch import config as config  # noqa: F401

__version__ = "0.1.0"
