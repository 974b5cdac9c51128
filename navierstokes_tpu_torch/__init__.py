"""navierstokes_tpu_torch -- the PyTorch/CUDA port of ``navierstokes_tpu``.

The port mirrors the JAX package's module paths so that each function has
an obvious counterpart.  Ported so far are the two projection steps (the
generic banded SBDF-2 step on 2D structured boxes, periodic or
wall-bounded; the structured spectral step in 2D and 3D), the
time-stepping bookkeeping and, on top of them, the product solver API for
transient flow (``ProjectionSolver`` with boundary conditions,
coefficients, initial conditions and checkpoints):

    mesh/        ``hyper_cube`` / ``hyper_rectangle`` (2D and 3D), the
                 mesh topology and its facet geometry
    fem/         P1/P2 elements, quadrature, the Taylor-Hood space, the
                 boundary-condition types (``bcs``) and their compiler
                 (``dirichlet``)
    assembly/    host assembly (NumPy/SciPy f64) and the device operator
                 formats (``fastop``: circulant and affine bands, stencil
                 and gather couplings), the two hand-written CUDA band
                 kernels (``cuda_band``, sources in ``csrc/band.cu``), the
                 element kernels and ``MixedOperator``'s forward subset
    linalg/      conjugate gradients and the smoothed-aggregation AMG
    solvers/     the planar projection step (``planar_step``), the solver
                 bases and ``ProjectionSolver``
    problems/    dimensionless coefficients and rotating frames
    io/          checkpoints (the JAX package's ``.npz`` layout)
    utils/       the solver monitor and fixed-order segment sums
    structured/  class grids of a periodic structured space (``grid``),
                 stencil applies and convection (``ops``), the DFT
                 block-diagonal solves and the spectral projection step
                 (``spectral``)
    timestepping/  ``DiscreteTime`` and the BDF, theta and IMEX coefficient
                 generators (pure Python)
    setups.py    the benchmark's initial states (2D Taylor-Green vortex,
                 3D shear wave) and the lid-driven cavity and channel

The package imports ``torch``, NumPy and SciPy only -- never ``jax`` and
never ``navierstokes_tpu``.
"""

from navierstokes_tpu_torch import config as config  # noqa: F401

__version__ = "0.1.0"
