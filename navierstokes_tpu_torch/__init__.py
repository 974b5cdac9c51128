"""navierstokes_tpu_torch -- the PyTorch/CUDA port of ``navierstokes_tpu``.

The port mirrors the JAX package's module paths so that each function has
an obvious counterpart.  It holds the two projection steps (the
generic banded SBDF-2 step on 2D structured boxes, periodic or
wall-bounded; the structured spectral step in 2D and 3D), the
time-stepping bookkeeping, the product solver API for transient flow
(``ProjectionSolver`` with boundary conditions, coefficients, initial
conditions and checkpoints), the application layer, and the Newton and
monolithic stack (stationary Picard->Newton, monolithic BDF, theta, IMEX
and IPCS solvers with direct and PCD-FGMRES linear solves), the
multi-device layer (the halo projection step, the slab-sharded spectral
step, the cell-sharded Newton stack) over shards of one card or several,
the g++ mesh helper and the shipped applications:

    mesh/        ``hyper_cube`` / ``hyper_rectangle`` (2D and 3D), the
                 mesh topology and its facet geometry
    fem/         P1/P2 elements, quadrature, the Taylor-Hood space, the
                 boundary-condition types (``bcs``) and their compiler
                 (``dirichlet``)
    assembly/    host assembly (NumPy/SciPy f64) and the device operator
                 formats (``fastop``: circulant and affine bands, stencil
                 and gather couplings), the wrappers of the CUDA band and
                 AMG-PCG kernels (``cuda_band``, ``cuda_amg``), the
                 element kernels and their Jacobians, the operators
                 (``MixedOperator``, ``VelocityOperator``), static CSR
                 assembly (``sparse``) and the host f64 residual
    linalg/      Krylov solvers, the steps' PCG (``pcg``), FGMRES, direct
                 solves, the Newton loop, the smoothed-aggregation AMG and
                 the PCD preconditioners
    solvers/     the planar projection step (``planar_step``), the solver
                 bases, ``ProjectionSolver``, ``StationarySolver``,
                 ``ImplicitBDFSolver``, ``ThetaSolver``, ``IMEXSolver``,
                 ``IPCSSolver``
    problems/    the Problem classes, postprocessing, dimensionless
                 coefficients and rotating frames
    io/          checkpoints (the JAX package's ``.npz`` layout), field
                 output
    utils/       the solver monitor and fixed-order segment sums
    structured/  class grids of a periodic structured space (``grid``),
                 stencil applies and convection (``ops``), the DFT
                 block-diagonal solves and the spectral projection step
                 (``spectral``)
    timestepping/  ``DiscreteTime`` and the BDF, theta and IMEX coefficient
                 generators (pure Python)
    parallel/    the multi-device layer in one process: a mesh of shard
                 devices and its collectives, cell-sharded and
                 halo-exchange operators, the sharded Newton operator
    native/      the g++ host helper (row deduplication, ELL transpose
                 tables), built at first use
    demo/        the repository's demo scripts as modules with a ``main``
                 (``python -m navierstokes_tpu_torch.demo.cavity_flow``)
    convergence_test/  the Taylor-Green temporal convergence study
    cudalib.py   the library of the hand-written CUDA kernels
                 (``csrc/*.cu``): build, entry points, launch counts
    setups.py    the benchmark's initial states (2D Taylor-Green vortex,
                 3D shear wave) and the lid-driven cavity and channel

The package imports ``torch``, NumPy and SciPy only -- never ``jax`` and
never ``navierstokes_tpu``.
"""

from navierstokes_tpu_torch import config as config  # noqa: F401

__version__ = "0.1.0"
