"""Utilities: structured solver metrics and fixed-order segment sums."""

from navierstokes_tpu_torch.utils.monitor import SolverMonitor  # noqa: F401
