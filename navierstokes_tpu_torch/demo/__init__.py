"""The shipped applications on the port: one module per script of the
repository's ``demo/`` (the JAX package's), each with the same problem
class (constructor arguments and defaults, hooks, printed results) and a
``main(argv=None)``:

    python -m navierstokes_tpu_torch.demo.cavity_flow [--device D] [--dtype T]

Every ``main`` takes its JAX script's positional arguments and
``--device`` / ``--dtype``.  It runs on the card by default, in float32
where the demo takes the projection path and in float64 (the Newton
stack's contract) otherwise; ``--device cpu`` runs in float64 on the CPU.
Without a card and without ``--device cpu`` it raises ``RuntimeError``.
The problem classes take the port's keyword arguments ``device``,
``dtype`` and ``solver_options`` besides their own.
"""

from __future__ import annotations

import argparse

import torch

from navierstokes_tpu_torch import config


def argument_parser(description: str) -> argparse.ArgumentParser:
    """A parser with the port's ``--device`` and ``--dtype``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="default: float32 on the card for the projection "
                         "path, else float64")
    return ap


def placement(args, projection: bool) -> dict:
    """The problem's ``device``, ``dtype`` and ``solver_options`` from the
    parsed ``--device`` / ``--dtype``; raises without a card unless the
    CPU was asked for.  In float32 the projection solves stop at
    ``cg_rtol`` 1e-6: the solver's default 1e-8 is below float32
    roundoff, and every solve would run to its iteration cap."""
    device = config.require_device(args.device)
    if args.dtype is not None:
        dtype = getattr(torch, args.dtype)
    elif projection and device.type == "cuda":
        dtype = torch.float32
    else:
        dtype = torch.float64
    options = {"cg_rtol": 1e-6} if projection and dtype == torch.float32 \
        else {}
    return {"device": device, "dtype": dtype, "solver_options": options}
