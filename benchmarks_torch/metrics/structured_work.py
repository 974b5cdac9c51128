"""Bytes and least time of the structured convection
(``structured/ops.py::StructuredConvection``: class grids in, class grids
out), from its operand's shape.

The count is the operation's, whatever implements it: the velocity's
class grids (2^dim, *grid, d) read once and the result, of the same
shape, written once.  No FLOP is counted: the quadrature's work belongs
to one implementation (a 64-point rule in 3D; an exact 15-point one would
do a quarter of it), so the bound is the bytes' at the peak memory rate
of ``work.py``."""

from __future__ import annotations

import math

from harness.spec import load_module


def convection_bytes(shape, esize):
    """Bytes of one convection of class grids of ``shape`` with
    ``esize``-byte elements."""
    return 2 * math.prod(shape) * esize


def convection_least_ms(shape, esize):
    """Its least time in ms at the card's peak memory rate."""
    peak = load_module("metrics", "work").PEAK_BYTES_PER_S
    return 1e3 * convection_bytes(shape, esize) / peak
