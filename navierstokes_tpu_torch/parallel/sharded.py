"""Host part of ``navierstokes_tpu/parallel/sharded.py``.

The transpose-gather table (node -> contributing (cell, local-node) slots)
that the gather convection path of ``assembly/fastop.py`` accumulates
with.  The device mesh and the cell-sharded device operators are a later
slice (``device_mesh`` raises ``NotImplementedError`` until then).
"""

from __future__ import annotations

import numpy as np


def device_mesh(n_devices=None, axis="shard"):
    """A 1D mesh of devices for the sharded operators (not ported yet)."""
    raise NotImplementedError(
        "parallel.sharded.device_mesh is not ported yet (ROADMAP item 15: "
        "the multi-device layer on torch.distributed)")


def _numpy_scatter_transpose(flat_nodes: np.ndarray, n_nodes: int,
                             k_pad=None):
    """ELL-padded transpose table of a flat node list (NumPy)."""
    n_flat = len(flat_nodes)
    order = np.argsort(flat_nodes, kind="stable")
    counts = np.bincount(flat_nodes, minlength=n_nodes)
    K = int(counts.max()) if len(counts) else 1
    if k_pad is not None:
        K = max(K, int(k_pad))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n_nodes, K), n_flat, dtype=np.int32)
    within = np.arange(n_flat) - np.repeat(starts, counts)
    table[flat_nodes[order], within] = order.astype(np.int32)
    return table, K


def build_scatter_transpose(cell_nodes: np.ndarray, n_nodes: int,
                            k_pad: int = None):
    """Transpose-gather table: node -> flat (cell, local) slots.

    Returns (table (n_nodes, K) int32, K).  Pad entries point one past the
    last flat slot; callers append a zero row to the flattened per-cell
    values before gathering.
    """
    flat_nodes = np.asarray(cell_nodes, dtype=np.int32).ravel()
    return _numpy_scatter_transpose(flat_nodes, n_nodes, k_pad)
