"""Sums by a static index without atomics.

``index_add_`` on a CUDA tensor adds with atomics, in an order that
changes from run to run.  Every scatter-add of the port has indices that
are fixed at setup (a sparse matrix's rows, the nodes of each cell, the
aggregate of each node), so the indices are sorted once on the host into a
row-wise padded table; the sum is then a gather through the table and a
reduction over its last axis, in the same order on every run.
"""

from __future__ import annotations

import numpy as np
import torch


def ell_from_sorted_coo(rows, cols, n_rows, pad):
    """Row-wise padded (ELL) layout of a COO pattern sorted by row.

    Returns ``(table (n_rows, K) int64, slots (nnz,) int64)``: ``table``
    holds each row's column indices in order, padded with ``pad``;
    ``slots`` the flat position of every nonzero in it.
    """
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.bincount(rows, minlength=n_rows)
    K = max(int(counts.max()) if len(counts) else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(rows)) - np.repeat(starts, counts)
    table = np.full((n_rows, K), pad, dtype=np.int64)
    table[rows, within] = cols
    return table, rows * K + within


class SegmentSum:
    """``out[s] = sum of vals[j] over the entries j with index[j] == s``.

    ``index`` is an integer array of any shape with values in ``[0, n)``;
    the call takes values of shape ``index.shape + tail`` and returns
    ``(n,) + tail``.  Entries of one segment are added in the order of
    their flat position in ``index``.
    """

    def __init__(self, index, n, device):
        flat = np.asarray(index, dtype=np.int64).ravel()
        order = np.argsort(flat, kind="stable")
        table, _ = ell_from_sorted_coo(flat[order], order, int(n),
                                       pad=len(flat))
        self.index_shape = tuple(np.shape(index))
        self.n = int(n)
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, vals):
        k = len(self.index_shape)
        if tuple(vals.shape[:k]) != self.index_shape:
            raise ValueError(f"values of shape {tuple(vals.shape)} do not "
                             f"match the index shape {self.index_shape}")
        tail = tuple(vals.shape[k:])
        flat = vals.reshape((-1,) + tail)
        padded = torch.cat([flat, flat.new_zeros((1,) + tail)], dim=0)
        return padded[self.table].sum(dim=1)
