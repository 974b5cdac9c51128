"""Sums by a static index without atomics.

``index_add_`` on a CUDA tensor adds with atomics, in an order that
changes from run to run.  Every scatter-add of the port has indices that
are fixed at setup (a sparse matrix's rows, the nodes of each cell, the
aggregate of each node), so the indices are sorted once on the host into a
row-wise padded table; the sum is then a gather through the table and a
reduction over its last axis, in the same order on every run.

Values with trailing axes are gathered one trailing column at a time
(:func:`take_rows`): on the card torch gathers rows of a few elements with
one thread block per index, about 25 times slower than the same indices
gathered column by column (two f64 columns, 1.25 M indices, on an H100).
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


def take_rows(x, index):
    """``x[index]`` for ``x`` of shape (m,) + tail, gathered one trailing
    column at a time."""
    if x.dim() == 1:
        return x[index]
    cols = x.reshape(x.shape[0], -1).T.contiguous()
    return cols[:, index].movedim(0, -1).reshape(
        tuple(index.shape) + tuple(x.shape[1:]))


def padded_row_sum(table, x, weights=None):
    """``sum_j weights[i, j] * xp[table[i, j]]`` over each row ``i`` of a
    padded gather table, where ``xp`` is ``x`` (shape (m,) + tail) with a
    zero row appended at index m; the sum runs over the table's last axis
    for every trailing column, in the same order."""
    if x.dim() == 1:
        g = torch.nn.functional.pad(x, (0, 1))[table]
        return (g if weights is None else weights * g).sum(dim=1)
    columns = x.reshape(x.shape[0], -1).T
    g = torch.nn.functional.pad(columns, (0, 1))[:, table]
    out = (g if weights is None else weights * g).sum(dim=-1)
    return out.T.reshape((table.shape[0],) + tuple(x.shape[1:]))


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
        return padded_row_sum(self.table, vals.reshape((-1,) + tail))
