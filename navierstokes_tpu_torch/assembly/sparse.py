"""Static-sparsity CSR matrices assembled by a fixed-order segment sum
(counterpart of ``navierstokes_tpu/assembly/sparse.py``).

The sparsity pattern is host-side precomputation (NumPy, once per space);
numeric assembly sums element-matrix entries into the nnz array through a
``utils.segment.SegmentSum`` (sorted gather + fixed-order sum, no
atomics), so reruns on the card give the same bits.  The matvec is a
gather + fixed-order sum over the rows of a padded row layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from navierstokes_tpu_torch.utils.segment import (SegmentSum,
                                                   ell_from_sorted_coo)


@dataclass(frozen=True, eq=False)
class SparsityPattern:
    """CSR pattern + element-entry -> nnz-slot scatter map."""

    n: int                    # matrix dimension
    rows: np.ndarray          # (nnz,) int32 row of each stored entry
    cols: np.ndarray          # (nnz,) int32
    slots: np.ndarray         # (n_cells, nloc, nloc) int32 into nnz
    diag_slots: np.ndarray    # (n,) int32 slot of each diagonal entry

    @property
    def nnz(self) -> int:
        return len(self.rows)


def build_pattern(cell_dofs: np.ndarray, n: int) -> SparsityPattern:
    """Unique CSR pattern of sum_c scatter(cell_dofs[c] x cell_dofs[c])."""
    cell_dofs = np.asarray(cell_dofs, dtype=np.int64)
    nc, nloc = cell_dofs.shape
    rows = np.repeat(cell_dofs, nloc, axis=1).reshape(-1)
    cols = np.tile(cell_dofs, (1, nloc)).reshape(-1)
    keys = rows * n + cols
    # ensure the diagonal exists (needed for BC identity rows)
    diag_keys = np.arange(n, dtype=np.int64) * n + np.arange(n)
    all_keys = np.concatenate([keys, diag_keys])
    unique_keys, inverse = np.unique(all_keys, return_inverse=True)
    slots = inverse[:len(keys)].reshape(nc, nloc, nloc).astype(np.int32)
    diag_slots = inverse[len(keys):].astype(np.int32)
    return SparsityPattern(
        n=n,
        rows=(unique_keys // n).astype(np.int32),
        cols=(unique_keys % n).astype(np.int32),
        slots=slots,
        diag_slots=diag_slots,
    )


class DevicePattern:
    """The device half of a pattern: the slot scatter of the assembly, the
    padded row layout of the matvec and the diagonal slots, built once per
    pattern and device."""

    def __init__(self, pattern: SparsityPattern, device):
        self.pattern = pattern
        self.device = torch.device(device)
        self.assemble = SegmentSum(pattern.slots, pattern.nnz, device)
        table, slots = ell_from_sorted_coo(pattern.rows, pattern.cols,
                                           pattern.n, pad=pattern.n)
        self.row_shape = table.shape
        self.row_slots = torch.as_tensor(slots, device=device)
        self.rows = torch.as_tensor(pattern.rows.astype(np.int64),
                                    device=device)
        self.cols = torch.as_tensor(pattern.cols.astype(np.int64),
                                    device=device)
        self.diag_slots = torch.as_tensor(
            pattern.diag_slots.astype(np.int64), device=device)


class CSRMatrix:
    """CSR values (a tensor on the pattern's device) bound to a static
    pattern."""

    def __init__(self, dpat: DevicePattern, values: torch.Tensor):
        self.dpat = dpat
        self.pattern = dpat.pattern
        self.values = values

    @property
    def nnz(self) -> int:
        return self.pattern.nnz

    def matvec(self, x):
        shape = self.dpat.row_shape
        padded = x.new_zeros(shape[0] * shape[1])
        padded[self.dpat.row_slots] = self.values * x[self.dpat.cols]
        return padded.reshape(shape).sum(dim=1)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        return self.values[self.dpat.diag_slots]

    def todense(self):
        n = self.pattern.n
        dense = self.values.new_zeros((n, n))
        dense[self.dpat.rows, self.dpat.cols] = self.values
        return dense


def assemble_csr(dpat: DevicePattern, element_matrices) -> torch.Tensor:
    """Sum element matrices (nc, nloc, nloc) into the nnz value array."""
    return dpat.assemble(element_matrices)


def apply_bc_rows(values, bc_row_mask_nnz, bc_diag_slots):
    """Replace Dirichlet rows by identity rows.

    ``bc_row_mask_nnz``: (nnz,) bool, True where the entry's row is
    constrained.  ``bc_diag_slots``: (n_bc,) slots of the constrained
    diagonal entries.
    """
    values = torch.where(bc_row_mask_nnz, 0.0, values)
    return values.index_fill(0, bc_diag_slots.long(), 1.0)


def bc_row_masks(pattern: SparsityPattern, bc_dofs: np.ndarray):
    """Host precomputation for :func:`apply_bc_rows`."""
    is_bc = np.zeros(pattern.n, dtype=bool)
    is_bc[bc_dofs] = True
    return is_bc[pattern.rows], pattern.diag_slots[bc_dofs]
