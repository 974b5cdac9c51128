"""Direct linear solves (counterpart of ``navierstokes_tpu/linalg/direct.py``).

``dense_solve`` is an LU with partial pivoting on the device, for
validation-sized saddle-point systems.  ``HostSparseLU`` factors a
``CSRMatrix`` with SuperLU through SciPy on the host, for meshes where a
dense factor would not fit: the JAX package's own host step.  Its
``solve`` copies the right-hand side to the host, solves in float64 and
returns the solution on the caller's device in the caller's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_solve(A, b):
    """Solve dense A x = b on the device (LU with partial pivoting)."""
    if hasattr(A, "todense"):
        A = A.todense()
    return torch.linalg.solve(A, b)


class HostSparseLU:
    """SuperLU factorization of a CSRMatrix on the host (float64).

    Factorizations are redone at each call site's discretion (cache the
    object to reuse the factor).
    """

    def __init__(self, csr):
        from scipy.sparse.linalg import splu

        self._n = csr.pattern.n
        self._lu = splu(self.host_matrix(csr).tocsc())

    @staticmethod
    def host_matrix(csr):
        """The CSR as a SciPy float64 matrix on the host (one copy of the
        values off the device)."""
        from scipy.sparse import csr_matrix

        pattern = csr.pattern
        values = csr.values.detach().cpu().numpy().astype(np.float64)
        return csr_matrix((values, (pattern.rows, pattern.cols)),
                          shape=(pattern.n, pattern.n))

    def solve(self, b):
        x = self._lu.solve(b.detach().cpu().numpy().astype(np.float64))
        return torch.as_tensor(x, dtype=b.dtype, device=b.device)
