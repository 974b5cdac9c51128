"""Port parity: static-sparsity CSR assembly (assembly/sparse.py).

The pattern and the Dirichlet row masks are host NumPy on both sides and
must be equal array for array; assembled values, the matvec, the diagonal
and the dense form agree with the JAX package to 1e-12 of the largest
entry (summation order only).  CPU, float64, inputs from NumPy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.assembly import sparse as jsp
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cylinder
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu_torch.assembly import sparse as tsp
from navierstokes_tpu_torch.assembly.operators import _cell_dofs

TOL = 1e-12

_MESHES = {"cube": lambda: jax_hyper_cube(2, 5)[0],
           "cylinder": lambda: jax_cylinder(0.5)[0]}
_CASES = {}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: under several pytest workers on a
    shared CPU, torch's intra-op threads oversubscribe the cores and slow
    them tenfold.  One thread per worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def _case(name):
    """(cell dofs, n, JAX pattern, port pattern) of a mesh's mixed space
    (the port's cell-dof layout, built from the JAX space's arrays)."""
    if name not in _CASES:
        space = JaxSpace(_MESHES[name]())
        cd = _cell_dofs(space, True)
        _CASES[name] = (cd, space.n_dofs, jsp.build_pattern(cd, space.n_dofs),
                        tsp.build_pattern(cd, space.n_dofs))
    return _CASES[name]


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_pattern_equals_the_jax_package(name):
    cd, n, jp, tp = _case(name)
    assert tp.n == jp.n and tp.nnz == jp.nnz
    for field in ("rows", "cols", "slots", "diag_slots"):
        a, b = getattr(tp, field), getattr(jp, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # CSR order: rows sorted, columns sorted within each row
    keys = tp.rows.astype(np.int64) * n + tp.cols
    assert np.all(np.diff(keys) > 0)


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_bc_row_masks_equal_the_jax_package(name):
    cd, n, jp, tp = _case(name)
    bc = np.unique(np.random.default_rng(1).integers(0, n, n // 5))
    for a, b in zip(tsp.bc_row_masks(tp, bc), jsp.bc_row_masks(jp, bc)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_assembly_matvec_and_dense_match(name):
    cd, n, jp, tp = _case(name)
    rng = np.random.default_rng(2)
    elem = rng.standard_normal(cd.shape + (cd.shape[1],))
    bc = np.unique(rng.integers(0, n, n // 7))
    x = rng.standard_normal(n)

    jvals = jsp.assemble_csr(jp, jnp.asarray(elem))
    mask, diag = jsp.bc_row_masks(jp, bc)
    jvals = jsp.apply_bc_rows(jp, jvals, jnp.asarray(mask), jnp.asarray(diag))
    jcsr = jsp.CSRMatrix(jp, jvals)

    dpat = tsp.DevicePattern(tp, "cpu")
    tvals = tsp.assemble_csr(dpat, torch.tensor(elem))
    mask, diag = tsp.bc_row_masks(tp, bc)
    tvals = tsp.apply_bc_rows(tvals, torch.tensor(mask), torch.tensor(diag))
    tcsr = tsp.CSRMatrix(dpat, tvals)

    assert tcsr.nnz == tp.nnz
    assert _rel(tcsr.values, jcsr.values) <= TOL
    assert _rel(tcsr.matvec(torch.tensor(x)), jcsr.matvec(jnp.asarray(x))) \
        <= TOL
    assert _rel(tcsr @ torch.tensor(x), jcsr @ jnp.asarray(x)) <= TOL
    assert _rel(tcsr.diagonal(), jcsr.diagonal()) <= TOL
    if n <= 2000:
        assert _rel(tcsr.todense(), jcsr.todense()) <= TOL
    # identity rows at the constrained dofs
    assert np.all(tcsr.diagonal().numpy()[bc] == 1.0)
    # a fixed summation order: reassembly gives the same bits
    again = tsp.apply_bc_rows(tsp.assemble_csr(dpat, torch.tensor(elem)),
                              torch.tensor(mask), torch.tensor(diag))
    assert torch.equal(again, tvals)
