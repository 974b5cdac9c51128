"""Port parity: the g++ host helper (``navierstokes_tpu_torch/native``).

The port's ``unique_rows`` and ``build_transpose`` are held to the JAX
package's ``native`` functions and to the port's own NumPy versions
(``mesh/core.py::unique_rows``, ``parallel/sharded.py::
_numpy_scatter_transpose``): host integer arrays, so every result must be
EQUAL (``np.array_equal``, dtypes included).  Also: the mesh topology built
through the helper equals the JAX package's, ``NS_TPU_NO_NATIVE=1`` takes
the NumPy versions, a compiler that fails raises, and the library's file
name follows its source.
"""

import numpy as np
import pytest

from navierstokes_tpu import native as jnative
from navierstokes_tpu.mesh import generators as jgen
from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.mesh import generators as tgen
from navierstokes_tpu_torch.mesh.core import unique_rows as numpy_unique_rows
from navierstokes_tpu_torch.parallel.sharded import (
    _numpy_scatter_transpose, build_scatter_transpose)

TOPOLOGY = ("points", "cells", "facets", "edges", "cell_facets",
            "cell_edges", "facet_counts", "facet_cell", "facet_local_index",
            "exterior_facet_mask")


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _rows(seed, n, width, high, low=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(low, high, (n, width)).astype(np.int32)
    rows[n // 3:n // 3 + n // 4] = rows[:n // 4]       # repeated rows
    return rows


ROW_CASES = {
    # packed-key branch: non-negative, base ** width < 2 ** 62
    "w2": _rows(0, 4000, 2, 300),
    "w3": _rows(1, 4000, 3, 60),
    "w4": _rows(2, 4000, 4, 20),
    "w3_sorted_facets": np.sort(_rows(3, 5000, 3, 1000), axis=1),
    # row-compare branch: too wide to pack, or negative entries
    "w3_too_wide": _rows(4, 3000, 3, 2 ** 31 - 1),
    "w4_too_wide": _rows(5, 3000, 4, 70000),
    "w2_negative": _rows(6, 3000, 2, 50, low=-50),
    "empty": np.zeros((0, 3), np.int32),
    "one_row": np.array([[4, 1, 7]], np.int32),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_unique_rows_equal_jax_native_and_numpy(case):
    rows = ROW_CASES[case]
    got = native.unique_rows(rows)
    _equal(got, jnative.unique_rows(rows))
    _equal(got, numpy_unique_rows(rows))


def test_unique_rows_branches_agree():
    """The same rows through both branches: shifting every entry by a
    constant keeps the lexicographic order, and a negative shift forces
    the row-compare branch."""
    rows = _rows(7, 5000, 3, 200)
    packed = native.unique_rows(rows)
    compared = native.unique_rows(rows - 1000)
    _equal(packed[1:], compared[1:])
    assert np.array_equal(packed[0], compared[0] + 1000)


TRANSPOSE_CASES = {
    "cells": (np.random.default_rng(8).integers(0, 500, (900, 6)), 500),
    "unused_nodes": (np.random.default_rng(9).integers(0, 200, (50, 3)),
                     400),
    "flat_large": (np.random.default_rng(10).integers(0, 3000, 40000), 3000),
}


@pytest.mark.parametrize("k_pad", [None, 64])
@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_build_transpose_equal_jax_native_and_numpy(case, k_pad):
    nodes, n_nodes = TRANSPOSE_CASES[case]
    flat = np.asarray(nodes, dtype=np.int32).ravel()
    got = native.build_transpose(flat, n_nodes, k_pad)
    _equal(got, jnative.build_transpose(flat, n_nodes, k_pad))
    _equal(got, _numpy_scatter_transpose(flat, n_nodes, k_pad))
    _equal(got, build_scatter_transpose(nodes, n_nodes, k_pad))
    if k_pad is not None:
        assert got[1] == k_pad


def test_build_transpose_rejects_out_of_range_nodes():
    with pytest.raises(ValueError):
        native.build_transpose(np.array([0, 5], np.int32), 5)
    with pytest.raises(ValueError):
        native.build_transpose(np.array([-1, 2], np.int32), 5)


MESHES = {
    "hyper_cube_2d_8": lambda g: g.hyper_cube(2, 8),
    "hyper_cube_3d_4": lambda g: g.hyper_cube(3, 4),
    "spherical_shell_3d_3": lambda g: g.spherical_shell(3, (0.5, 1.0), 3),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_topology_equals_jax(name):
    tmesh, tmarkers = MESHES[name](tgen)[:2]
    jmesh, jmarkers = MESHES[name](jgen)[:2]
    for attr in TOPOLOGY:
        assert np.array_equal(getattr(tmesh, attr), getattr(jmesh, attr)), \
            attr
    assert np.array_equal(tmarkers.facet_ids, jmarkers.facet_ids)
    assert np.array_equal(tmarkers.values, jmarkers.values)


def test_no_native_takes_the_numpy_versions(monkeypatch):
    rows = ROW_CASES["w3"]
    flat = TRANSPOSE_CASES["cells"][0].astype(np.int32).ravel()
    with_lib = (native.unique_rows(rows), native.build_transpose(flat, 500))
    mesh_lib = tgen.hyper_cube(3, 3)[0]
    monkeypatch.setenv("NS_TPU_NO_NATIVE", "1")
    assert native.get_library() is None
    calls = []

    def spy(fn):
        def wrapped(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    import navierstokes_tpu_torch.mesh.core as core
    import navierstokes_tpu_torch.parallel.sharded as sharded

    monkeypatch.setattr(core, "unique_rows", spy(core.unique_rows))
    monkeypatch.setattr(sharded, "_numpy_scatter_transpose",
                        spy(sharded._numpy_scatter_transpose))
    _equal(native.unique_rows(rows), with_lib[0])
    _equal(native.build_transpose(flat, 500), with_lib[1])
    mesh_np = tgen.hyper_cube(3, 3)[0]
    assert calls.count("unique_rows") == 3      # rows, facets, edges
    assert calls.count("_numpy_scatter_transpose") == 1
    for attr in TOPOLOGY:
        assert np.array_equal(getattr(mesh_np, attr), getattr(mesh_lib, attr))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="NS_TPU_NO_NATIVE"):
        native.get_library()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        native.unique_rows(ROW_CASES["w3"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    lib = native.get_library()
    assert lib._name == str(native.library_path())
    assert native.library_path().parent == native.BUILD_DIR
    edited = tmp_path / "fastmesh.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    before = native.library_path()
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path() != before
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    built = native.build_library()
    assert built == native.library_path() and built.exists()
