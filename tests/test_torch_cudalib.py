"""The kernel library (``navierstokes_tpu_torch/cudalib.py``) on the CPU.

Its sources are every ``csrc/*.cu`` and its hash covers the headers; an
entry point is resolved once with the C interface its wrapper declares,
and every wrapper's declaration matches the C source; ``launched()``
leaves out the families at zero; the shared device helpers live in
``csrc/common.cuh`` only; and the layers below the solvers import none of
them.  Nothing here needs nvcc or a card.
"""

import ast
import ctypes
import re
import shutil
from pathlib import Path

import pytest
import torch

from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.assembly import cuda_amg, cuda_band
from navierstokes_tpu_torch.structured import cuda_conv, cuda_modal

PKG = Path(cudalib.__file__).resolve().parent


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the library reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(cudalib.CSRC, copy)
    monkeypatch.setattr(cudalib, "CSRC", copy)
    return copy


def test_sources_are_every_cu_file(csrc_copy):
    """A new kernel's ``.cu`` is built without a list entry; headers are
    included, not compiled."""
    names = [p.name for p in cudalib.sources()]
    assert {"amg_pcg.cu", "band.cu", "structured_conv.cu"} <= set(names)
    assert "common.cuh" not in names
    (csrc_copy / "new_kernel.cu").write_text("// a new family\n")
    assert cudalib.sources() == sorted(csrc_copy.glob("*.cu"))
    assert "new_kernel.cu" in [p.name for p in cudalib.sources()]


@pytest.mark.parametrize("name", ["common.cuh", "band.cu"])
def test_library_path_follows_every_source_and_header(csrc_copy, name):
    before = cudalib.library_path()
    assert before.parent == cudalib.BUILD_DIR
    with open(csrc_copy / name, "a") as f:
        f.write("// edited\n")
    after = cudalib.library_path()
    assert after != before and after.parent == before.parent
    # a file that is neither source nor header changes nothing
    (csrc_copy / "notes.txt").write_text("not a source\n")
    assert cudalib.library_path() == after


def test_launched_leaves_out_zeros():
    saved = dict(cudalib.LAUNCHES)
    try:
        cudalib.reset_launch_counts()
        assert cudalib.launched() == {}
        cudalib.LAUNCHES["amg_pcg"] += 2
        cudalib.LAUNCHES["circulant_apply"] += 1
        assert cudalib.launched() == {"amg_pcg": 2, "circulant_apply": 1}
        cudalib.reset_launch_counts()
        assert cudalib.launched() == {}
        assert {"amg_pcg", "circulant_apply"} <= set(cudalib.LAUNCHES)
    finally:
        cudalib.LAUNCHES.update(saved)


def test_entry_resolves_once_with_its_interface(monkeypatch):
    class Fn:
        pass

    class Lib:
        ns_some_kernel_f32 = Fn()
        ns_some_kernel_f64 = Fn()

    loads = []

    def load():
        loads.append(1)
        return Lib

    monkeypatch.setattr(cudalib, "load_library", load)
    cudalib.entry.cache_clear()
    try:
        args = (ctypes.c_int, ctypes.c_void_p)
        fn = cudalib.entry("some_kernel", torch.float32, args)
        assert fn is Lib.ns_some_kernel_f32
        assert fn.argtypes == list(args) and fn.restype is ctypes.c_int
        assert cudalib.entry("some_kernel", torch.float32, args) is fn
        assert cudalib.entry("some_kernel", torch.float64, args) is \
            Lib.ns_some_kernel_f64
        assert len(loads) == 2
    finally:
        cudalib.entry.cache_clear()


def test_offsets_are_checked_against_the_cap():
    offsets, arr = cudalib.check_offsets([0, 3, 1], 4, 3)
    assert offsets == (0, 3, 1) and list(arr) == [0, 3, 1]
    with pytest.raises(ValueError, match="1 to 2"):
        cudalib.check_offsets([0, 1, 2], 4, 2)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        cudalib.check_offsets([0, 4], 4, 8)


# ---------------------------------------------------------------------------
# the wrappers' C interfaces against the sources
# ---------------------------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "double": ctypes.c_double}


def _c_signatures():
    """``{entry name without suffix: [ctypes type per parameter]}`` of
    every ``ns_*_f32`` function of ``csrc/*.cu``."""
    out = {}
    for src in cudalib.sources():
        text = src.read_text()
        for name, params in re.findall(r"\bint ns_(\w+)_f32\(([^)]*)\)",
                                       text):
            types = []
            for param in params.split(","):
                decl = " ".join(param.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if "*" in param
                             else _C_TYPES[decl])
            out[name] = types
    return out


DECLARED = {
    "circulant_apply": cuda_band.APPLY_ARGS,
    "circulant_pcg_prepare": cuda_band.PREPARE_ARGS,
    "circulant_pcg": cuda_band.PCG_ARGS,
    "amg_pcg_prepare": cuda_amg.PREPARE_ARGS,
    "amg_pcg": cuda_amg.AMG_PCG_ARGS,
    "structured_conv_quadrature": cuda_conv.QUADRATURE_ARGS,
    "structured_conv_scatter": cuda_conv.SCATTER_ARGS,
    "spectral_helmholtz": cuda_modal.HELMHOLTZ_ARGS,
    "spectral_poisson": cuda_modal.POISSON_ARGS,
    "spectral_correction": cuda_modal.CORRECTION_ARGS,
}


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_wrapper_declares_the_source_interface(name):
    assert list(DECLARED[name]) == _c_signatures()[name]


def test_shared_helpers_live_in_the_header_only():
    header = (cudalib.CSRC / "common.cuh").read_text()
    helpers = re.findall(r"__device__ __forceinline__ \w+ (\w+)\(", header)
    helpers += re.findall(r"^struct (\w+)", header, re.M)
    assert {"nonzero", "mul_rn", "add_rn", "warp_total", "cluster_barrier",
            "PairOf"} <= set(helpers)
    for src in cudalib.sources():
        text = src.read_text()
        for name in set(helpers):
            defined = re.search(
                r"(__forceinline__ [\w<>:]+ %s\(|struct %s\b)" % (name, name),
                text)
            assert not defined, f"{src.name} defines {name} again"
        if any(re.search(r"\b%s\b" % name, text) for name in helpers):
            assert '#include "common.cuh"' in text, src.name


# ---------------------------------------------------------------------------
# layering
# ---------------------------------------------------------------------------

def _imports(path):
    """Every module ``path`` imports, at the top or inside a function."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module] + [f"{node.module}.{a.name}"
                                      for a in node.names]
    return names


def _files(*parts):
    for part in parts:
        path = PKG / part
        yield from (sorted(path.rglob("*.py")) if path.is_dir() else [path])


@pytest.mark.parametrize("files,forbidden", [
    (("assembly", "linalg", "structured", "utils", "cudalib.py"),
     "navierstokes_tpu_torch.solvers"),
    (("utils", "cudalib.py"), "navierstokes_tpu_torch.assembly"),
    (("cudalib.py",), "navierstokes_tpu_torch.structured"),
], ids=["below_solvers", "below_assembly", "cudalib"])
def test_lower_layers_import_no_upper_layer(files, forbidden):
    bad = [(str(f.relative_to(PKG)), name) for f in _files(*files)
           for name in _imports(f)
           if name == forbidden or name.startswith(forbidden + ".")]
    assert not bad


def test_cudalib_imports_only_torch_and_the_monitor():
    port = {name for name in _imports(PKG / "cudalib.py")
            if name.startswith("navierstokes_tpu_torch")}
    assert port <= {"navierstokes_tpu_torch.utils",
                    "navierstokes_tpu_torch.utils.monitor"}
