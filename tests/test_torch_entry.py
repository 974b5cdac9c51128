"""Port parity: ``navierstokes_tpu_torch/entry.py`` against
``__graft_entry__.py``.

CPU, float64.  ``entry()``'s one step of the 32^2 Taylor-Green vortex
(the structured spectral step) equals ``__graft_entry__.entry()``'s to
1e-12 relative: each state entry (U, U_old, Uh, Uh_old, Ph) against its
largest component in max-norm (the spectral pressure's imaginary part is
roundoff, 1.6e-10 beside a real part of 130).  ``dryrun_multidevice(4)``
runs the four checks of ``dryrun_multichip`` over four CPU shards with
their float64 tolerances.  Its stationary check runs the cavity at 6^2
instead of 12^2 and with FGMRES restarts of 30 (as the other PCD tests
here): at 12^2 its two PCD solves take 29 s on one CPU thread, nearly
this file's 30 s budget (at 6^2: 8 s for the whole dry run); the other
checks keep their sizes.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax

import __graft_entry__ as graft
from navierstokes_tpu_torch.entry import dryrun_multidevice, entry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_entry_step_matches_graft_entry():
    jfn, jargs = graft.entry()
    want = jfn(*jargs)
    fn, args = entry(device="cpu")
    assert args[0].dtype == torch.float64
    got = fn(*args)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        gl = [t.numpy() for t in pytree.tree_leaves(g)]
        wl = [np.asarray(a) for a in jax.tree_util.tree_leaves(w)]
        assert [a.shape for a in gl] == [a.shape for a in wl]
        scale = max(np.abs(a).max() for a in wl)
        err = max(np.abs(a - b).max() for a, b in zip(gl, wl)) / scale
        assert err <= 1e-12, err
    assert all(bool(torch.isfinite(t).all()) for t in pytree.tree_leaves(got))


def test_entry_needs_a_card():
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun_multidevice(4)


def test_dryrun_multidevice_four_cpu_shards(monkeypatch, capsys):
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "30")
    errs = dryrun_multidevice(4, device="cpu", cavity_n=6)
    assert errs["halo"] < 1e-9
    assert errs["spectral"] < 1e-12
    assert errs["stationary"] < 1e-6
    assert "dryrun_multidevice: 4 shards" in capsys.readouterr().out
