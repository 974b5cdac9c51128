"""Port parity: ``navierstokes_tpu_torch/bench.py`` against ``bench.py``,
and the chunk loop ``navierstokes_tpu_torch/utils/graph.ChunkLoop``.

CPU, float64.  ``bench.py`` runs in-process, unedited: its module
constants (``N_POINTS``, ``N_STEPS``, ``CHUNK``, ``LOOP``, ``DIM``) are set
with ``monkeypatch``, and its path functions run in its default ``scan``
loop on the conftest's x64 CPU backend.  The port's path functions run
the same configuration, 2D at 8^2 and 3D at 4^3, 4 warm-up steps, then
(``scan``) one untimed and one timed chunk of 2 steps, or (``dispatch``)
4 steps: 8 steps in all either way.  Checks, per path and dimension:

* the same ``quality`` keys, ``amp_rel_err`` equal (both rounded to 5
  digits);
* ``cg_residuals`` within 1e-9 relative, or 1e-11 absolute (1e-13 of
  100, a bound on every right-hand side's norm at these sizes) where a
  residual sits at the roundoff of its CG recurrence.  Gaps measured: 2D
  Helmholtz 7.3e-19 and mass 1.1e-21 absolute (3.3e-12 and 1.9e-11
  relative); both Poisson residuals 1e-90 to 0 after 60 sweeps; 3D mass
  6.1e-19; the 3D Helmholtz solve (rhs norm 58.6) converges to 2.9e-10
  in its 10 iterations, its floor, where the packages differ by 1.08e-12
  (1.8e-14 of the rhs norm, 3.7e-3 of the residual);
* the final state (u and p) against the JAX package's own
  ``build_planar_projection_step`` / ``build_spectral_projection_step``
  stepped 8 times from the same state: max-norm differences relative to
  the field's largest entry (to the velocity's for a field that is zero
  in the exact solution: the 3D shear wave's pressure), within 1e-12 or,
  where larger, 4 times the port's own change under a one-ulp
  perturbation of the initial velocity.  Measured: gaps 5e-17 to 7.6e-14
  beside spreads of 1.4e-16 to 1.4e-13 on three cases; on the 3D banded
  path, whose fixed-iteration solves run past convergence at 4^3 on a
  flow with zero pressure, one ulp moves u by 5.7e-12 and p by 1.9e-10
  of max|u| (6^3: 2.3e-9 and 7.5e-8), and the packages differ by 3.9e-12
  and 2.5e-10;
* ``scan`` and ``dispatch`` bit for bit equal on the CPU (the chunk loop
  there is the eager steps, the graph's plain version).

Without a card, every entry point on a CUDA device raises, as do
``bench.main()`` and a ``ChunkLoop``; a chunk whose step reads the
device on the host (a solve with ``cg_rtol``) raises ``CaptureError``.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
from __graft_entry__ import _taylor_green_setup as jax_tg_setup
from navierstokes_tpu.assembly.fastop import FastTaylorHood as JaxFast
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_planar_step
from navierstokes_tpu.structured import PeriodicStructuredTH as JaxGrid
from navierstokes_tpu.structured import \
    build_spectral_projection_step as jax_spectral_step
from navierstokes_tpu_torch import bench
from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
from navierstokes_tpu_torch.setups import taylor_green_setup
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.utils.graph import CaptureError, ChunkLoop

SIZES = {2: 8, 3: 4}
N_STEPS, CHUNK = 4, 2
TOTAL = bench.N_WARMUP + N_STEPS
CASES = [(path, dim) for path in ("structured", "generic") for dim in (2, 3)]
RUN = dict(chunk=CHUNK, n_steps=N_STEPS, dtype=torch.float64, device="cpu")

_spaces, _jax, _port = {}, {}, {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def spaces(dim):
    if dim not in _spaces:
        n = SIZES[dim]
        _spaces[dim] = (taylor_green_setup(n, dim=dim),
                        jax_tg_setup(n, dim=dim))
    return _spaces[dim]


def jax_quality(path, dim):
    """``bench.py``'s path function in its default scan loop."""
    if (path, dim) not in _jax:
        mp = pytest.MonkeyPatch()
        try:
            for name, value in (("DIM", dim), ("N_POINTS", SIZES[dim]),
                                ("N_STEPS", N_STEPS), ("CHUNK", CHUNK),
                                ("LOOP", "scan")):
                mp.setattr(jax_bench, name, value)
            fn = {"structured": jax_bench._bench_structured,
                  "generic": jax_bench._bench_generic}[path]
            _, n_timed, finite, quality = fn(*spaces(dim)[1])
        finally:
            mp.undo()
        assert finite and n_timed == CHUNK
        _jax[path, dim] = quality
    return _jax[path, dim]


def port_run(path, dim, loop):
    """The port's path function; ``loop`` "perturbed" is the dispatch loop
    from the initial velocity moved by one ulp (a fixed sign pattern)."""
    if (path, dim, loop) not in _port:
        fn = {"structured": bench.bench_structured,
              "generic": bench.bench_generic}[path]
        space, u0, p0 = spaces(dim)[0]
        run_loop = loop
        if loop == "perturbed":
            signs = np.random.default_rng(0).choice([-1.0, 1.0], u0.shape)
            u0, run_loop = u0 * (1.0 + 2.0 ** -52 * signs), "dispatch"
        _port[path, dim, loop] = fn(space, u0, p0, loop=run_loop, **RUN)
    return _port[path, dim, loop]


@pytest.mark.parametrize("path,dim", CASES)
def test_quality_matches_bench_py(path, dim):
    want = jax_quality(path, dim)
    for loop in ("scan", "dispatch"):
        _, n_timed, finite, got, _ = port_run(path, dim, loop)
        assert finite
        assert n_timed == (CHUNK if loop == "scan" else N_STEPS)
        assert set(got) == set(want)
        assert got["amp_rel_err"] == want["amp_rel_err"]
        if path == "generic":
            assert len(got["cg_residuals"]) == 3
            for g, w in zip(got["cg_residuals"], want["cg_residuals"]):
                assert abs(g - w) <= max(1e-9 * abs(w), 1e-11), (g, w)


def jax_state(path, dim):
    """The JAX package's own step, TOTAL steps from the bench's state
    (BDF-1, then BDF-2), as host arrays."""
    jspace, u0, p0 = spaces(dim)[1]
    one = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    a1, a2 = tuple(map(one, bench.ALPHA1)), tuple(map(one, bench.ALPHA2))
    e1, e2 = tuple(map(one, bench.ETA1)), tuple(map(one, bench.ETA2))
    if path == "structured":
        step, init_state, read_state = jax_spectral_step(
            JaxGrid(jspace), visc=1.0 / bench.RE, dt=bench.DT,
            dtype=jnp.float64)
        state = init_state(u0.reshape(-1), u0.reshape(-1), p0)
        for i in range(TOTAL):
            state = step(state, *((a1, e1) if i == 0 else (a2, e2)))
        return [np.asarray(a) for a in read_state(state)]
    fast = JaxFast(jspace)
    step = jax_planar_step(fast, visc=1.0 / bench.RE, dt=bench.DT,
                           cg_iters=(10, bench.P_SWEEPS, 6))
    u = fast.permute_velocity(jnp.asarray(u0.T, jnp.float64))
    p = fast.permute_pressure(jnp.asarray(p0, jnp.float64))
    u_old, phi = u, jnp.zeros_like(p)
    for i in range(TOTAL):
        u_new, p, phi = step(u, u_old, p, phi,
                             *((a1, e1) if i == 0 else (a2, e2)))
        u_old, u = u, u_new
    return [np.asarray(u), np.asarray(p)]


def host_fields(path, dim, state):
    """(u, p) of a port state as host arrays in the JAX result's layout."""
    if path == "structured":
        space = spaces(dim)[0][0]
        _, _, read_state = build_spectral_projection_step(
            PeriodicStructuredTH(space), visc=1.0 / bench.RE, dt=bench.DT,
            dtype=torch.float64, device="cpu")
        return list(read_state(state))
    return [state[0].numpy(), state[2].numpy()]


@pytest.mark.parametrize("path,dim", CASES)
def test_final_state_matches_jax_step(path, dim):
    want = jax_state(path, dim)
    got = host_fields(path, dim, port_run(path, dim, "scan")[4])
    moved = host_fields(path, dim, port_run(path, dim, "perturbed")[4])
    u_scale = np.abs(want[0]).max()
    for g, m, w in zip(got, moved, want):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        if scale < 1e-3 * u_scale:
            scale = u_scale
        spread = np.abs(m - g).max() / scale
        err = np.abs(g - w).max() / scale
        assert err <= max(1e-12, 4.0 * spread), (err, spread)


@pytest.mark.parametrize("path,dim", CASES)
def test_scan_equals_dispatch_on_cpu(path, dim):
    scan = torch.utils._pytree.tree_leaves(port_run(path, dim, "scan")[4])
    eager = torch.utils._pytree.tree_leaves(
        port_run(path, dim, "dispatch")[4])
    assert len(scan) == len(eager)
    assert all(torch.equal(a, b) for a, b in zip(scan, eager))


def test_entry_points_need_a_card():
    (space, u0, p0), _ = spaces(2)
    for fn in (bench.bench_structured, bench.bench_generic):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(space, u0, p0, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ChunkLoop(lambda s: s, (torch.zeros(3),), 2, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main()


def test_chunk_loop_refuses_host_reads():
    (space, u0, _), _ = spaces(2)
    fast = FastTaylorHood(space, dtype=torch.float64, device="cpu")
    step = build_planar_projection_step(fast, visc=0.01, dt=1e-3,
                                        cg_iters=(10, 60, 6), cg_rtol=1e-8)
    u = fast.permute_velocity(torch.tensor(u0.T))
    p = torch.zeros(fast.ops.diag_l.shape, dtype=torch.float64)

    def advance(state):
        u, u_old, p, phi = state
        u_new, p_new, phi_new = step(u, u_old, p, phi, bench.ALPHA2,
                                     bench.ETA2)
        return (u_new, u, p_new, phi_new)

    loop = ChunkLoop(advance, (u, u, p, p), 2, device="cpu")
    with pytest.raises(CaptureError, match="cg_rtol"):
        loop.run()


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_chunk_loop_steps_nested_states():
    """n = 1 and n = 3 chunks of a step over a nested state (a NamedTuple
    inside a tuple, the old state handed on) equal the eager steps; a
    step that changes the state's structure or shapes raises."""
    def step(state):
        x, pair = state
        return (2.0 * x + pair.a, _Pair(x, pair.a - pair.b))

    state0 = (torch.arange(4.0), _Pair(torch.ones(4), torch.full((4,), 3.0)))
    for n in (1, 3):
        loop = ChunkLoop(step, state0, n, device="cpu")
        want = state0
        for _ in range(2):
            for _ in range(n):
                want = step(want)
            got = loop.run()
            for g, w in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want)):
                assert torch.equal(g, w)
        assert loop.replays == 2
    with pytest.raises(ValueError, match="n >= 1"):
        ChunkLoop(step, state0, 0, device="cpu")
    with pytest.raises(ValueError, match="structure"):
        ChunkLoop(lambda s: s[0], state0, 2, device="cpu").run()
    with pytest.raises(ValueError, match="changed a state tensor"):
        ChunkLoop(lambda s: (s[0][:2], s[1]), state0, 2, device="cpu").run()
