"""What the program's own tracing holds for a run, for the readers of
``setup.*``, ``graph.*``, ``step.*`` and ``amg.vcycle_ms``: the latest
build of a span of ``navierstokes_tpu_torch/utils/monitor.py``, a value
of the run's ``utils/graph.ChunkLoop``, and a step phase's ms per step
from one ``ChunkLoop.phase_ms()`` per run.  Each gives None where the
program has no such tracing or the run has nothing to read (a loop on
the CPU captures no graph)."""


def latest_span(name):
    """Seconds of the latest build of the program's span ``name``."""
    from navierstokes_tpu_torch.utils import monitor

    latest = getattr(monitor, "latest", None)
    return None if latest is None else latest(name)


def loop_value(run, name):
    """Attribute ``name`` of the run's chunk loop."""
    return getattr(getattr(run.stepper, "loop", None), name, None)


def phase_ms(run, name):
    """Ms per step of phase ``name``: device time from marks in a short
    graph of the loop's step on a card, host time of eager steps on the
    CPU.  The phases are measured once per run, by the first of these
    readers (they come after the others in ``BENCHMARK.json``), and kept
    on ``run``."""
    if not hasattr(run, "phase_ms"):
        measure = loop_value(run, "phase_ms")
        run.phase_ms = {} if measure is None else measure().phases
    return run.phase_ms.get(name)
