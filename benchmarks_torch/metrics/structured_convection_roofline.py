"""``structured_convection_roofline``: percent of the least time of the
structured convection (``structured_work.convection_least_ms`` of the
loop's class grids) over the device ms per step of its three phases,
``convection.gather``, ``convection.quadrature`` and
``convection.scatter`` (``ChunkLoop.phase_ms()``).  None without a
captured graph: on the CPU the phases are host time."""

from harness.spec import load_module

PHASES = ("convection.gather", "convection.quadrature",
          "convection.scatter")


def read(run):
    trace = load_module("metrics", "program_trace")
    if trace.loop_value(run, "graph") is None:
        return None
    ms = [trace.phase_ms(run, name) for name in PHASES]
    if None in ms or sum(ms) <= 0.0:
        return None
    U = trace.loop_value(run, "state")[0]
    least_ms = load_module("metrics", "structured_work").convection_least_ms(
        U.shape, U.element_size())
    return 100.0 * least_ms / sum(ms)
