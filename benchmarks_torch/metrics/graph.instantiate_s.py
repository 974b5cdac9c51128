"""``graph.instantiate_s``: ``ChunkLoop.instantiate_seconds``, the host
seconds of instantiating the captured chunk's graph (the program's
``graph.instantiate`` span)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").loop_value(
        run, "instantiate_seconds")
