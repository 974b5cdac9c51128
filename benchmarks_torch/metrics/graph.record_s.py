"""``graph.record_s``: ``ChunkLoop.record_seconds``, the host seconds of
enqueuing one chunk's steps under stream capture (the program's
``graph.record`` span)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").loop_value(
        run, "record_seconds")
