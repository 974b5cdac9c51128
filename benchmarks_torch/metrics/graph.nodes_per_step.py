"""``graph.nodes_per_step``: ``ChunkLoop.nodes``, the node count of the
captured chunk's graph, per step of the chunk."""

from harness.spec import load_module


def read(run):
    nodes = load_module("metrics", "program_trace").loop_value(run, "nodes")
    return None if nodes is None else nodes / run.stepper.block_steps
