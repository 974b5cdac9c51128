"""``graph.capture_s``: ``ChunkLoop.capture_seconds``, the warm-up step on
the side stream and the capture of one chunk as a CUDA graph."""


def read(run):
    return run.stepper.capture_seconds
