"""The measured window: blocks of steps back to back for ``seconds`` of
host clock, and the sample of blocks whose input and output states the
check compares with the reference.

The rate is taken over every step of the window and all of its time: the
clock starts before the first block is enqueued and stops at a
synchronisation after the last.  At most two blocks are in flight, so the
host never runs far ahead of the device and the window ends within a
block of ``seconds``.  Snapshots (device copies of the state) are taken
before and after every block; a reservoir drawn from the seed keeps
``sample`` of the window's blocks, and the last block is always kept.  On
a card, CUDA events around each block's steps give its device time; the
quartiles of those times go beside the rate, since one graph can run at
two speeds from one process to the next."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def block_quartiles(block_ms):
    """``[min, q1, median, q3, max]`` of the blocks' device times, or
    None without any."""
    if not block_ms:
        return None
    q = np.quantile(np.asarray(block_ms), [0.0, 0.25, 0.5, 0.75, 1.0])
    return [float(v) for v in q]


def run_window(stepper, seconds, seed, sample, device):
    """``(steps, elapsed, pairs, block_ms)``: steps and seconds of the
    window, the kept blocks as ``(index, input snapshot, output snapshot,
    stepper.trajectory after the block)``, and each block's device
    milliseconds (on a card)."""
    rng = np.random.default_rng([int(seed), 1])
    cuda = torch.device(device).type == "cuda"
    kept, in_flight, marks = [], deque(), []
    sync(device)
    steps0 = stepper.steps
    t0 = time.perf_counter()
    i = 0
    while True:
        stepper.begin_block()
        inp = stepper.snapshot()
        if cuda:
            marks.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
        stepper.advance()
        if cuda:
            marks[-1][1].record()
        last = (i, inp, stepper.snapshot(), stepper.trajectory)
        if i < sample:
            kept.append(last)
        else:
            j = int(rng.integers(0, i + 1))
            if j < sample:
                kept[j] = last
        i += 1
        if cuda:
            in_flight.append(marks[-1][1])
            if len(in_flight) > 2:
                in_flight.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    pairs = sorted({p[0]: p for p in kept + [last]}.values(),
                   key=lambda p: p[0])
    block_ms = [a.elapsed_time(b) for a, b in marks]
    return stepper.steps - steps0, elapsed, pairs, block_ms
