"""Readings that the limits of a cell's check are set from, on the card.

    python3 benchmarks_torch/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <s> [--trace-seeds 4]

runs the cell as ``run.py`` does, once per seed in one process (each run
builds, warms up and captures anew), and prints one JSON line per run:
the program's compared numbers and, for the seeds in
``--control-seeds``, the control's on the same blocks -- the reference
computed in bfloat16, or the program's step with TF32 matmuls, as the
workload's ``control`` says --, each also per kept block with the block's
place in its flow (``--check-blocks`` keeps more blocks than the
workload does, to read the gaps along the whole flow).  The benchmark's own runs never run the
control."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--trace-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--check-blocks", type=int, default=None,
                        help="keep this many blocks of each window "
                        "instead of the workload's check_blocks")
    args = parser.parse_args(argv)

    import torch

    from harness.cell_run import run_cell
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("control.py runs on a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.check_blocks is not None:
        cell.workload["check_blocks"] = args.check_blocks
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.trace_seeds]
    for seed, trace in runs:
        start = time.perf_counter()
        result = run_cell(cell, seed, args.seconds, trace, "cuda:0", start,
                          readings=True, control=seed in args.control_seeds)
        line = {"workload": args.workload, "seed": seed, "trace": trace,
                "correct": result["correct"],
                "checks": {k: v["value"] for k, v in
                           result["checks"].items()},
                "readings": result.get("readings"),
                "control": result.get("control"),
                "reading_blocks": result.get("reading_blocks"),
                "control_blocks": result.get("control_blocks"),
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()},
                "device": result["device"],
                "setup_stages": result["setup_stages"],
                "window": result["window"],
                "breakdown": result.get("breakdown"),
                "trace_blocks_ms": result.get("trace", {}).get("block_ms"),
                "run_s": time.perf_counter() - start}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
