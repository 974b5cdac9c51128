"""The benchmark of the PyTorch and CUDA port (``navierstokes_tpu_torch``).

    python3 benchmarks_torch/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the card it is started on: set-up (imports, device context, the program's
build, warm-up steps, graph capture), a window of ``--seconds`` of steps,
with ``--trace 1`` a traced segment after it, then the check against the
plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``; ``checks`` last); the last lines of standard
error give each compared number beside its limit.  Without a CUDA device,
or with fewer cards than the cell asks for, it prints no result and exits
with 2.  The program's kernels build once into the checkout
(``navierstokes_tpu_torch/_build/``); other compiler caches are pointed at
``benchmarks_torch/_cache/``."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / "_cache" / sub)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    stages = {"interpreter_and_arguments": time.perf_counter() - START}
    t = time.perf_counter()
    import torch

    stages["torch_import"] = time.perf_counter() - t
    t = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    stages["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    from harness.cell_run import report_checks, run_cell

    stages["harness_import"] = time.perf_counter() - t
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", START, stages=stages)
    report_checks(result)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
