"""``circulant_pcg_roofline``: percent of the least time of the traced
steps' whole-solve PCG calls (``work.pcg_work`` at the peaks of
``work.py``) over the device time of both PCG kernels."""

from harness.spec import load_module

KERNELS = ("circulant_pcg_cluster_kernel", "circulant_pcg_grid_kernel")


def read(run):
    work = load_module("metrics", "work")
    records = [r[1:] for r in run.launches if r[0] == "circulant_pcg"]
    return work.roofline_share(records, run.trace["kernel_s"], KERNELS)
