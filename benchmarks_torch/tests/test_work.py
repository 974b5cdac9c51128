"""The copied work and bound functions reproduce the bounds of PERF.md's
kernel table for the torus step at 128^2 (NVIDIA H100 peaks, f32)."""

import pytest
import torch

from harness.spec import load_module

work = load_module("metrics", "work")
N, NP = 65536, 16384        # P2 nodes (one plane) and P1 nodes at 128^2


def solve_case(K, n, batch, iters, meanfree, masked=False):
    band = torch.zeros((K, n))
    b = torch.zeros((batch, n))
    mask = torch.ones((batch, n)) if masked else None
    return (band, list(range(K)), b, b, torch.zeros(n), mask, iters,
            meanfree)


def test_apply_bound_128():
    nbytes, flops = work.apply_work(23, N, 2, 4)
    ms, by = work.bound(nbytes, flops, torch.float32)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(2.11, abs=0.005)


def test_three_torus_solves_bound():
    cases = [solve_case(23, N, 2, 10, False), solve_case(9, NP, 1, 60, True),
             solve_case(23, N, 2, 6, False)]
    works = [work.pcg_work(c) for c in cases]
    per_solve = [work.bound(b, f, torch.float32) for b, f in works]
    assert [round(ms * 1e3, 2) for ms, _ in per_solve] == [2.50, 0.46, 2.50]
    assert [by for _, by in per_solve] == ["bytes", "operations", "bytes"]
    # the table's row for the three solves bounds their summed work
    ms, by = work.bound(sum(b for b, _ in works), sum(f for _, f in works),
                        torch.float32)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(5.28, abs=0.005)


def test_roofline_share_needs_both_sides():
    rec = [(3.35e6, 0.0, torch.float32)]          # 1 us at the peak rate
    assert work.roofline_share(rec, {"x_kernel": 2e-6}, ("x_kernel",)) == \
        pytest.approx(50.0)
    assert work.roofline_share(rec, {"other": 2e-6}, ("x_kernel",)) is None
    assert work.roofline_share([], {"x_kernel": 2e-6}, ("x_kernel",)) is None
