"""The roofline's count functions against hand-counted shapes, and the
trace reduction on made-up intervals."""

import gpubench_small  # noqa: F401
import numpy as np
import pytest

from gpubench import roofline, tracing
from gpubench.reference.banded import band_offset


@pytest.mark.parametrize("m,n,band", [(2, 2, 4), (5, 9, 8), (9, 5, 8),
                                      (30, 31, 16), (1, 1, 128),
                                      (100, 70, 64)])
def test_live_cells_count_the_band_cells_inside_the_matrix(m, n, band):
    lo = band_offset(m, n, band)
    want = sum(1 for i in range(1, m + 1) for b in range(band)
               if 0 <= i + lo + b <= n)
    assert roofline.live_cells([m], [n], band)[0] == want


def test_work_of_a_hand_counted_pair():
    # m = n = 2, band 4: lo = -2; row 1 holds b = 1..3, row 2 b = 0..2
    assert roofline.live_cells([2], [2], 4)[0] == 6
    # 15 ops a live cell and 4 a pair; q 2 + t 3 + scalars 12 + matrix
    # 144 + a direction byte a cell 6 + end state 16 bytes
    assert roofline.banded_work([2], [2], 4) == (94, 183)
    # forward: 17 flops a cell; q 2, t 2, 12, 144 in; 4 a cell, 4 a row,
    # 4 a pair out
    assert roofline.pairhmm_work("pairhmm_fwd", [2], [2], 4) == (102, 196)
    # backward: fM in and the posterior out, 8 a cell
    assert roofline.pairhmm_work("pairhmm_bwd", [2], [2], 4) == (132, 220)
    assert roofline.traceback_work(10, 1) == (80, 40)
    assert roofline.least_seconds(16.7e12, 1.0, "int32") == 1.0
    assert roofline.least_seconds(1.0, 3.35e12, "fp32") == 1.0


def test_union_gaps_and_cover():
    union = tracing.merge([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert union == [(0, 3), (5, 9)]
    assert tracing.covered(union, 1, 6) == 3
    assert tracing.gaps(union, -1, 12) == [(-1, 0), (3, 5), (9, 12)]


def test_idle_gaps_are_named_by_the_innermost_host_event():
    tr = tracing.Trace(
        device=[("void banded_dp_warp_kernel<4>(int*)", 0, 10),
                ("void banded_dp_kernel<2>(int*)", 10, 12),
                ("banded_traceback_kernel", 30, 35),
                ("Memcpy DtoH (Device -> Pageable)", 60, 61)],
        host=[("gpubench.call", 0, 100),
              ("gpubench.moves_to_ops", 12, 29),
              ("aten::copy_", 40, 59)])
    out = tracing.breakdown(tr, 0, 100)
    assert dict(out["device_ops"]) == pytest.approx(
        {"banded_dp_warp_kernel<4>": 10e-6, "banded_dp_kernel<2>": 2e-6,
         "banded_traceback_kernel": 5e-6,
         "Memcpy DtoH (Device -> Pageable)": 1e-6})
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"gpubench.moves_to_ops": 18e-6, "aten::copy_": 25e-6,
         "gpubench.call": 39e-6})
    assert tracing.kernel_seconds(tr, ("banded_dp_kernel",), 0, 100) == \
        pytest.approx(2e-6)
    assert tracing.kernel_seconds(
        tr, ("banded_dp_warp_kernel", "banded_dp_kernel"), 0, 100) == \
        pytest.approx(12e-6)


def test_shares_never_pass_100_on_a_kernel_at_its_bound():
    """A kernel whose device time equals its least time reads 100%."""
    from types import SimpleNamespace

    class Drv:
        kernels = {"banded_dp": ("banded_dp_kernel",)}

        def work(self, c, spec, answers):
            return {"banded_dp": (16.7e6, 0, "int32")}

    tr = tracing.Trace(device=[("banded_dp_kernel", 0.0, 1.0)])
    ctx = SimpleNamespace(driver=Drv(), done=[(0, None)], trace=tr, lo=0.0,
                          hi=10.0, workload={"calls": [{}]})
    assert roofline.kernel_share(ctx, "banded_dp") == pytest.approx(100.0)
    assert roofline.kernel_share(ctx, "pairhmm_fwd") is None
    assert np.isfinite(roofline.least_seconds(*roofline.window_work(
        ctx, "banded_dp")))
