"""Rate and tail over all the calls of a window, a stall included; the
whole run on the CPU with small traffic."""

import json
import os
import time

import gpubench_small
import pytest
import torch

from gpubench import harness, stats


def test_p95_is_the_nearest_rank_over_all_values():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([3.0] * 19 + [50.0]) == 3.0
    assert stats.p95([3.0] * 18 + [50.0, 60.0]) == 50.0
    assert stats.p95([7]) == 7
    with pytest.raises(ValueError):
        stats.p95([])
    assert stats.rate(10, 4) == 2.5


def test_spread_is_the_interquartile_share_of_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_a_stall_counts_in_the_rate_and_the_tail(tmp_path, monkeypatch):
    """One call in ten stalls 30 ms: the p95 is at least the stall, and
    the rate is no more than the window's bases over the stalls' time.
    The gap-fill cell, its calls short on the CPU, with the rate and tail
    asked of every cell in the small root's BENCHMARK.json."""
    from cactus_tpu_torch.ops import banded
    root = gpubench_small.small_root(tmp_path)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    with open(path, "w") as fh:
        json.dump(bench, fh)
    real = banded.align_pairs_banded
    seen = {"calls": 0, "stalls": 0}

    def stalling(*a, **k):
        seen["calls"] += 1
        if seen["calls"] % 10 == 0:
            seen["stalls"] += 1
            time.sleep(0.03)
        return real(*a, **k)

    monkeypatch.setattr(banded, "align_pairs_banded", stalling)
    r = harness.run_cell("mammals-gapfill", 5, 0.6, False,
                         time.perf_counter(), device=torch.device("cpu"),
                         root=root)
    assert r["correct"]
    m = r["metrics"]
    assert m["call_p95_ms"]["value"] >= 30.0
    calls = r["attempted"]
    window_stalls = seen["stalls"] - 0     # warm-up has 2 calls, no stall
    bases_per_call = 2 * 4 * 48            # small_root: 4 pairs of <= 48
    assert m["aligned_bases_per_s"]["value"] <= (
        calls * bases_per_call / (window_stalls * 0.03))
    assert set(m) == {"aligned_bases_per_s", "call_p95_ms",
                      "device_peak_mib", "setup_s"}


@pytest.mark.parametrize("cell, names", [
    ("mammals-gapfill", {"device_peak_mib", "setup_s"}),
    ("pecan-posterior", {"call_p95_ms", "device_peak_mib", "setup_s"})])
def test_a_cell_reports_only_its_end_to_end_metrics(tmp_path, cell, names):
    """The rate and tail stand end to end only in the cells that their
    `workloads` name."""
    root = gpubench_small.small_root(tmp_path, max_pairs=2, max_len=40,
                                     calls=1)
    r = harness.run_cell(cell, 7, 0.2, False, time.perf_counter(),
                         device=torch.device("cpu"), root=root)
    assert r["correct"]
    assert set(r["metrics"]) == names


@pytest.mark.parametrize("cell", ["mammals-gapfill", "mammals-nested",
                                  "pecan-posterior"])
def test_a_traced_run_reads_its_layers(tmp_path, cell):
    """--trace 1 on the CPU: the per-layer metrics that have something to
    read there (no device events, no kernel launches) and the breakdown."""
    root = gpubench_small.small_root(tmp_path, max_pairs=2, max_len=40,
                                     calls=1)
    r = harness.run_cell(cell, 2**31 + 11, 0.2, True, time.perf_counter(),
                         device=torch.device("cpu"), root=root)
    assert r["correct"]
    m = r["metrics"]
    sfx = ".gapfill" if cell == "mammals-gapfill" else ""
    assert m["device_idle_share" + sfx]["value"] == 100.0
    assert m["host_ms_per_call" + sfx]["value"] > 0
    if cell != "mammals-nested":
        assert m["traced_bases_per_s" + sfx]["value"] > 0
    if cell == "mammals-gapfill":
        assert m["traced_call_p95_ms"]["value"] > 0
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_a_repeated_answer_is_kept_once_and_a_changed_one_is_kept():
    kept = []
    for _ in range(50):
        harness.keep(kept, [(0, 1, 0.9)])
    assert kept == [[(0, 1, 0.9)]]
    harness.keep(kept, [(0, 2, 0.9)])
    harness.keep(kept, None)
    assert kept == [[(0, 1, 0.9)], [(0, 2, 0.9)], None]
    for k in range(100):
        harness.keep(kept, [(k, k, 0.5)])
    assert len(kept) == harness.MAX_DISTINCT


def test_a_fault_that_starts_after_the_first_passes_fails_the_run(
        tmp_path, monkeypatch):
    """Answers held against the first pass's: a score off by one from
    the fifth call on is still seen."""
    from cactus_tpu_torch.ops import banded
    root = gpubench_small.small_root(tmp_path, calls=1)
    real = banded.align_pairs_banded
    seen = {"calls": 0}

    def late(*a, **k):
        seen["calls"] += 1
        out = real(*a, **k)
        if seen["calls"] >= 5:
            out = [(s + 1, ops) for s, ops in out]
        return out

    monkeypatch.setattr(banded, "align_pairs_banded", late)
    r = harness.run_cell("mammals-gapfill", 9, 0.3, False,
                         time.perf_counter(), device=torch.device("cpu"),
                         root=root)
    assert seen["calls"] > 5
    assert not r["correct"]
    assert r["checks"]["score_mismatches"]["value"] > 0
