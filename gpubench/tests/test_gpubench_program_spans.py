"""The readers of the program's spans and launched-cell counter
(gpubench/program_spans.py, metrics *_ms_per_call and
launched_live_share): on hand-built traces, and on a CPU traced window
of the nested cell."""

import time
from types import SimpleNamespace

import gpubench_small
import pytest
import torch

from gpubench import harness, manifest, tracing

STAGE_METRICS = ("pack_ms_per_call", "fetch_ms_per_call",
                 "unpack_ms_per_call")
NEW = STAGE_METRICS + ("entry_self_ms_per_call",)


def _ctx(host, entry="cactus.posterior_pairs_banded"):
    return SimpleNamespace(trace=tracing.Trace(host=list(host)),
                           driver=SimpleNamespace(entry_span=entry))


def _read(name, ctx):
    return manifest.reader(name)(ctx)


# two calls (us): the first 0-100 with its entry 10-90, pack 10-20,
# fetch 30-45 and unpack 45-85 (an aten op and a driver's span inside
# it); the second 200-300, entry 205-295, one pack 210-230 and a second
# 240-250; a pack at 150-160 outside every call
HOST = [
    ("gpubench.call", 0, 100), ("cactus.posterior_pairs_banded", 10, 90),
    ("cactus.pack", 10, 20), ("cactus.fetch", 30, 45),
    ("cactus.unpack", 45, 85), ("aten::copy_", 31, 44),
    ("gpubench.banded_hits", 29, 86),
    ("cactus.pack", 150, 160),
    ("gpubench.call", 200, 300),
    ("cactus.posterior_pairs_banded", 205, 295),
    ("cactus.pack", 210, 230), ("cactus.pack", 240, 250),
]


def test_stage_sums_per_call_ignore_spans_outside_every_call():
    ctx = _ctx(HOST)
    # pack: (10 + 20 + 10) us over 2 calls
    assert _read("pack_ms_per_call", ctx) == pytest.approx(40 / 2 / 1e3)
    assert _read("fetch_ms_per_call", ctx) == pytest.approx(15 / 2 / 1e3)
    assert _read("unpack_ms_per_call", ctx) == pytest.approx(40 / 2 / 1e3)
    assert _read("pack_ms_per_call.gapfill", ctx) == _read(
        "pack_ms_per_call", ctx)


def test_entry_self_is_the_entry_less_the_union_of_its_stages():
    # a second fetch overlapping the first: call 1's stages cover
    # 10-20 and 30-85, so 80 - 65; call 2: 90 - (20 + 10)
    ctx = _ctx(HOST + [("cactus.fetch", 40, 50)])
    assert _read("entry_self_ms_per_call", ctx) == pytest.approx(
        (80 - 65 + 90 - 30) / 2 / 1e3)
    assert _read("entry_self_ms_per_call.gapfill", ctx) == _read(
        "entry_self_ms_per_call", ctx)


def test_a_call_without_stage_spans_reads_0():
    host = [("gpubench.call", 0, 100), ("cactus.align_pairs_banded", 5, 95),
            ("gpubench.call", 200, 300),
            ("cactus.align_pairs_banded", 210, 290)]
    ctx = _ctx(host, entry="cactus.align_pairs_banded")
    for name in STAGE_METRICS:
        assert _read(name, ctx) == 0.0
    assert _read("entry_self_ms_per_call", ctx) == pytest.approx(
        (90 + 80) / 2 / 1e3)


@pytest.mark.parametrize("entry, want", [
    ("cactus.posterior_pairs_banded", (80 - 65 + 90 - 30) / 2 / 1e3),
    ("cactus.align_pairs_banded", (20 - 0) / 2 / 1e3),
    ("cactus.posterior_pairs_banded5", None),
    (None, None)])
def test_the_entry_span_is_the_drivers(entry, want):
    """Only the span the window's driver names counts as the entry: a
    span of another entry inside a call is ignored, and a driver whose
    entry has no span in the window (or names none) reads None."""
    host = HOST + [("cactus.fetch", 40, 50),
                   ("cactus.align_pairs_banded", 60, 80)]
    ctx = _ctx(host, entry=entry)
    got = _read("entry_self_ms_per_call", ctx)
    assert got == (None if want is None else pytest.approx(want))
    pack = _read("pack_ms_per_call", _ctx(host, entry=entry))
    assert (pack is None) == (want is None)


def test_a_program_without_the_spans_reads_none():
    """A program older than the spans: its calls hold only the driver's
    wrappers, so no span metric is reported."""
    ctx = _ctx([("gpubench.call", 0, 100), ("gpubench.banded_hits", 5, 95),
                ("aten::empty", 6, 7)])
    for name in NEW:
        assert _read(name, ctx) is None
        assert _read(name + ".gapfill", ctx) is None


def test_launched_live_share_reads_the_program_counter(monkeypatch):
    from cactus_tpu_torch.ops import cuda_build
    ctx = SimpleNamespace(live_cells=300, driver=SimpleNamespace(
        launch=("cactus_tpu_torch.ops.pairhmm_cuda", "pairhmm_fwd")))
    counts = dict.fromkeys(cuda_build.KERNELS, 0)
    monkeypatch.setattr(cuda_build, "CELLS", counts)
    assert _read("launched_live_share", ctx) is None   # nothing launched
    counts.update(pairhmm_fwd=800, pairhmm_fwd_wide=400, pairhmm_bwd=9999,
                  banded_dp=7777)
    assert _read("launched_live_share", ctx) == pytest.approx(25.0)
    monkeypatch.delattr(cuda_build, "cells")            # an older program
    assert _read("launched_live_share", ctx) is None


def test_a_cpu_traced_window_reads_the_program_spans(tmp_path, monkeypatch):
    """The nested cell on the CPU: every new span metric reads, and pack +
    fetch + unpack + entry_self is the mean entry span.  The launched-cell
    counter counts card launches only, so launched_live_share is left
    out."""
    traces = []
    real = tracing.from_profiler

    def keep(prof):
        traces.append(real(prof))
        return traces[-1]

    monkeypatch.setattr(tracing, "from_profiler", keep)
    root = gpubench_small.small_root(tmp_path, max_pairs=2, max_len=40,
                                     calls=1)
    r = harness.run_cell("mammals-nested", 2**31 + 19, 0.2, True,
                         time.perf_counter(), device=torch.device("cpu"),
                         root=root)
    assert r["correct"]
    m = r["metrics"]
    assert "launched_live_share" not in m
    for name in NEW:
        assert m[name]["unit"] == "ms"
    for name in STAGE_METRICS:
        assert m[name]["value"] > 0
    calls = traces[0].calls()
    entries = [e - s for n, s, e in traces[0].host
               if n == "cactus.posterior_pairs_banded"]
    assert len(entries) == len(calls) > 0
    total = sum(m[name]["value"] for name in NEW)
    assert total == pytest.approx(sum(entries) / len(calls) / 1e3,
                                  rel=1e-9)
