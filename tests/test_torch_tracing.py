"""The port's spans (cactus_tpu_torch/trace.py) and its launched-cell
counter (ops/cuda_build.CELLS).

Each engine entry opens its span and, once per batch, `cactus.pack`,
`cactus.fetch` and `cactus.unpack` inside it, under torch.profiler's
clock; with no profiler recording a span opens no profiler range.  An
ancestor step opens its four phase spans, whose wall times fill
`AncestorStep.timings`.  The last test needs an NVIDIA GPU and skips
without one.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from cactus_tpu_torch import progressive
from cactus_tpu_torch.config import Config, PoaParams
from cactus_tpu_torch.io.fasta import Sequence
from cactus_tpu_torch.ops import banded, cuda_build, pairhmm, pairhmm5
from cactus_tpu_torch.testutil import evolver
from cactus_tpu_torch.trace import span
from cactus_tpu_torch.utils.trees import parse_newick

STAGES = ("cactus.pack", "cactus.fetch", "cactus.unpack")
SUBMAT = banded.score_matrix_6(PoaParams().sub_matrix)


def _pairs(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for m in lengths:
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = q.copy()
        t[rng.random(m) < 0.1] = rng.integers(0, 4)
        out.append((q, t[:max(1, m - 2)]))
    return out


def _traced(fn):
    """(fn's result, the host ranges named cactus.* as (name, start, end)
    in start order) under a CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("cactus.")),
                   key=lambda s: s[1])
    return out, spans


class Replay:
    """A DP function that runs in the untraced call and gives its outputs
    back, in order, in the traced one: the profiler records every op of
    a plain DP's row loop, which slows it tenfold."""

    def __init__(self, fn):
        self.fn, self.outs, self.at = fn, [], None

    def __call__(self, *a, **k):
        if self.at is None:
            self.outs.append(self.fn(*a, **k))
            return self.outs[-1]
        self.at += 1
        return self.outs[self.at - 1]


def _banded(pairs, dp=banded.banded_align_batch):
    return banded.align_pairs_banded(
        pairs, SUBMAT, banded.GapParams(), band=16, backend=dp,
        max_batch_bytes=64 * 16 * 2, device="cpu")


# entry span, (module, DP function) replayed, call; each call makes 3
# batches of the 5 pairs: 2 pairs a batch
ENTRIES = {
    "banded": ("cactus.align_pairs_banded", None, _banded),
    "pairhmm": ("cactus.posterior_pairs_banded",
                (pairhmm, "posterior_banded_batch"),
                lambda pairs, _dp: pairhmm.posterior_pairs_banded(
                    pairs, pairhmm.HmmParams(), band=16, min_rows_bin=32,
                    max_batch=2, device="cpu")),
    "pairhmm5": ("cactus.posterior_pairs_banded5",
                 (pairhmm5, "posterior_banded_batch5"),
                 lambda pairs, _dp: pairhmm5.posterior_pairs_banded5(
                     pairs, pairhmm5.Hmm5Params(), band=16,
                     max_batch_bytes=8 * 256 * 16 * 2, device="cpu")),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_opens_its_stages_once_a_batch_in_order(entry, monkeypatch):
    name, target, call = ENTRIES[entry]
    dp = Replay(getattr(*target) if target else banded.banded_align_batch)
    if target:
        monkeypatch.setattr(*target, dp)
    pairs = _pairs(3, [40, 33, 50, 45, 38])
    want = call(pairs, dp)
    dp.at = 0
    got, spans = _traced(lambda: call(pairs, dp))
    assert dp.at == len(dp.outs) == 3
    assert got == want
    entries = [s for s in spans if s[0] == name]
    assert len(entries) == 1
    _n, lo, hi = entries[0]
    inside = [s[0] for s in spans if s[0] in STAGES]
    assert all(lo <= s <= e <= hi for n, s, e in spans if n in STAGES)
    assert inside == list(STAGES) * 3
    assert {s[0] for s in spans} == {name, *STAGES}


def test_span_off_path_opens_no_profiler_range(monkeypatch):
    """With no profiler recording, a span never asks for a profiler
    range, and an engine entry runs as before."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("cactus.pack") as sp:
        x = sum(range(1000))
    assert x == 499500
    assert sp.name == "cactus.pack" and sp.seconds >= 0.0
    out = _banded(_pairs(5, [30, 20]))
    assert len(out) == 2 and all(isinstance(s, int) for s, _ops in out)


def test_span_seconds_is_the_wall_of_its_block():
    import time
    with span("cactus.blast") as sp:
        time.sleep(0.02)
    assert 0.02 <= sp.seconds < 1.0
    with pytest.raises(KeyError):
        with span("cactus.caf") as sp2:
            raise KeyError("x")
    assert sp2.seconds >= 0.0


@pytest.fixture
def fresh_counts(monkeypatch):
    """LAUNCHES and CELLS of this test alone."""
    monkeypatch.setattr(cuda_build, "LAUNCHES",
                        dict.fromkeys(cuda_build.KERNELS, 0))
    monkeypatch.setattr(cuda_build, "CELLS",
                        dict.fromkeys(cuda_build.KERNELS, 0))


def test_count_launch_adds_launches_and_cells(fresh_counts):
    cuda_build.count_launch("banded_dp", 8 * 64 * 128)
    cuda_build.count_launch("banded_dp", 3 * 32 * 128)
    cuda_build.count_launch("banded_traceback")
    cuda_build.count_launch("pairhmm_fwd_wide", 1 * 512 * 32768)
    assert cuda_build.launches()["banded_dp"] == 2
    assert cuda_build.launches()["banded_traceback"] == 1
    got = cuda_build.cells()
    assert got["banded_dp"] == 8 * 64 * 128 + 3 * 32 * 128
    assert got["banded_traceback"] == 0
    assert got["pairhmm_fwd_wide"] == 512 * 32768
    got["banded_dp"] = 0                       # a snapshot, not the counter
    assert cuda_build.cells()["banded_dp"] == 8 * 64 * 128 + 3 * 32 * 128
    cuda_build.reset_launches()
    assert set(cuda_build.launches().values()) == {0}
    assert set(cuda_build.cells().values()) == {0}


def test_count_launch_loses_no_update_across_threads(fresh_counts):
    """More threads than cores, switching often: every launch and cell
    counted."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                cuda_build.count_launch("pairhmm5_fwd", 3)

        threads = [threading.Thread(target=work) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert cuda_build.launches()["pairhmm5_fwd"] == 24 * 500
    assert cuda_build.cells()["pairhmm5_fwd"] == 24 * 500 * 3


def test_ancestor_step_fills_timings_from_its_phase_spans():
    """The two-genome step on the CPU: `timings` keeps its keys, and each
    phase is a span, the gap fill's entry span inside blast."""
    tree = parse_newick("(a:0.02,b:0.02)root;")
    sim = evolver.simulate(tree, root_len=1500, seed=3)
    cfg = Config.default()
    cfg.blast.chunk_size = 1024
    cfg.blast.overlap_size = 128
    aligner = progressive.ProgressiveAligner(
        tree, {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in tree.leaf_names()},
        config=cfg, min_chain_override=64, device="cpu")
    res, spans = _traced(aligner.run)
    timings = res.steps["root"].timings
    phases = ("blast", "caf", "bar", "reference")
    assert list(timings)[:4] == list(phases)
    assert {f"{p}_peak_rss_mb" for p in phases} <= set(timings)
    names = [n for n, _s, _e in spans]
    assert [n for n in names if n[len("cactus."):] in phases] == [
        f"cactus.{p}" for p in phases]
    for p in phases:
        (_n, s, e), = [x for x in spans if x[0] == f"cactus.{p}"]
        # the profiler's microseconds against the span's own clock
        assert timings[p] == pytest.approx((e - s) / 1e6, rel=0.5,
                                           abs=2e-3)
    blast = next(x for x in spans if x[0] == "cactus.blast")
    fills = [x for x in spans if x[0] == "cactus.align_pairs_banded"]
    assert fills and any(blast[1] <= s <= e <= blast[2]
                         for _n, s, e in fills)


@pytest.mark.cuda
def test_cuda_entry_stages_and_launched_cells():
    """_align_pairs_cuda opens the same stages once a batch, and
    CELLS["banded_dp"] is P x M x band of its launches (pairs in pow2
    query-length bins of at least 32 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    band = 32
    lengths = [40, 50, 60, 45, 55, 100, 110, 120]
    pairs = _pairs(7, lengths)
    call = (lambda: banded.align_pairs_banded(
        pairs, SUBMAT, banded.GapParams(), band=band, device="cuda"))
    want = banded.align_pairs_banded(
        pairs, SUBMAT, banded.GapParams(), band=band,
        backend=banded.banded_align_batch, device="cpu")
    call()                                     # builds the kernels
    cuda_build.reset_launches()
    got, spans = _traced(call)
    assert got == want
    bins = {}
    for m in lengths:
        rows = max(32, 1 << (m - 1).bit_length())
        bins[rows] = bins.get(rows, 0) + 1
    assert cuda_build.launches()["banded_dp"] == len(bins)
    assert cuda_build.cells()["banded_dp"] == sum(
        p * rows * band for rows, p in bins.items())
    inside = [n for n, _s, _e in spans if n in STAGES]
    assert inside == list(STAGES) * len(bins)
    assert [n for n, _s, _e in spans].count("cactus.align_pairs_banded") == 1
