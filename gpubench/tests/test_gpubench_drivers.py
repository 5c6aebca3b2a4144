"""What the harness asks of a driver, beyond the three pair engines: the
pair workloads made byte for byte as before; a whole CPU window of a
driver whose engine takes groups of homologous sequences, each pair
passed on as a group of two members; the launch-cell count a driver may
give; the recorder's groups as pairs."""

import hashlib
import json
import sys
import time
import types
from types import SimpleNamespace

import gpubench_small
import numpy as np
import pytest
import torch

from gpubench import harness, manifest, record, traffic

# sha256 of every sequence (its length as 8 bytes, then its codes) of
# make_variants, in order, at the commit before drivers could name
# their entry span and count their launches' cells
PINNED = {
    ("mammals-gapfill", 7):
        "d17ad79ed270b3d0b1a8641b07373a0fd2a103973a086454727744be5323756f",
    ("mammals-gapfill", 2**31 + 5):
        "ad20192e005076d2b24afaaa83fa432461512b3460b0609096df0a044b221a2b",
    ("mammals-nested", 7):
        "42228ad2317893f7b59a7ce908bb67bc540cc9b1dda5c0a27ffdaeb2be9bd44e",
    ("mammals-nested", 2**31 + 5):
        "23e4bc4b4e9a4ee65b23f15ff9a6c169845243d5a1215383bb680abc219fb34c",
    ("pecan-posterior", 7):
        "b15c524d89de2df6a9da46a51981a0ddad85551c4a82d9d28583302227047e79",
    ("pecan-posterior", 2**31 + 5):
        "ef5e52cdabee2071d7622bea7ef9edd0864aab68e72ea69fda697cda3290360d",
}


def digest(variants) -> str:
    h = hashlib.sha256()
    for calls in variants:
        for items in calls:
            for item in items:
                for s in item:
                    h.update(len(s).to_bytes(8, "little"))
                    h.update(s.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed", sorted(PINNED))
def test_the_pair_workloads_are_made_as_before(name, seed):
    with open(f"{manifest.HERE}/workloads/{name}.json") as fh:
        workload = json.load(fh)
    assert digest(traffic.make_variants(workload, seed)) == PINNED[
        (name, seed)]


class TwoMemberDriver:
    """A group engine for the test: each pair passed on as a group of two
    members, answered by each member's length and code sum computed by
    torch; its reference by numpy.  `altered` adds one to the second
    member's sum where the answer is produced.  Its launches take a dict
    of stacked arrays, counted by its own `launch_cells`."""
    kernels = {}
    checks = ("member_mismatches",)
    launch = ("gpubench_fake_group_launch", "align_bin")
    entry_span = None
    spans = ()
    altered = False
    referenced = []

    @staticmethod
    def launch_cells(args, kwargs):
        stack, band = args
        return stack["bases"].shape[0] * stack["bases"].shape[1] * band

    def __init__(self, config, workload, device):
        self.device = device

    def call(self, spec, pairs):
        out = []
        for group in pairs:
            sums = [int(torch.from_numpy(m).to(self.device).long().sum())
                    for m in group]
            if self.altered:
                sums[-1] += 1
            out.append(tuple((len(m), s) for m, s in zip(group, sums)))
        return out

    def reference(self, spec, pairs):
        TwoMemberDriver.referenced.extend(pairs)
        return [tuple((len(m), int(m.sum(dtype=np.int64))) for m in g)
                for g in pairs]

    def compare(self, items):
        return {"member_mismatches": sum(
            int(got != want) for _spec, _g, answers, want in items
            for got in answers)}


def group_root(tmp_path, monkeypatch):
    """A small root whose mammals-nested cell runs TwoMemberDriver."""
    root = gpubench_small.small_root(tmp_path, max_pairs=4, max_len=50)
    path = f"{root}/gpubench/workloads/mammals-nested.json"
    with open(path) as fh:
        workload = json.load(fh)
    workload["checks"] = {"member_mismatches": 0}
    with open(path, "w") as fh:
        json.dump(workload, fh)
    monkeypatch.setattr(
        manifest, "driver",
        lambda workload: SimpleNamespace(Driver=TwoMemberDriver))
    return root


@pytest.mark.parametrize("altered", [False, True])
def test_a_two_member_group_driver_runs_a_window(tmp_path, monkeypatch,
                                                 altered):
    """The mammals-nested traffic, cut small, through run_cell on the CPU
    with the group driver in its place: the longest pair of every call
    and variant is sampled; the rate counts both members' bases; one
    member's answer altered reads `correct` false."""
    root = group_root(tmp_path, monkeypatch)
    monkeypatch.setattr(TwoMemberDriver, "altered", altered)
    monkeypatch.setattr(TwoMemberDriver, "referenced", [])
    totals = []
    real_rate = harness.stats.rate

    def rate(total, seconds):
        totals.append(total)
        return real_rate(total, seconds)

    monkeypatch.setattr(harness.stats, "rate", rate)
    seed = 2**31 + 41
    r = harness.run_cell("mammals-nested", seed, 0.2, False,
                         time.perf_counter(), device=torch.device("cpu"),
                         root=root)
    _entry, _config, workload = manifest.cell("mammals-nested", root=root)
    variants = traffic.make_variants(workload, seed)
    ref_ids = {tuple(m.tobytes() for m in g)
               for g in TwoMemberDriver.referenced}
    for made in variants[:min(len(variants), r["attempted"])]:
        for pairs in made:
            longest = max(pairs, key=lambda g: len(g[0]) + len(g[1]))
            assert tuple(m.tobytes() for m in longest) in ref_ids
    bases = [sum(len(m) for g in pairs for m in g)
             for pairs in variants[0]]
    assert bases == [traffic.call_bases(c) for c in workload["calls"]]
    n = r["attempted"]
    assert r["failed"] == 0 and n > 4
    assert totals == [bases[0] * n]
    assert set(r["metrics"]) >= {"aligned_bases_per_s", "setup_s"}
    assert r["correct"] is not altered
    assert (r["checks"]["member_mismatches"]["value"] > 0) is altered


def test_a_drivers_launch_cells_count_its_traced_launches(tmp_path,
                                                          monkeypatch):
    """A traced CPU window of the group driver: each call launches its
    wrapper once on a dict of stacked arrays (P groups x 64 nodes, band
    32), and live_cell_share reads the driver's live cells over what its
    own launch_cells counted, not P x M x band."""
    mod = types.ModuleType("gpubench_fake_group_launch")
    mod.align_bin = lambda stack, band: None
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    launched = []

    def call(self, spec, pairs):
        stack = {"bases": np.zeros((len(pairs), 64), np.uint8)}
        sys.modules[mod.__name__].align_bin(stack, 32)
        launched.append(len(pairs) * 64 * 32)
        return [tuple((len(m), int(m.sum(dtype=np.int64))) for m in g)
                for g in pairs]

    root = group_root(tmp_path, monkeypatch)
    monkeypatch.setattr(TwoMemberDriver, "call", call)
    monkeypatch.setattr(TwoMemberDriver, "live_cells",
                        lambda self, c, spec: 1000, raising=False)
    r = harness.run_cell("mammals-nested", 2**31 + 43, 0.2, True,
                         time.perf_counter(), device=torch.device("cpu"),
                         root=root)
    n = r["attempted"]
    window = launched[-n:]          # the warm-up pass's launch went first
    assert r["correct"] and n >= 1
    assert r["metrics"]["live_cell_share"]["value"] == pytest.approx(
        100.0 * 1000 * n / sum(window))
    assert "entry_self_ms_per_call" not in r["metrics"]   # no entry span


def test_launch_cells_fall_back_to_p_by_m_by_band(monkeypatch):
    """Without the driver's own count, a launch computes P x M x band of
    its first argument and `band` keyword; a driver's launch_cells(args,
    kwargs) replaces it."""
    mod = types.ModuleType("gpubench_fake_launch")
    mod.launch = lambda q, *a, **k: "launched"
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    ctx = SimpleNamespace(computed_cells=0)
    with harness.shape_counter((mod.__name__, "launch"), ctx):
        assert mod.launch(np.zeros((3, 7)), "x", band=16) == "launched"
    assert ctx.computed_cells == 3 * 7 * 16
    assert mod.launch(np.zeros((1, 1)), band=1) == "launched"
    assert ctx.computed_cells == 3 * 7 * 16           # unwrapped again

    def stacked(args, kwargs):
        stack, _l, _s, band = args
        return stack["bases"].shape[0] * stack["bases"].shape[1] * band

    ctx.computed_cells = 0
    with harness.shape_counter((mod.__name__, "launch"), ctx, stacked):
        mod.launch({"bases": np.zeros((5, 64))}, None, None, 128)
    assert ctx.computed_cells == 5 * 64 * 128
    assert harness.launch_cells((np.zeros((2, 9)),), {"band": 4}) == 72


def test_the_recorders_two_member_groups_become_pairs():
    """A poa_msa_batch call's groups as the pairs of its workload file;
    a group of another size has no traffic and is refused."""
    assert record.group_pairs([[17, 18], [3, 2]]) == [[17, 18], [3, 2]]
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        record.group_pairs([[17, 18], [3, 2, 4]])
