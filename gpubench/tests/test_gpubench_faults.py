"""A whole run on the CPU with the timed path broken underneath: `correct`
comes out false for each fault a cell can have, and true without one.

Faults (planted in the program, below the entry the driver calls):
- half of the batch left out: the answers of the second half of each
  call's pairs never computed (empty);
- an answer altered where it is produced: a score or a hit's target
  position off by one;
- a step that returns its state unchanged: the DP's output left as it
  was allocated (no alignment, no posterior).
The cells run on one chip: there is no exchange between chips to leave
out.
"""

import time

import gpubench_small
import numpy as np
import pytest
import torch

from gpubench import harness

CELLS = {"mammals-gapfill": dict(max_pairs=4, max_len=60),
         "mammals-nested": dict(max_pairs=4, max_len=160, min_len=120),
         "pecan-posterior": dict(max_pairs=4, max_len=60, min_len=40)}


def run(tmp_path, cell):
    root = gpubench_small.small_root(tmp_path, calls=1, **CELLS[cell])
    return harness.run_cell(cell, 2**31 + 77, 0.05, False,
                            time.perf_counter(), device=torch.device("cpu"),
                            root=root)


def plant_banded(monkeypatch, fault):
    from cactus_tpu_torch.ops import banded
    real = banded.align_pairs_native

    def broken(pairs, *a, **k):
        out = real(pairs, *a, **k)
        if fault == "half":
            return out[:len(out) // 2] + [(0, [])] * (len(out)
                                                      - len(out) // 2)
        if fault == "altered":
            return [(s + 1, ops) for s, ops in out]
        return [(0, []) for _ in out]          # "unchanged"

    monkeypatch.setattr(banded, "align_pairs_native", broken)


def plant_hmm(monkeypatch, cell, fault):
    if cell == "mammals-nested":
        from cactus_tpu_torch.ops import pairhmm as mod
        from cactus_tpu_torch.ops import pairhmm_cuda as kern
        bwd = "pairhmm_bwd"
    else:
        from cactus_tpu_torch.ops import pairhmm5 as mod
        from cactus_tpu_torch.ops import pairhmm5_cuda as kern
        bwd = "pairhmm5_bwd"
    if fault == "unchanged":
        real_bwd = getattr(kern, bwd)

        def no_step(fM, *a, **k):
            return torch.zeros_like(real_bwd(fM, *a, **k))

        monkeypatch.setattr(kern, bwd, no_step)
        return
    real = mod.banded_hits

    def broken(post, pairs, lo, gamma):
        out = real(post, pairs, lo, gamma)
        if fault == "half":
            return out[:len(out) // 2] + [[] for _ in out[len(out) // 2:]]
        return [[(i, j + 1, p) for i, j, p in hits] for hits in out]

    monkeypatch.setattr(mod, "banded_hits", broken)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(tmp_path, cell):
    r = run(tmp_path, cell)
    assert r["correct"], r["checks"]
    if cell != "mammals-gapfill":
        # the sample has hits to lose
        assert r["checks"]["hit_gap"]["value"] < 0.01


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_fails_the_run(tmp_path, monkeypatch, cell, fault):
    if cell == "mammals-gapfill":
        plant_banded(monkeypatch, fault)
    else:
        plant_hmm(monkeypatch, cell, fault)
    r = run(tmp_path, cell)
    assert not r["correct"], (fault, r["checks"])
    assert any(np.asarray(c["value"]) > c["limit"]
               for c in r["checks"].values())
