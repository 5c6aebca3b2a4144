"""ops/pairhmm.py::banded_hits, which chooses a whole batch's hits in one
vectorised pass, against the per-pair loop it replaced (kept here as the
reference), on random (P, Mmax, B) posteriors: the same hits, in the same
order, of the same Python types.

The CPU cases run everywhere; `test_banded_hits_on_card` runs every case
on an NVIDIA GPU and skips without one (this file imports no jax):

    python -m pytest --noconftest tests/test_torch_banded_hits.py -q
"""

import numpy as np
import pytest
import torch

from cactus_tpu_torch.ops import pairhmm as tp


def loop_hits(post, pairs, lo, gamma):
    """The per-pair loop banded_hits ran before it was vectorised."""
    best_b_all = torch.argmax(post, dim=2).to(torch.int32).cpu().numpy()
    pr_all = post.amax(dim=2).cpu().numpy()
    out = []
    for p, (qs, ts) in enumerate(pairs):
        m = len(qs)
        best_b = best_b_all[p, :m]
        pr = pr_all[p, :m]
        j = np.arange(1, m + 1) + int(lo[p]) + best_b  # 1-based target
        keep = (pr >= gamma) & (j >= 1) & (j <= len(ts))
        idx = np.flatnonzero(keep)
        out.append([(int(i), int(j[i] - 1), float(pr[i])) for i in idx])
    return out


def _pairs(rng, qlens, tlens):
    return [(rng.integers(0, 4, a).astype(np.uint8),
             rng.integers(0, 4, b).astype(np.uint8))
            for a, b in zip(qlens, tlens)]


def _post(rng, P, rows, band):
    """Random posteriors in [0, 1.5), nonzero past every pair's rows too,
    so that only the lengths keep those rows out."""
    return torch.from_numpy(rng.random((P, rows, band), np.float32) * 1.5)


def _case(name):
    """(post, pairs, lo, gamma) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        pairs = _pairs(rng, rng.integers(1, 120, 40),
                       rng.integers(1, 200, 40))
        lo = rng.integers(-70, 10, 40).astype(np.int32)
        return _post(rng, 40, 128, 96), pairs, lo, 0.9
    if name == "empty_query":
        pairs = _pairs(rng, [0, 5, 0, 7], [9, 0, 4, 12])
        return _post(rng, 4, 16, 8), pairs, np.array([-2, 0, -1, -3]), 0.3
    if name == "padding_pairs":
        # 3 pairs in a batch padded to 8: rows of pairs 3..7 are never hits
        pairs = _pairs(rng, [6, 10, 3], [8, 12, 5])
        lo = np.array([-2, -4, -1, 0, 0, 0, 0, 0], np.int32)
        return _post(rng, 8, 16, 8), pairs, lo, 0.0
    if name in ("gamma_zero", "gamma_negative"):
        pairs = _pairs(rng, [12, 4, 9], [15, 20, 3])
        lo = np.array([-3, -1, -6], np.int32)
        post = _post(rng, 3, 16, 8)
        post[:, 2] = 0.0  # a zero row still clears gamma <= 0
        return post, pairs, lo, 0.0 if name == "gamma_zero" else -0.5
    if name == "target_ends":
        # row 0 lands on j = 1 and row 4 on j = len(t) = 9; rows 1 and 5
        # one past either end
        pairs = _pairs(rng, [6], [9])
        lo = np.array([-2], np.int32)
        post = torch.full((1, 8, 8), 0.1)
        for i, b in ((0, 2), (1, 0), (4, 6), (5, 7)):
            post[0, i, b] = 0.95  # j = i + 1 + lo + b
        return post, pairs, lo, 0.5
    if name == "negative_lo":
        pairs = _pairs(rng, [30, 25, 18], [40, 10, 60])
        lo = np.array([-20, -31, -7], np.int32)
        return _post(rng, 3, 32, 40), pairs, lo, 0.8
    if name == "ties":
        # every row a plateau of equal maxima: the first of them wins
        pairs = _pairs(rng, [10, 10], [14, 14])
        post = torch.full((2, 16, 8), 0.25)
        for p in range(2):
            for i in range(16):
                first = int(rng.integers(0, 6))
                post[p, i, first:first + int(rng.integers(2, 4))] = 0.75
        return post, pairs, np.array([-3, 0], np.int32), 0.5
    if name == "wide_bin":
        # Mmax far past every query length, as in a 256-row bin
        pairs = _pairs(rng, [3, 17, 40, 1], [5, 30, 45, 2])
        lo = np.array([-2, -8, -10, 0], np.int32)
        return _post(rng, 4, 256, 24), pairs, lo, 0.4
    if name == "gamma_boundary":
        # row maxima equal to gamma in float32 are kept, below it not
        pairs = _pairs(rng, [8], [16])
        post = torch.full((1, 8, 8), 0.05)
        g = float(np.float32(0.2))
        below = float(np.nextafter(np.float32(0.2), np.float32(0)))
        for i in range(8):
            post[0, i, i % 4] = g if i % 2 else below
        return post, pairs, np.array([0], np.int32), 0.2
    raise KeyError(name)


CASES = ["random", "empty_query", "padding_pairs", "gamma_zero",
         "gamma_negative", "target_ends", "negative_lo", "ties", "wide_bin",
         "gamma_boundary"]


def _check(name, device):
    post, pairs, lo, gamma = _case(name)
    ref = loop_hits(post, pairs, lo, gamma)
    got = tp.banded_hits(post.to(device), pairs, lo, gamma)
    assert isinstance(got, list) and len(got) == len(pairs)
    assert got == ref
    for hits in got:
        assert isinstance(hits, list)
        for h in hits:
            assert type(h) is tuple
            assert [type(x) for x in h] == [int, int, float]
    return ref


@pytest.mark.parametrize("name", CASES)
def test_banded_hits_equal_to_the_loop(name):
    ref = _check(name, "cpu")
    # each case reaches the edge it is named for
    if name == "target_ends":
        assert ref == [[(0, 0, pytest.approx(0.95)),
                        (4, 8, pytest.approx(0.95))]]
    if name == "padding_pairs":
        assert all(ref)  # gamma 0: every pair has hits, the padding none
    if name == "gamma_boundary":
        assert [i for i, _t, _p in ref[0]] == [1, 3, 5, 7]
    if name == "empty_query":
        assert ref[0] == [] and ref[2] == []


def test_banded_hits_no_pairs():
    post = torch.rand(8, 16, 4)
    assert tp.banded_hits(post, [], np.zeros(8, np.int32), 0.5) == []


@pytest.mark.cuda
def test_banded_hits_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for name in CASES:
        _check(name, "cuda")
