"""The one traffic generator: engine calls made from a workload's call mix.

A workload file (gpubench/workloads/<name>.json) lists the calls that a
path of the port sends to one engine entry, as recorded by
gpubench/record.py: each call's band, its pairs' (query, target) lengths,
its keyword arguments and the divergence of its pairs (substitutions per
aligned column, gap opens per aligned column, mean gap length).  Every
run makes new sequences with exactly those lengths from `--seed`:

- the query is uniform over ACGT;
- the target is the query with substitutions at the call's rate and
  gaps opened at its rate (half insertions, half deletions, geometric
  lengths of its mean), then brought to the recorded length by one
  insertion or deletion block at a uniform position: the recorded
  difference n - m is one indel of that size.

So every seed gives the same calls, the same shapes and the same work by
the shapes, in the recorded order; only the bases differ.  `variants`
distinct sets of sequences (the workload's `variants` key) are made and
cycled through the window, so that no pass sees the inputs of the pass
before it.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream...).  seed: any
    whole number >= 0 (the driver's are up to a little over 2**31)."""
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def _cut(flat, lengths):
    """flat split into consecutive pieces of these lengths."""
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _indels(rng, t, dpos, dlen, ipos, ilen):
    """t with the blocks [dpos, dpos + dlen) deleted and ilen random bases
    inserted before each ipos (positions in t; an ipos equal to a piece's
    end inserts at that piece's end when it comes first in the order)."""
    delta = np.zeros(len(t) + 1, np.int64)
    np.add.at(delta, dpos, 1)
    np.add.at(delta, dpos + dlen, -1)
    keep = np.cumsum(delta[:-1]) == 0
    kept_before = np.concatenate([[0], np.cumsum(keep)])
    idx = np.repeat(kept_before[ipos], ilen)
    return np.insert(t[keep], idx, rng.integers(0, 4, int(np.sum(ilen)),
                                                dtype=np.uint8))


def make_call(rng, call: dict):
    """The pairs of one recorded call: [(query, target)] uint8 codes
    with the recorded lengths."""
    lens = np.asarray(call["pairs"], np.int64).reshape(-1, 2)
    m, n = lens[:, 0], lens[:, 1]
    total = int(m.sum())
    ends = np.cumsum(m)
    starts = ends - m
    q = rng.integers(0, 4, total, dtype=np.uint8)
    t = q.copy()
    hit = rng.random(total) < call["substitution_rate"]
    t[hit] = (t[hit] + rng.integers(1, 4, int(hit.sum()),
                                    dtype=np.uint8)) % 4
    # gaps: half deletions (cut at the end of their pair), half insertions
    k = int(rng.binomial(total, call["gap_open_rate"])) if total else 0
    pos = np.sort(rng.integers(0, max(total, 1), k))
    glen = rng.geometric(1.0 / max(call["gap_mean_length"], 1.0), k)
    ins = rng.random(k) < 0.5
    pair = np.searchsorted(ends, pos, side="right")
    dpos = pos[~ins]
    dlen = np.minimum(glen[~ins], ends[pair[~ins]] - dpos)
    covered = np.zeros(total + 1, np.int64)
    np.add.at(covered, dpos, 1)
    np.add.at(covered, dpos + dlen, -1)
    kept = (np.cumsum(covered[:-1]) == 0).astype(np.int64)
    kept_cum = np.concatenate([[0], np.cumsum(kept)])
    t_len = (kept_cum[ends] - kept_cum[starts]
             + np.bincount(pair[ins], weights=glen[ins],
                           minlength=len(m)).astype(np.int64))
    t = _indels(rng, t, dpos, dlen, pos[ins], glen[ins])
    # the recorded length: one block indel of n - t_len at a uniform
    # position of each pair
    d = n - t_len
    at = (rng.random(len(m)) * (t_len + np.minimum(d, 0) + 1)).astype(
        np.int64)
    t_start = np.concatenate([[0], np.cumsum(t_len)])[:-1] + at
    dm, im = d < 0, d > 0
    t = _indels(rng, t, t_start[dm], -d[dm], t_start[im], d[im])
    return list(zip(_cut(q, m), _cut(t, n)))


def make_variants(workload: dict, seed: int):
    """variants x calls: the pairs of every call of every variant."""
    n_var = int(workload["variants"])
    return [[make_call(rng_for(seed, v, c), call)
             for c, call in enumerate(workload["calls"])]
            for v in range(n_var)]


def call_bases(call: dict) -> int:
    """Query plus target bases of one call."""
    return int(np.asarray(call["pairs"], np.int64).sum())
