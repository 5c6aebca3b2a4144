"""The banded_dp warp kernel's test cases, shared by the numpy model
(tests/test_torch_banded_warp.py, on the CPU) and the card tests
(tests/test_torch_cuda.py): long band-128 and band-256 pairs whose
window stands still, BAR-like short ends at band 1024 whose window
slides (C = 2..8 cells a lane by max_live), pairs whose window stops
sliding inside the pair, and the edge cases, every live row at most
WARP_MAX_LIVE cells.  Imports no jax.
"""

import numpy as np

from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import banded_cuda

KEYS = ("q", "t_shift", "m_len", "n_len", "lo")


def _codes(rng, k):
    return rng.integers(0, 4, k).astype(np.uint8)


def _mutate(rng, q, sub=0.1, indel=0.04):
    keep = rng.random(len(q)) >= indel / 2
    out = q[keep].copy()
    flip = rng.random(len(out)) < sub
    out[flip] = rng.integers(0, 4, int(flip.sum()))
    ins = np.flatnonzero(rng.random(len(out)) < indel / 2)
    return np.insert(out, ins, rng.integers(0, 4, len(ins))).astype(np.uint8)


def edge_pairs(seed, band, max_len=50):
    """Homologous ragged pairs plus m = 0, n = 0, both 0, n < m and
    |n - m| = band - 1 both ways, every pair's n + 1 at most 256."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < 5:
        q = _codes(rng, int(rng.integers(1, max_len)))
        t = _mutate(rng, q)
        if abs(len(t) - len(q)) < band:
            pairs.append((q, t))
    short = max(1, min(band // 4, 60))
    wide = min(band - 1, 250)
    return pairs + [(_codes(rng, 0), _codes(rng, min(band - 1, 9))),
                    (_codes(rng, short), _codes(rng, 0)),
                    (_codes(rng, 0), _codes(rng, 0)),
                    (_codes(rng, short + 3), _codes(rng, short)),
                    (_codes(rng, 5), _codes(rng, 5 + wide)),
                    (_codes(rng, 4 + band - 1), _codes(rng, 4))]


def long_pairs(seed, band, n=2):
    """Homologous pairs of 1000-1020 rows whose length difference fits
    the band, and one whose lengths differ by band // 2 (a gap)."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < n:
        q = _codes(rng, int(rng.integers(1000, 1021)))
        t = _mutate(rng, q, 0.1, 0.04)
        if abs(len(t) - len(q)) < band // 2:
            pairs.append((q, t))
    q = _codes(rng, 1000)
    pairs.append((q, np.concatenate([q[:500], _codes(rng, band // 2),
                                     q[500:]])))
    return pairs


def short_ends(seed, count=40):
    """BAR-like short ends: 1-32 query bases, a target mutated from it
    with up to 12 more bases (n + 1 <= 45) at odd indices, n + 1 <= 32
    at even ones."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < count:
        q = _codes(rng, int(rng.integers(1, 33)))
        extra = int(rng.integers(0, 13)) if len(pairs) % 2 else 0
        t = np.concatenate([_mutate(rng, q, 0.15, 0.1),
                            _codes(rng, extra)]).astype(np.uint8)
        if len(t) + 1 <= (45 if len(pairs) % 2 else 32):
            pairs.append((q, t))
    return pairs


def slide_stops(seed, band=256):
    """Pairs whose window slides for -lo rows and then stands still
    (1 <= -lo < m), n + 1 <= 256."""
    rng = np.random.default_rng(seed)
    pairs = []
    for m, extra in ((100, 100), (60, 150), (120, 40)):
        q = _codes(rng, m)
        t = np.concatenate([_mutate(rng, q), _codes(rng, extra)])
        pairs.append((q, t[:255]))
    return pairs


CASES = {
    # name: (pairs, band, max_live or None for the live width)
    "edge-8": (lambda: edge_pairs(8, 8), 8, None),
    "edge-24": (lambda: edge_pairs(24, 24), 24, None),
    "edge-40": (lambda: edge_pairs(40, 40), 40, None),
    "edge-128": (lambda: edge_pairs(128, 128), 128, None),
    "edge-256": (lambda: edge_pairs(256, 256), 256, None),
    "long-128": (lambda: long_pairs(1, 128), 128, None),
    "long-256": (lambda: long_pairs(2, 256, n=1), 256, None),
    "slide-stops-256": (lambda: slide_stops(3), 256, None),
    "short-1024-C1": (lambda: short_ends(4)[::2], 1024, None),
    "short-1024-C2": (lambda: short_ends(5), 1024, None),
    "short-1024-C3": (lambda: short_ends(6), 1024, 96),
    "short-1024-C5": (lambda: short_ends(7), 1024, 160),
    "short-1024-C6": (lambda: short_ends(8), 1024, 192),
    "short-1024-C7": (lambda: short_ends(9), 1024, 224),
    "short-1024-C8": (lambda: short_ends(10), 1024, 256),
    "edge-1024": (lambda: edge_pairs(11, 1024), 1024, 256),
}


def case(name):
    """(packed, band, max_live) of a case: pack_band_batch's arrays with
    no padding pairs, max_live the batch's live width where the case
    names none."""
    make, band, max_live = CASES[name]
    packed = tb.pack_band_batch(make(), band, min_batch=1)
    live_w = banded_cuda.live_width(packed["n_len"], band)
    W = live_w if max_live is None else max_live
    if not live_w <= W <= banded_cuda.WARP_MAX_LIVE:
        raise ValueError(f"{name}: max_live {W} outside {live_w}..256")
    return packed, band, W
