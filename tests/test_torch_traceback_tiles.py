"""The tiled banded_traceback kernel's schedule, on the CPU.

The CUDA kernel (cactus_tpu_torch/csrc/banded.cu banded_traceback_kernel)
walks each pair from tiles of its direction bytes staged in shared
memory: K rows from the walk's current row up, tile_w band columns whose
right edge lies min(K, tile_w) - 1 columns right of the walk's column,
each row clipped to its live window; it restages when the walk leaves the
tile.  Here a numpy model of that schedule walks from the tile alone
(every unstaged byte, and every dead byte of dirs, is poisoned, and
reading one fails), and equals banded_traceback_plain and the host
traceback_band, moves and counts, on direction bytes from the plain DP.
Also: chip_smoke.traceback_cap derives the move capacity S of a banded_dp
call as ops/banded.py::_align_pairs_cuda does.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cactus_tpu.ops import banded as jb
from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import banded_cuda

SUBMAT = tb.score_matrix_6(PoaParams().sub_matrix)
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
GO, GE = 400, 30
POISON = -1
# csrc/banded.cu: kTileW, kTileBytes, kTileMaxRows
TILE_W, TILE_BYTES, TILE_MAX_ROWS = 256, 16384, 256


def _smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def geometry(M, B, S, tile_w=TILE_W, tile_bytes=TILE_BYTES):
    """banded_traceback_tile: (tile_w, pitch, K)."""
    w = max(1, min(tile_w, B, S))
    pitch = (w + 15) // 16 * 16 + 16
    return w, pitch, max(1, min(tile_bytes // pitch, TILE_MAX_ROWS, M))


def tiled_walk(d, m, n, lo, cur, S, tile_w=TILE_W, tile_bytes=TILE_BYTES,
               stats=None):
    """One warp's walk in banded_traceback_kernel, for dirs d (M, B):
    (moves (S,) uint8 in reverse order, count)."""
    M, B = d.shape
    w, pitch, K = geometry(M, B, S, tile_w, tile_bytes)
    mv = np.zeros(S, np.uint8)
    i, j, k = m, n, 0
    ok = m >= 0 and n >= 0 and m <= M
    while ok and i > 0 and j > 0:
        b = j - i - lo
        if not 0 <= b < B:                    # the walk left the band
            ok = False
            break
        r_bot, r_top = i, max(1, i - K + 1)
        c_hi = min(B - 1, b + min(K, w) - 1)
        c_lo = max(0, c_hi - w + 1)
        c_base = c_lo & ~15
        tile = np.full((K, pitch), POISON, np.int16)
        for r in range(r_bot, r_top - 1, -1):
            lo_r, hi_r = max(c_lo, -r - lo), min(c_hi, n - r - lo)
            if lo_r <= hi_r:
                tile[r_bot - r, lo_r - c_base:hi_r - c_base + 1] = \
                    d[r - 1, lo_r:hi_r + 1]
        if stats is not None:
            stats["stages"] = stats.get("stages", 0) + 1
        buf, full = [], False
        while i > 0 and j > 0:
            bb = j - i - lo
            if i < r_top or bb < c_lo or bb > c_hi:
                break                         # restage
            if k + len(buf) >= S:
                full = True
                break
            byte = int(tile[r_bot - i, bb - c_base])
            assert byte != POISON, f"read an unstaged byte at ({i}, {j})"
            if cur == 0:
                buf.append(1)
                cur = byte & 3
                i, j = i - 1, j - 1
            elif cur == 1:
                buf.append(2)
                cur = 0 if (byte >> 2) & 1 else 1
                i -= 1
            else:
                buf.append(3)
                cur = 0 if (byte >> 3) & 1 else 2
                j -= 1
        assert len(buf) <= 2 * K + w          # the kernel's move buffer
        mv[k:k + len(buf)] = buf
        k += len(buf)
        ok = not full
    rest = i + j if ok else 0
    if ok and k + rest > S:
        ok = False
    if not ok:
        return np.zeros(S, np.uint8), -1
    mv[k:k + rest] = 3 if i == 0 else 2
    return mv, k + rest


def _mutate(rng, q, sub=0.1, indel=0.06):
    out = []
    for c in q:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(int(rng.integers(0, 4)))
        out.append(int(rng.integers(0, 4)) if rng.random() < sub else int(c))
    return np.array(out, np.uint8)


def _edge_pairs(seed, band, n_random=6, max_len=60):
    """Homologous ragged pairs and the edge cases m = 0, n = 0, both 0,
    n < m and |n - m| = band - 1 both ways."""
    rng = np.random.default_rng(seed)

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = []
    while len(pairs) < n_random:
        q = codes(int(rng.integers(1, max_len)))
        t = _mutate(rng, q)
        if abs(len(t) - len(q)) < band:
            pairs.append((q, t))
    short = max(1, band // 4)
    return pairs + [(codes(0), codes(min(band - 1, 9))),
                    (codes(short), codes(0)), (codes(0), codes(0)),
                    (codes(short + 3), codes(short)),
                    (codes(5), codes(5 + band - 1)),
                    (codes(4 + band - 1), codes(4))]


def _dp(pairs, band, seed=0):
    """The plain DP's (dirs with every dead byte poisoned, m, n, lo,
    end_mat) as numpy, and the same as tensors for the plain traceback."""
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    dirs, _s, end_mat = tb.banded_align_batch(
        *args, torch.from_numpy(SUBMAT), band=band, gap_open=GO,
        gap_extend=GE)
    M = args[0].shape[1]
    live = banded_cuda.live_mask(args[2], args[3], args[4], M, band)
    # what banded_dp leaves in the bytes no live cell holds: anything
    rng = np.random.default_rng(seed)
    d = dirs.numpy().copy()
    d[~live.numpy()] = rng.integers(0, 256, int((~live).sum()))
    return d, args[2:], end_mat


def _check(d, mnl, end_mat, S, **tile):
    """The model against banded_traceback_plain on every pair, and against
    traceback_band's ops where the walk ends; returns the stage counts."""
    m_len, n_len, lo = mnl
    mv_ref, ct_ref = banded_cuda.banded_traceback_plain(
        torch.from_numpy(d), m_len, n_len, lo, end_mat, S)
    stages = []
    for p in range(d.shape[0]):
        st = {}
        mv, ct = tiled_walk(d[p], int(m_len[p]), int(n_len[p]), int(lo[p]),
                            int(end_mat[p]), S, stats=st, **tile)
        assert ct == int(ct_ref[p]), p
        np.testing.assert_array_equal(mv, mv_ref[p].numpy())
        if ct >= 0:
            ops = tb.moves_to_ops(mv, ct)
            assert ops == tb.traceback_band(d[p], int(m_len[p]),
                                            int(n_len[p]), int(lo[p]),
                                            int(end_mat[p]))
        stages.append(st.get("stages", 0))
    return stages, ct_ref


@pytest.mark.parametrize("band", [8, 24, 64, 128])
def test_model_equals_plain_on_edge_cases(band):
    pairs = _edge_pairs(band, band)
    d, mnl, end_mat = _dp(pairs, band, seed=band)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    stages, counts = _check(d, mnl, end_mat, S)
    # m = 0 or n = 0 reads no byte: no tile
    for p, (q, t) in enumerate(pairs):
        if not (len(q) and len(t)):
            assert stages[p] == 0 and counts[p] == len(q) + len(t)


@pytest.mark.parametrize("band", [8, 24, 128])
def test_model_equals_plain_with_tiny_tiles(band):
    """Tiles of 16 columns and ~2 rows restage every few steps."""
    pairs = _edge_pairs(band + 1, band, max_len=90)
    d, mnl, end_mat = _dp(pairs, band, seed=band + 1)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    stages, _c = _check(d, mnl, end_mat, S, tile_w=16, tile_bytes=64)
    assert max(stages) > 10


def test_model_short_pairs_fit_one_tile():
    """BAR-like short ends at band 1024: one tile a pair."""
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(40):
        q = rng.integers(0, 4, int(rng.integers(1, 33))).astype(np.uint8)
        pairs.append((q, _mutate(rng, q, sub=0.15, indel=0.1)))
    d, mnl, end_mat = _dp(pairs, 1024, seed=3)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    stages, counts = _check(d, mnl, end_mat, S)
    n = len(pairs)       # the rest pad the batch to a power of two
    assert (counts[:n] > 0).all() and max(stages[:n]) == 1


def test_model_band_16384():
    rng = np.random.default_rng(16)
    pairs = [(rng.integers(0, 4, 40).astype(np.uint8),
              rng.integers(0, 4, 47).astype(np.uint8))]
    q = rng.integers(0, 4, 50).astype(np.uint8)
    pairs.append((q, _mutate(rng, q)))
    d, mnl, end_mat = _dp(pairs, 16384, seed=16)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    assert geometry(d.shape[1], 16384, S)[0] == S    # tile_w = min(.., S)
    _check(d, mnl, end_mat, S)


def test_model_long_pair_and_d_run_wider_than_the_tile():
    """A band-128 pair of 1500 rows (many tiles of whole rows), and a
    300-base D run at band 512, wider than the 256-column tile."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, 1500).astype(np.uint8)
    d, mnl, end_mat = _dp([(q, _mutate(rng, q, sub=0.05, indel=0.02))], 128,
                          seed=7)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    w, _pitch, K = geometry(d.shape[1], 128, S)
    assert w == 128
    stages, counts = _check(d, mnl, end_mat, S)
    assert counts[0] > 0 and stages[0] >= 1500 // K
    t = rng.integers(0, 4, 700).astype(np.uint8)
    q = np.concatenate([t[:200], t[500:]])
    d, mnl, end_mat = _dp([(q, t)], 512, seed=8)
    S = _smoke().traceback_cap(mnl[0], mnl[1])
    stages, counts = _check(d, mnl, end_mat, S)
    ops = tb.moves_to_ops(
        banded_cuda.banded_traceback_plain(torch.from_numpy(d), *mnl,
                                           end_mat, S)[0][0].numpy(),
        int(counts[0]))
    assert max(ln for op, ln in ops if op == "D") > TILE_W
    assert stages[0] >= 3


def test_model_walk_longer_than_S():
    pairs = _edge_pairs(5, 64, max_len=80)
    d, mnl, end_mat = _dp(pairs, 64, seed=5)
    walks = (mnl[0] + mnl[1]).numpy()
    S = int(np.median(walks[walks > 0]))
    _stages, counts = _check(d, mnl, end_mat, S)
    assert (counts == -1).any() and (counts > 0).any()


def test_model_walk_that_leaves_the_band():
    """Random direction bytes: walks leave the band through either
    edge, which the DP's own bytes never make them do."""
    rng = np.random.default_rng(9)
    P, M, B = 40, 48, 16
    d = rng.integers(0, 16, (P, M, B)).astype(np.uint8)
    m = rng.integers(0, M + 1, P).astype(np.int32)
    n = np.clip(m + rng.integers(-B + 1, B, P), 0, None).astype(np.int32)
    lo = np.array([max(min(min(0, nn - mm) - (B - abs(nn - mm)) // 2, 0),
                       nn - mm - B + 1) for mm, nn in zip(m, n)], np.int32)
    end_mat = rng.integers(0, 3, P).astype(np.int32)
    mnl = [torch.from_numpy(x) for x in (m, n, lo)]
    _stages, counts = _check(d, mnl, torch.from_numpy(end_mat), 128)
    assert (counts == -1).any() and (counts >= 0).any()


def test_model_equals_jax_host_traceback():
    """The JAX package's host traceback_band walks the same bytes to the
    same ops."""
    pairs = _edge_pairs(11, 40)
    d, (m, n, lo), end_mat = _dp(pairs, 40, seed=11)
    S = _smoke().traceback_cap(m, n)
    for p in range(len(pairs)):
        mv, ct = tiled_walk(d[p], int(m[p]), int(n[p]), int(lo[p]),
                            int(end_mat[p]), S)
        ref = jb.traceback_band(d[p], int(m[p]), int(n[p]), int(lo[p]),
                                int(end_mat[p]))
        assert tb.moves_to_ops(mv, ct) == ref


def test_traceback_cap_is_the_path_s(monkeypatch):
    """chip_smoke's replay gives banded_traceback the S that
    _align_pairs_cuda gives it, batch by batch."""
    seen = []

    def dp(q, t, m, n, lo, sub, band, gap_open, gap_extend, max_live):
        out = tb.banded_align_batch(q, t, m, n, lo, sub, band=band,
                                    gap_open=gap_open, gap_extend=gap_extend)
        seen.append([m, n, None])
        return out

    def walk(dirs, m, n, lo, end_mat, S):
        seen[-1][2] = S
        return banded_cuda.banded_traceback_plain(dirs, m, n, lo, end_mat, S)

    monkeypatch.setattr(banded_cuda, "banded_dp", dp)
    monkeypatch.setattr(banded_cuda, "banded_traceback", walk)
    rng = np.random.default_rng(2)
    pairs = []
    for length in (1, 3, 7, 15, 16, 17, 40, 100, 130, 300):
        q = rng.integers(0, 4, length).astype(np.uint8)
        pairs.append((q, _mutate(rng, q)))
    pairs.append((q[:0], q[:0]))
    out = tb._align_pairs_cuda(pairs, SUBMAT, tb.GapParams(GO, GE), 64,
                               64 * 256, torch.device("cpu"))
    assert len(out) == len(pairs) and len(seen) > 3
    cap = _smoke().traceback_cap
    for m, n, S in seen:
        assert S is not None and cap(m, n) == S
    assert len({S for _m, _n, S in seen}) >= 4
    one = torch.ones(1, dtype=torch.int32)
    assert cap(one, one) == 32 and cap(one[:0], one[:0]) == 32
