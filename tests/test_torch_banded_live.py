"""The live-cell contract of the banded_dp kernel, on the CPU.

The CUDA kernel (cactus_tpu_torch/csrc/banded.cu) computes only each
pair's live cells: rows 1..m, columns j = i + lo + b in 0..n.  Here:
- `live_mask` / `live_cells` / `live_width` against brute force;
- the plain version's live outputs do not depend on the inputs no live
  cell reads (t_shift bytes outside the live columns, q past m), and
  neither does the host traceback;
- a numpy model of the kernel's schedule (row-0 init on the read range
  only, the row's live window split over T threads in runs of
  ceil(min(B, n + 1) / T) cells, the neighbour read,
  the seeded block max-scan of the D chain, the 16-byte row stores)
  equals the plain version and the JAX package's scan on the live cells,
  and a D-chain seed of NEG alone breaks bit 3 of the j = 0 cells;
- max_live below a pair's live width raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cactus_tpu.ops import banded as jb
from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import banded_cuda

NEG = tb.NEG
INT_MIN = -(1 << 31)
POISON = 1 << 20          # what the kernel's unwritten shared cells hold
DEAD = 0xEE               # what its unwritten dirs bytes hold
SUBMAT = tb.score_matrix_6(PoaParams().sub_matrix)
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
GO, GE = 400, 30


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
    """Homologous ragged pairs plus the edge cases: m = 0, n = 0, both 0,
    n < m, and |n - m| = band - 1 both ways (lo clamped by
    pack_band_batch)."""
    rng = np.random.default_rng(seed)

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = []
    for _ in range(n_random):
        q = codes(int(rng.integers(1, max_len)))
        t = _mutate(rng, q)
        if abs(len(t) - len(q)) < band:
            pairs.append((q, t))
    short = max(1, band // 4)
    pairs += [(codes(0), codes(min(band - 1, 9))), (codes(short), codes(0)),
              (codes(0), codes(0)), (codes(short + 3), codes(short)),
              (codes(5), codes(5 + band - 1)), (codes(4 + band - 1), codes(4))]
    return pairs


def _pack(pairs, band):
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    return packed, [torch.from_numpy(packed[k]) for k in KEYS]


def _live_np(packed, M, B):
    return banded_cuda.live_mask(*(torch.from_numpy(packed[k])
                                   for k in ("m_len", "n_len", "lo")),
                                 M, B).numpy()


def kernel_model(packed, B, T, neg_only_seed=False):
    """The banded_dp kernel's schedule in numpy, thread by thread: what
    the block computes, with unwritten shared cells holding POISON and
    unwritten dirs bytes DEAD.  Returns (dirs, end_scores, end_mat)."""
    q, ts = packed["q"], packed["t_shift"]
    P, M = q.shape
    dirs = np.full((P, M, B), DEAD, np.uint8)
    ends = np.zeros((P, 3), np.int64)
    end_mat = np.zeros(P, np.int64)

    def write_end(p, h, i, d):
        ends[p] = (h, i, d)
        end_mat[p] = 0 if (h >= i and h >= d) else (1 if i >= d else 2)

    for p in range(P):
        lo, m, n = (int(packed[k][p]) for k in ("lo", "m_len", "n_len"))
        b_end = n - m - lo
        if not (0 <= b_end < B and 0 <= m <= M):
            write_end(p, NEG, NEG, NEG)
            continue
        sH = np.full(B, POISON, np.int64)
        sI = np.full(B, POISON, np.int64)
        sD = np.full(B, POISON, np.int64)
        sDir = np.full(B, DEAD, np.int64)
        for b in range(max(0, -m - lo), min(B - 1, n - lo) + 1):
            j0 = lo + b
            sH[b] = 0 if j0 == 0 else NEG
            sI[b] = NEG
            sD[b] = -(GO + j0 * GE) if j0 > 0 else NEG
            if m == 0 and b == b_end:
                write_end(p, sH[b], NEG, sD[b])
        C = (min(B, n + 1) + T - 1) // T
        for i in range(1, m + 1):
            jz = -i - lo
            b_lo = max(0, jz)
            b_hi = min(B - 1, n + jz)
            share = []
            for t in range(T):
                b0 = min(b_lo + t * C, b_hi + 1)
                share.append((b0, min(b0 + C, b_hi + 1)))
            srow = SUBMAT[q[p, i - 1]]
            nb = [(sH[b1], sI[b1]) if b1 < B and b0 < b1 else (NEG, NEG)
                  for b0, b1 in share]
            agg = [INT_MIN] * T
            last = [None] * T
            for t, (b0, b1) in enumerate(share):     # pass 1
                hn = NEG
                for b in range(b0, b1):
                    Hp, Ip, Dp = sH[b], sI[b], sD[b]
                    Hu = sH[b + 1] if b + 1 < b1 else nb[t][0]
                    Iu = sI[b + 1] if b + 1 < b1 else nb[t][1]
                    hi = max(Hp, Ip)
                    h_src = 0 if Hp >= Ip else 1
                    if Dp > hi:
                        h_src = 2
                    hn = max(hi, Dp) + int(srow[ts[p, i - 1 + b]])
                    i_fresh = (Hu - GO) >= Iu
                    In = max(Hu - GO, Iu) - GE
                    if b == jz:
                        In, hn = -(GO + i * GE), NEG
                    sH[b], sI[b] = hn, max(In, NEG)
                    sDir[b] = h_src | (4 if i_fresh else 0)
                    agg[t] = max(agg[t], hn + GE * (b + 1))
                if b0 < b1:
                    last[t] = hn
            seed = NEG if neg_only_seed else NEG + max(0, GE * b_lo)
            acc = INT_MIN
            for t, (b0, b1) in enumerate(share):     # scan, then pass 2
                run = max(seed, acc)
                acc = max(acc, agg[t])
                hl = NEG if t == 0 else last[t - 1]
                for b in range(b0, b1):
                    hn_unc = sH[b]
                    Dn = run - GO - GE * (b + 1)
                    d_fresh = Dn == hl - GO - GE
                    if b == jz:
                        Dn = NEG
                    Dn = max(Dn, NEG)
                    sH[b], sD[b] = max(hn_unc, NEG), Dn
                    sDir[b] |= 8 if d_fresh else 0
                    if i == m and b == b_end:
                        write_end(p, sH[b], sI[b], Dn)
                    run = max(run, hn_unc + GE * (b + 1))
                    hl = hn_unc
            if b_lo <= b_hi:
                if B % 16 == 0:
                    sl = slice((b_lo >> 4) * 16, ((b_hi >> 4) + 1) * 16)
                else:
                    sl = slice(b_lo, b_hi + 1)
                dirs[p, i - 1, sl] = sDir[sl]
    return dirs, ends, end_mat


@pytest.mark.parametrize("band", [8, 24, 64, 128])
def test_live_mask_and_cells_against_brute_force(band):
    packed, args = _pack(_edge_pairs(band, band), band)
    P, M = packed["q"].shape
    mask = banded_cuda.live_mask(args[2], args[3], args[4], M, band).numpy()
    brute = np.zeros_like(mask)
    for p in range(P):
        m, n, lo = (int(packed[k][p]) for k in ("m_len", "n_len", "lo"))
        for i in range(1, M + 1):
            for b in range(band):
                brute[p, i - 1, b] = i <= m and 0 <= i + lo + b <= n
    np.testing.assert_array_equal(mask, brute)
    assert banded_cuda.live_cells(args[2], args[3], args[4], M, band) == \
        int(brute.sum())
    # a row has at most min(band, n + 1) live cells
    widths = brute.sum(axis=2)
    assert (widths <= np.minimum(band, packed["n_len"] + 1)[:, None]).all()
    assert int(widths.max()) <= banded_cuda.live_width(args[3], band)


@pytest.mark.parametrize("band,seed", [(16, 1), (24, 2), (64, 3), (128, 4)])
def test_plain_live_outputs_ignore_what_no_live_cell_reads(band, seed):
    pairs = _edge_pairs(seed, band)
    packed, args = _pack(pairs, band)
    P, M = packed["q"].shape
    live = _live_np(packed, M, band)
    kw = dict(band=band, gap_open=GO, gap_extend=GE)
    sub = torch.from_numpy(SUBMAT)
    d1, s1, e1 = (x.numpy() for x in tb.banded_align_batch(*args, sub, **kw))
    # t_shift[p, i - 1 + b] is what live cell (i, b) reads; scramble the
    # rest, and q past m
    read = np.zeros(packed["t_shift"].shape, bool)
    pp, ii, bb = np.nonzero(live)
    read[pp, ii + bb] = True
    rng = np.random.default_rng(seed + 100)
    ts = packed["t_shift"].copy()
    ts[~read] = rng.integers(0, 6, int((~read).sum()))
    qq = packed["q"].copy()
    past = np.arange(M)[None, :] >= packed["m_len"][:, None]
    qq[past] = rng.integers(0, 6, int(past.sum()))
    args2 = [torch.from_numpy(qq), torch.from_numpy(ts)] + args[2:]
    d2, s2, e2 = (x.numpy() for x in tb.banded_align_batch(*args2, sub,
                                                           **kw))
    assert (ts != packed["t_shift"]).any() and (qq != packed["q"]).any()
    np.testing.assert_array_equal(d1[live], d2[live])
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(e1, e2)
    for p in range(len(pairs)):
        m, n, lo = (int(packed[k][p]) for k in ("m_len", "n_len", "lo"))
        outs = []
        for d, e in ((d1, e1), (d2, e2)):
            try:
                outs.append(tb.traceback_band(d[p], m, n, lo, int(e[p])))
            except RuntimeError:
                outs.append("left the band")
        assert outs[0] == outs[1]


@pytest.mark.parametrize("band,T", [(8, 32), (24, 32), (48, 32), (64, 64),
                                    (128, 32), (128, 256)])
def test_kernel_schedule_model_equals_plain_on_live_cells(band, T):
    pairs = _edge_pairs(band + T, band, n_random=5, max_len=50)
    packed, args = _pack(pairs, band)
    P, M = packed["q"].shape
    live = _live_np(packed, M, band)
    kw = dict(band=band, gap_open=GO, gap_extend=GE)
    d_ref, s_ref, e_ref = (x.numpy() for x in tb.banded_align_batch(
        *args, torch.from_numpy(SUBMAT), **kw))
    d, s, e = kernel_model(packed, band, T)
    np.testing.assert_array_equal(d[live], d_ref[live])
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(e, e_ref)
    # the model wrote every live byte, and the traceback reads only live
    # cells: it walks the model's bytes as it walks the plain version's
    assert not (d[live] == DEAD).any()
    for p in range(len(pairs)):
        m, n, lo = (int(packed[k][p]) for k in ("m_len", "n_len", "lo"))
        outs = []
        for dd in (d, d_ref):
            try:
                outs.append(tb.traceback_band(dd[p], m, n, lo, int(e[p])))
            except RuntimeError:
                outs.append("left the band")
        assert outs[0] == outs[1]


@pytest.mark.parametrize("band", [64, 128])
def test_kernel_schedule_model_equals_jax_on_live_cells(band):
    pairs = _edge_pairs(band + 7, band, n_random=5, max_len=50)
    packed, _args = _pack(pairs, band)
    P, M = packed["q"].shape
    live = _live_np(packed, M, band)
    jargs = [jnp.asarray(packed[k]) for k in KEYS] + [jnp.asarray(SUBMAT)]
    d_j, s_j, e_j = (np.asarray(x) for x in jb.banded_align_batch(
        *jargs, band=band, gap_open=GO, gap_extend=GE))
    d, s, e = kernel_model(packed, band, 32)
    np.testing.assert_array_equal(d[live], d_j[live])
    np.testing.assert_array_equal(s, s_j)
    np.testing.assert_array_equal(e, e_j)


@pytest.mark.parametrize("band", [24, 64])
def test_neg_only_seed_breaks_bit3_at_j0(band):
    pairs = _edge_pairs(band + 3, band, n_random=5, max_len=50)
    packed, args = _pack(pairs, band)
    P, M = packed["q"].shape
    live = _live_np(packed, M, band)
    d_ref = tb.banded_align_batch(*args, torch.from_numpy(SUBMAT), band=band,
                                  gap_open=GO, gap_extend=GE)[0].numpy()
    d, _s, _e = kernel_model(packed, band, 32, neg_only_seed=True)
    diff = live & (d != d_ref)
    assert diff.any()
    p, r, b = np.nonzero(diff)
    j = r + 1 + packed["lo"][p] + b
    # only the j = 0 cells, only bit 3 (D opened fresh), and every j = 0
    # cell left of which the band has cells
    assert (j == 0).all()
    assert (d[diff] ^ d_ref[diff] == 8).all()
    pl, rl, bl = np.nonzero(live)
    j0 = (rl + 1 + packed["lo"][pl] + bl == 0) & (bl > 0)
    assert diff.sum() == j0.sum()


def test_max_live_below_a_live_width_raises():
    band = 64
    packed, args = _pack(_edge_pairs(5, band), band)
    sub = torch.from_numpy(SUBMAT)
    kw = dict(band=band, gap_open=GO, gap_extend=GE)
    widest = banded_cuda.live_width(args[3], band)
    assert widest == min(band, int(packed["n_len"].max()) + 1)
    ref = tb.banded_align_batch(*args, sub, **kw)
    for got in (banded_cuda.banded_dp(*args, sub, **kw, max_live=widest),
                banded_cuda.banded_dp(*args, sub, **kw, max_live=band + 5)):
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    for bad in (widest - 1, 0):
        with pytest.raises(ValueError, match="max_live"):
            banded_cuda.banded_dp(*args, sub, **kw, max_live=bad)
    assert banded_cuda.live_width(args[3][:0], band) == 0
