"""banded_dp's warp kernel, modelled on the CPU.

csrc/banded.cu takes banded_dp_warp_kernel for every launch whose widest
live row W = max_live is at most WARP_MAX_LIVE (256): one warp a pair,
lane L holding C = max(2, ceil(W / 32)) cells of each row's live window
in registers, the lanes on a skewed wavefront (lane L computes row i at
step i - 1 + L and trades edge cells and the D chain's carry with its
neighbours by shuffles; where the window stands still it recomputes
lane L + 1's first cell of the row before, the ghost), the window moving
by delta in {0, 1} a row, and the D chain a recursion seeded at the
window's left end.  Here a numpy model of that schedule, lane by lane
and step by step, with the registers and bytes no live cell may read
poisoned, is held equal on the live cells and the end scores and states
to the plain banded_align_batch and to the JAX package's, at C = 2..8,
on long band-128 pairs (window standing still), BAR-like short ends at
band 1024 (window sliding), rows where the slide stops, and the edge
cases; the recursion is held to the plain max-scan on random rows, and
the routing constants to the source.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from banded_warp_cases import CASES, KEYS, case
from cactus_tpu.ops import banded as jb
from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import banded_cuda

NEG = tb.NEG
POISON = 1 << 30          # registers no live cell may read
DEAD = 0xEE               # dirs bytes the model never wrote
SUBMAT = tb.score_matrix_6(PoaParams().sub_matrix)
GO, GE = 400, 30
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cactus_tpu_torch", "csrc", "banded.cu")


def _shift_up(x):
    """__shfl_up_sync(x, 1): lane L gets lane L - 1's, lane 0 its own."""
    return np.concatenate([x[:1], x[:-1]])


def _shift_down(x):
    """__shfl_down_sync(x, 1): lane L gets lane L + 1's, lane 31 its own."""
    return np.concatenate([x[1:], x[-1:]])


def warp_model(packed, B, W, poison=True, neg_only_seed=False):
    """banded_dp_warp_kernel's schedule in numpy for max_live W: 32 lanes
    of C = max(2, ceil(W / 32)) register cells, step by step.  With
    poison, every register of a cell no live cell may read (band cells
    right of the pair's DP matrix, j > n, lanes past the pair's cells
    included, and D past the band) holds POISON after it is written, and
    H and I past the band the NEG the kernel sets there; unwritten dirs
    bytes hold DEAD.  Returns (dirs, end_scores, end_mat)."""
    q, ts = packed["q"], packed["t_shift"]
    P, M = q.shape
    W = min(max(W, 1), B)
    C = max(2, (W + 31) // 32)
    V = min(C & -C, 8)
    dirs = np.full((P, M, B), DEAD, np.uint8)
    ends = np.zeros((P, 3), np.int64)
    end_mat = np.zeros(P, np.int64)
    lanes = np.arange(32)
    k0 = lanes * C
    cells = np.arange(C)

    def write_end(p, h, i, d):
        ends[p] = (h, i, d)
        end_mat[p] = 0 if (h >= i and h >= d) else (1 if i >= d else 2)

    for p in range(P):
        lo, m, n = (int(packed[k][p]) for k in ("lo", "m_len", "n_len"))
        b_end = n - m - lo
        if not (0 <= b_end < B and 0 <= m <= M and n >= 0):
            write_end(p, NEG, NEG, NEG)
            continue
        if m == 0:
            write_end(p, 0 if n == 0 else NEG, NEG,
                      -(GO + n * GE) if n > 0 else NEG)
            continue
        nl = (min(W, B, n + 1) + C - 1) // C
        has = lanes < nl
        # row 0 in registers (band index b = b_lo(0) + k)
        bl0 = max(0, -lo)
        b = bl0 + k0[:, None] + cells[None, :]
        j = lo + b
        inb = has[:, None] & (b < B)
        H = np.where(inb & (j == 0), 0, NEG).astype(np.int64)
        I = np.full((32, C), NEG, np.int64)
        D = np.where(inb & (j > 0), -(GO + j * GE), NEG).astype(np.int64)
        if poison:
            dead = (b < B) & (j > n)
            H[dead] = I[dead] = D[dead] = POISON
        bs = bl0 + k0 - 1
        js = lo + bs
        lH = np.where((bs >= 0) & (js == 0), 0, NEG).astype(np.int64)
        lI = np.full(32, NEG, np.int64)
        lD = np.where((bs >= 0) & (js > 0), -(GO + js * GE), NEG)
        lD = lD.astype(np.int64)
        if poison:
            dead = (bs >= 0) & (bs < B) & (js > n)
            lH[dead] = lI[dead] = lD[dead] = POISON
        pH = np.full(32, NEG, np.int64)
        pI = np.full(32, NEG, np.int64)
        pD = np.full(32, NEG, np.int64)
        Dn = np.full(32, NEG, np.int64)
        Hl = np.full(32, NEG, np.int64)

        def load(rows):
            """(q byte, t bytes) of each lane's row rows[L]."""
            bb = (np.maximum(0, -rows - lo)[:, None] + k0[:, None]
                  + cells[None, :])
            return (q[p, rows - 1].astype(np.int64),
                    ts[p, (rows - 1)[:, None] + np.minimum(bb, B - 1)]
                    .astype(np.int64))

        def row_of(s):
            return np.clip(s - lanes + 1, 1, m)

        qb, tbytes = load(row_of(0))
        sc = SUBMAT[qb[:, None], tbytes].astype(np.int64)
        qb, tbytes = load(row_of(1))
        sc2 = SUBMAT[qb[:, None], tbytes].astype(np.int64)
        qb, tbytes = load(row_of(2))
        for s in range(m + nl - 1):
            upDn, upHl = _shift_up(Dn), _shift_up(Hl)
            upH, upI, upD = (_shift_up(H[:, -1]), _shift_up(I[:, -1]),
                             _shift_up(D[:, -1]))
            rH0, rI0, rD0 = (_shift_down(H[:, 0]), _shift_down(I[:, 0]),
                             _shift_down(D[:, 0]))
            rH1, rI1 = _shift_down(H[:, 1]), _shift_down(I[:, 1])
            rS0 = _shift_down(sc[:, 0])
            i = s - lanes + 1
            on = (i >= 1) & (i <= m)
            jz = -i - lo
            bl = np.maximum(0, jz)
            b = bl[:, None] + k0[:, None] + cells[None, :]
            j = i[:, None] + lo + b
            slide = jz >= 0
            # the ghost: lane + 1's first cell of row i - 1, from its row
            # i - 2 (row 1 reads lane + 1's row 0 as it is)
            gz = jz + 1
            gslide = gz >= 0
            gHp = np.where(gslide, pH, rH0)
            gIp = np.where(gslide, pI, rI0)
            gDp = np.where(gslide, pD, rD0)
            gHq = np.where(gslide, rH0, rH1)
            gIq = np.where(gslide, rI0, rI1)
            gH = np.maximum(np.maximum(np.maximum(gHp, gIp), gDp) + rS0, NEG)
            gI = np.maximum(np.maximum(gHq - GO, gIq) - GE, NEG)
            gb = np.maximum(0, gz) + k0 + C
            gj = i - 1 + lo + gb
            if poison:
                gH = np.where((gb < B) & (gj > n), POISON, gH)
                gI = np.where((gb < B) & (gj > n), POISON, gI)
            gH = np.where(gb >= B, NEG, gH)
            gI = np.where(gb >= B, NEG, gI)
            first = (i == 1) | slide
            gH = np.where(first, rH0, gH)
            gI = np.where(first, rI0, gI)
            seed = NEG - GO - GE * (bl + 1) if neg_only_seed else \
                NEG + np.maximum(0, GE * bl) - GO - GE * (bl + 1)
            hl = np.where(lanes == 0, NEG, upHl)
            dch = np.where(lanes == 0, seed, upDn)
            sl = slide[:, None]
            # H/D predecessors at window index k - delta, I at k + 1 - delta
            Hp = np.where(sl, np.c_[lH, H[:, :-1]], H)
            Ip = np.where(sl, np.c_[lI, I[:, :-1]], I)
            Dp = np.where(sl, np.c_[lD, D[:, :-1]], D)
            Hq = np.where(sl, H, np.c_[H[:, 1:], gH])
            Iq = np.where(sl, I, np.c_[I[:, 1:], gI])
            hi = np.maximum(Hp, Ip)
            src = np.where(hi >= Dp, np.where(Hp >= Ip, 0, 1), 2)
            Hu = np.maximum(hi, Dp) + sc
            i_fresh = Hq - GO >= Iq
            In = np.maximum(Hq - GO, Iq)
            j0 = (lanes == 0) & (jz >= 0)
            Hu[j0, 0] = NEG
            In[j0, 0] = -(GO + i[j0] * GE) + GE
            if poison:
                Hu[(j > n) | (b >= B)] = POISON
            Hn = np.maximum(Hu, NEG)
            In = np.maximum(In - GE, NEG)
            Dn_ = np.empty_like(Hn)
            d_fresh = np.empty(Hn.shape, bool)
            d = dch
            for c in range(C):
                hlt = (Hu[:, c - 1] if c else hl) - GO - GE
                if c:
                    d = np.maximum(d - GE, hlt)
                d_fresh[:, c] = d == hlt
                Dn_[:, c] = np.maximum(d, NEG)
            Dn_[j0, 0] = NEG
            nextD = np.maximum(d - GE, Hu[:, -1] - GO - GE)
            if poison:
                dead = (j > n) | (b >= B)
                Hn[dead] = In[dead] = Dn_[dead] = POISON
            # cells past the band read as NEG (the kernel leaves D there)
            Hn[b >= B] = NEG
            In[b >= B] = NEG
            dirb = src | (i_fresh << 2) | (d_fresh << 3)
            for L in np.flatnonzero(on):
                il, b0 = int(i[L]), int(b[L, 0])
                if il == m and b0 <= b_end < b0 + C:
                    c = b_end - b0
                    write_end(p, Hn[L, c], In[L, c], Dn_[L, c])
                b_hi = min(B - 1, n - il - lo)
                row = dirs[p, il - 1]
                if b0 > b_hi:
                    continue
                if V > 1 and B % V == 0 and b0 % V == 0 and b0 + C <= B:
                    row[b0:b0 + C] = dirb[L] & 0xFF
                else:
                    for c in range(C):
                        if b0 + c <= b_hi:
                            row[b0 + c] = dirb[L, c]
            o1 = on[:, None]
            pH = np.where(on, H[:, -1], pH)
            pI = np.where(on, I[:, -1], pI)
            pD = np.where(on, D[:, -1], pD)
            H, I, D = (np.where(o1, Hn, H), np.where(o1, In, I),
                       np.where(o1, Dn_, D))
            Dn = np.where(on, nextD, Dn)
            Hl = np.where(on, Hu[:, -1], Hl)
            keep = on & (lanes > 0)
            lH, lI, lD = (np.where(keep, upH, lH), np.where(keep, upI, lI),
                          np.where(keep, upD, lD))
            # the next step's scores; the bytes of the step after it
            sc = sc2
            sc2 = SUBMAT[qb[:, None], tbytes].astype(np.int64)
            qb, tbytes = load(row_of(s + 3))
    return dirs, ends, end_mat


def _live(packed, M, B):
    return banded_cuda.live_mask(*(torch.from_numpy(packed[k])
                                   for k in ("m_len", "n_len", "lo")),
                                 M, B).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_model_equals_plain_on_live_cells(name):
    packed, band, W = case(name)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    P, M = packed["q"].shape
    live = _live(packed, M, band)
    d_ref, s_ref, e_ref = (x.numpy() for x in tb.banded_align_batch(
        *args, torch.from_numpy(SUBMAT), band=band, gap_open=GO,
        gap_extend=GE))
    d, s, e = warp_model(packed, band, W)
    np.testing.assert_array_equal(d[live], d_ref[live])
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(e, e_ref)
    # every live byte written; the traceback walks the model's bytes as
    # it walks the plain version's
    assert not (d[live] == DEAD).any()
    for p in range(P):
        m, n, lo = (int(packed[k][p]) for k in ("m_len", "n_len", "lo"))
        outs = []
        for dd in (d, d_ref):
            try:
                outs.append(tb.traceback_band(dd[p], m, n, lo, int(e[p])))
            except RuntimeError:
                outs.append("left the band")
        assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["edge-40", "long-128", "short-1024-C2",
                                  "short-1024-C7", "slide-stops-256",
                                  "edge-1024"])
def test_warp_model_equals_jax_on_live_cells(name):
    packed, band, W = case(name)
    P, M = packed["q"].shape
    live = _live(packed, M, band)
    jargs = [jnp.asarray(packed[k]) for k in KEYS] + [jnp.asarray(SUBMAT)]
    d_j, s_j, e_j = (np.asarray(x) for x in jb.banded_align_batch(
        *jargs, band=band, gap_open=GO, gap_extend=GE))
    d, s, e = warp_model(packed, band, W)
    np.testing.assert_array_equal(d[live], d_j[live])
    np.testing.assert_array_equal(s, s_j)
    np.testing.assert_array_equal(e, e_j)


def test_cases_cover_every_lane_width_and_window_motion():
    """C = 2..8; windows that stand still over 1,000 rows (band 128),
    that slide all the way (the short ends), and that stop sliding at
    row -lo inside the pair; m = 0, n = 0, n < m, |n - m| = band - 1."""
    widths, still, slides, stops, edges = set(), False, False, False, set()
    for name in CASES:
        packed, band, W = case(name)
        widths.add(max(2, (W + 31) // 32))
        for p in range(len(packed["m_len"])):
            m, n, lo = (int(packed[k][p]) for k in ("m_len", "n_len", "lo"))
            still |= m - max(0, -lo) >= 900
            slides |= m >= 1 and -lo >= m
            stops |= 1 <= -lo < m
            edges |= {k for k, hit in (("m0", m == 0), ("n0", n == 0),
                                       ("n<m", n < m),
                                       ("|n-m|=B-1", abs(n - m) == band - 1))
                      if hit}
    assert widths == set(range(2, 9))
    assert still and slides and stops
    assert edges == {"m0", "n0", "n<m", "|n-m|=B-1"}


@pytest.mark.parametrize("band", [24, 256])
def test_neg_only_seed_breaks_bit3_at_j0(band):
    """Started from NEG instead of the skipped cells' seed, the D chain
    gives another bit 3 (D opened fresh) at the j = 0 cells with band
    cells left of them, and nowhere else."""
    packed, band, W = case(f"edge-{band}")
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    P, M = packed["q"].shape
    live = _live(packed, M, band)
    d_ref = tb.banded_align_batch(*args, torch.from_numpy(SUBMAT), band=band,
                                  gap_open=GO, gap_extend=GE)[0].numpy()
    d, _s, _e = warp_model(packed, band, W, neg_only_seed=True)
    diff = live & (d != d_ref)
    assert diff.any()
    p, r, b = np.nonzero(diff)
    assert (r + 1 + packed["lo"][p] + b == 0).all()
    assert (d[diff] ^ d_ref[diff] == 8).all()
    pl, rl, bl = np.nonzero(live)
    j0 = (rl + 1 + packed["lo"][pl] + bl == 0) & (bl > 0)
    assert diff.sum() == j0.sum()


@pytest.mark.parametrize("seed", range(6))
def test_d_recursion_equals_plain_max_scan(seed):
    """The kernel's D recursion over a row's live window, seeded at b_lo,
    against the plain version's Kogge-Stone max-scan of
    Y[b] = Hl[b] + extend * b: the same D (clamped, NEG at j <= 0) and
    d_fresh bits on every window cell, on random rows with NEG cells,
    cells below NEG and j <= 0 cells."""
    rng = np.random.default_rng(seed)
    B = int(rng.choice([8, 40, 128, 256, 1024]))
    go, ge = int(rng.integers(0, 500)), int(rng.integers(0, 60))
    for _ in range(20):
        i, lo = int(rng.integers(1, 400)), int(rng.integers(-B, 1))
        n = int(rng.integers(0, 600))
        b = np.arange(B)
        j = i + lo + b
        # the row's unclamped H: scores, NEG, and NEG plus a pad score
        Hn = rng.integers(-5000, 5000, B)
        Hn[rng.random(B) < 0.2] = NEG
        Hn[rng.random(B) < 0.1] = NEG - 1000
        Hn[j <= 0] = NEG
        Hl = np.r_[NEG, Hn[:-1]]
        # the plain version: shifted maxima, log2(B) rounds
        Y = Hl + ge * b
        off = 1
        while off < B:
            Y = np.maximum(Y, np.r_[np.full(off, NEG), Y[:-off]])
            off *= 2
        D_ref = Y - go - ge * (b + 1)
        fresh_ref = D_ref == Hl - go - ge
        D_ref = np.maximum(np.where(j <= 0, NEG, D_ref), NEG)
        # the kernel: from b_lo, the window's left end
        b_lo, b_hi = max(0, -i - lo), min(B - 1, n - i - lo)
        d = NEG + max(0, ge * b_lo) - go - ge * (b_lo + 1)
        for x in range(b_lo, b_hi + 1):
            hlt = Hl[x] - go - ge
            if x > b_lo:
                d = max(d - ge, hlt)
            assert (d == hlt) == fresh_ref[x]
            assert (NEG if j[x] <= 0 else max(d, NEG)) == D_ref[x]


def test_warp_max_live_matches_the_source():
    src = open(CSRC).read()
    m = re.search(r"constexpr int kWarpMaxLive = (\d+);", src)
    assert m and int(m.group(1)) == banded_cuda.WARP_MAX_LIVE == 256
    # C = max(2, ceil(W / 32)), at most 8
    assert "max(2, (W + 31) / 32)" in src


@pytest.mark.parametrize("max_live,kernel", [(1, "warp"), (256, "warp"),
                                             (257, "block"),
                                             (16384, "block")])
def test_dp_kernel_routes_on_max_live(max_live, kernel):
    assert banded_cuda.dp_kernel(max_live) == kernel
