"""The live-cell contract of the poa_chain and poa_affine kernels, on the CPU.

The CUDA kernels (cactus_tpu_torch/csrc/poa.cu) compute only each
problem's live cells: its real nodes v < n with the band cells b whose
column off[v] + b is at most L.  Here:
- `live_mask` and `check_live` against their
  definitions on ragged batches (chains and DAGs, n from 1 to Nb, L + 1
  below and above the band, stepping offsets), and the wrappers' checks
  of n_nodes and max_live;
- the team shapes: the Python table equals the instances csrc/poa.cu
  compiles, and `team_shape` picks each of them;
- the narrowed contract is what the consumers read: poa_msa_batch and
  poa_align_affine build the same graphs when every cell outside the live
  mask holds random values, and another graph when one live cell (the
  traceback's first) is changed;
- a numpy model of each kernel's schedule (teams of TL lanes in NW warps,
  C cells a lane, 32 / TL problems a warp looping to the warp's longest
  problem, the lanes' carries by segment scans, the carries and edge
  cells across warps rebuilt from what each warp publishes before the
  node's barrier, node words and query codes staged by tiles, stores on
  live cells only) equals the plain version on the live cells and writes
  nothing else.
"""

import numpy as np
import pytest
import torch

from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded_cuda, poa_cuda
from cactus_tpu_torch.ops import poa as tpoa
from cactus_tpu_torch.ops.banded import score_matrix_6

NEG = tpoa.NEG
MP = tpoa.MAX_PREDS
INT_MIN = -(1 << 31)
POISON = 0x5A5A5A5         # what the kernels' unwritten cells hold here
SUB = score_matrix_6(PoaParams().sub_matrix).astype(np.int32)
GAPS = dict(o1=400, e1=30, o2=1200, e2=1)


def _dag(rng, n, branchy=0.3, forward=2):
    """A bubbled DAG whose node order is not topological: `forward`
    predecessors point at higher indices, as add_alignment makes them."""
    bases = rng.integers(0, 4, n).astype(np.uint8)
    preds = np.full((n, MP), -1, np.int32)
    for v in range(1, n):
        preds[v, 0] = v - 1
        k = 1
        while k < MP and v > 2 and rng.random() < branchy:
            preds[v, k] = int(rng.integers(0, v - 1))
            k += 1
    for _ in range(forward if n > 3 else 0):
        v = int(rng.integers(1, n - 2))
        free = np.flatnonzero(preds[v] < 0)
        if len(free):
            preds[v, free[0]] = int(rng.integers(v + 1, n))
    return bases, preds


def ragged_batch(seed, P, N, lq, band, chain, n_lo=1):
    """P problems with ragged real node counts n in n_lo..N (problem 0
    fills the bin, problem 2 has n_lo; pad sources after them), ragged
    queries of 1..lq bases, and band offsets stepping
    by 0/1 (chains; a middle source may jump) or by up to 3 (DAGs) where
    the band is narrower than the query.  Returns (bases, preds, off,
    q_ext, l_len, n_nodes) numpy arrays."""
    rng = np.random.default_rng(seed)
    bases = np.zeros((P, N), np.uint8)
    preds = np.full((P, N, MP), -1, np.int32)
    off = np.zeros((P, N), np.int32)
    q_ext = np.full((P, lq + 1), 5, np.uint8)
    l_len = np.zeros(P, np.int32)
    n_nodes = np.zeros(P, np.int32)
    for i in range(P):
        n = (N if i == 0 else n_lo if i == 2
             else int(rng.integers(n_lo, N + 1)))
        li = lq if i == 1 else int(rng.integers(1, lq + 1))
        if chain:
            bases[i, :n] = rng.integers(0, 4, n)
            preds[i, 1:n, 0] = np.arange(n - 1)
            if n > 4 and rng.random() < 0.3:
                preds[i, n // 2, 0] = -1        # a source in the middle
        else:
            bases[i, :n], preds[i, :n] = _dag(rng, n)
        q_ext[i, 1:li + 1] = rng.integers(0, 4, li)
        l_len[i], n_nodes[i] = li, n
        if band < li + 1:
            steps = rng.integers(0, 2 if chain else 4, N)
            steps[0] = 0
            o = np.minimum(np.cumsum(steps), li + 1 - band)
            if chain and n > 4 and preds[i, n // 2, 0] < 0:
                o[n // 2:] = np.minimum(o[n // 2:] + 5, li + 1 - band)
            off[i] = o
    return bases, preds, off, q_ext, l_len, n_nodes


def _plain(inputs, band):
    bases, preds, off, q_ext, l_len = (torch.from_numpy(np.ascontiguousarray(a))
                                       for a in inputs[:5])
    H, dirs, ends = tpoa.poa_align_scan_affine(
        bases, preds, off, q_ext, l_len, torch.from_numpy(SUB), band=band,
        **GAPS)
    return H.numpy(), dirs.numpy(), ends.numpy()


def _mask(inputs, band):
    _b, _p, off, _q, l_len, n_nodes = (torch.from_numpy(a) for a in inputs)
    return poa_cuda.live_mask(off, l_len, n_nodes, band).numpy()


# ---------------------------------------------------------------- the mask

@pytest.mark.parametrize("chain,band,lq", [
    (True, 64, 40), (True, 64, 200), (False, 64, 50), (False, 128, 400)])
def test_live_mask_and_check_against_definition(chain, band, lq):
    inputs = ragged_batch(7 + band + lq, 9, 48, lq, band, chain)
    bases, preds, off, q_ext, l_len, n_nodes = inputs
    got = _mask(inputs, band)
    P, N = off.shape
    want = np.zeros((P, N, band), bool)
    widest = 0
    for p in range(P):
        for v in range(n_nodes[p]):
            for b in range(band):
                want[p, v, b] = off[p, v] + b <= l_len[p]
            widest = max(widest, int(want[p, v].sum()))
    np.testing.assert_array_equal(got, want)
    # the widest live row, within min(B, L + 1) of the longest query
    assert poa_cuda.check_live(preds, off, l_len, n_nodes, band) == widest
    assert widest <= banded_cuda.live_width(l_len, band)
    bad = n_nodes.copy()
    bad[0] = N + 1
    with pytest.raises(ValueError, match="outside"):
        poa_cuda.check_live(preds, off, l_len, bad, band)
    bad[0] = 0
    with pytest.raises(ValueError, match="outside"):
        poa_cuda.check_live(preds, off, l_len, bad, band)
    # problem 0 fills the bin: n = N - 1 cuts its last real node off
    bad[0] = N - 1
    with pytest.raises(ValueError, match="cuts a real node off"):
        poa_cuda.check_live(preds, off, l_len, bad, band)
    # the wrappers' defaults: every node real, check_live's width; a
    # given max_live must lie in 1..B
    t = [torch.from_numpy(a) for a in inputs]
    n, live = poa_cuda._live_args(t[1], t[2], t[4], t[5], band, None)
    assert n is t[5] and live == widest
    n, live = poa_cuda._live_args(t[1], t[2], t[4], None, band, band)
    assert n.tolist() == [N] * P and live == band
    for wrong in (0, band + 1):
        with pytest.raises(ValueError, match="max_live"):
            poa_cuda._live_args(t[1], t[2], t[4], t[5], band, wrong)


# ------------------------------------------------- what the consumers read

def _groups(seed, n_groups, lo=2, hi=5):
    """Groups of lo..hi related sequences with substitutions and indels."""
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(n_groups):
        base = rng.integers(0, 4, int(rng.integers(20, 140))).astype(np.uint8)
        seqs = []
        for _m in range(int(rng.integers(lo, hi + 1))):
            s = base.copy()
            idx = rng.random(len(s)) < 0.08
            s[idx] = (s[idx] + 1) % 4
            if rng.random() < 0.6 and len(s) > 30:
                a = int(rng.integers(5, len(s) - 20))
                s = np.concatenate([s[:a], s[a + int(rng.integers(2, 12)):]])
            if rng.random() < 0.4:
                a = int(rng.integers(0, len(s)))
                s = np.insert(s, a,
                              rng.integers(0, 4, int(rng.integers(1, 9))))
            seqs.append(s.astype(np.uint8))
        groups.append(seqs)
    return groups


def _patch_runs(monkeypatch, seed, corrupt_live=False):
    """Make align_bin's two runs return the plain outputs with every cell
    outside the live mask (ends: every pad node) random; with
    corrupt_live also the move of each problem's traceback start cell."""
    rng = np.random.default_rng(seed)
    seen = {"live": 0, "dead": 0}

    def run(bases, preds, off, q_ext, l_len, submat, band, o1, e1, o2, e2,
            n_nodes=None, max_live=None):
        assert n_nodes is not None and max_live is not None
        assert max_live == banded_cuda.live_width(l_len.numpy(), band)
        H, dirs, ends = tpoa.poa_align_scan_affine(
            bases, preds, off, q_ext, l_len, submat, band=band, o1=o1,
            e1=e1, o2=o2, e2=e2)
        live = poa_cuda.live_mask(off, l_len, n_nodes, band)
        real = live.any(dim=2) | (torch.arange(off.shape[1])[None, :]
                                  < n_nodes[:, None].long())
        noise = torch.from_numpy(rng.integers(-2**31, 2**31, H.shape,
                                              dtype=np.int64).astype(np.int32))
        H = torch.where(live, H, noise)
        dirs = torch.where(live, dirs, noise.to(torch.int16))
        ends = torch.where(real, ends, noise[:, :, 0])
        seen["live"] += int(live.sum())
        seen["dead"] += int((~live).sum())
        if corrupt_live:
            for p in range(bases.shape[0]):
                n = int(n_nodes[p])
                v = int(torch.argmax(ends[p, :n]))
                b = int(l_len[p]) - int(off[p, v])
                move = int(dirs[p, v, b]) & 7
                dirs[p, v, b] = (int(dirs[p, v, b]) & ~7) | (3 if move == 0
                                                             else 0)
        return H, dirs, ends

    monkeypatch.setattr(poa_cuda, "poa_chain", run)
    monkeypatch.setattr(poa_cuda, "poa_affine", run)
    return seen


def _graph_key(g):
    return (g.bases, g.preds, g.group_of, g.n_groups,
            [w.tolist() for w in g.walks])


def test_consumers_read_only_live_cells(monkeypatch):
    groups = _groups(3, 8)
    params = PoaParams()
    want = [_graph_key(g)
            for g in tpoa.poa_msa_batch(groups, params, device="cpu")]
    sub = score_matrix_6(params.sub_matrix)
    s, t = groups[0][0], groups[0][1]
    graph = tpoa.PoaGraph.from_sequence(s)
    graph.add_alignment(groups[0][2], tpoa.poa_align_affine(
        graph, groups[0][2], submat=sub, device="cpu"))
    want_ops = tpoa.poa_align_affine(graph, t, submat=sub, device="cpu")

    seen = _patch_runs(monkeypatch, 5)
    got = [_graph_key(g)
           for g in tpoa.poa_msa_batch(groups, params, device="cpu")]
    assert got == want
    assert tpoa.poa_align_affine(graph, t, submat=sub,
                                 device="cpu") == want_ops
    # most of what the kernels would compute without the mask is padding
    assert seen["dead"] > seen["live"] > 0


@pytest.mark.parametrize("chain", [True, False])
def test_align_bin_checks_the_live_contract(monkeypatch, chain):
    """align_bin checks n_nodes on its host arrays before any run, and
    passes the bin's check_live width as every chunk's max_live."""
    inputs = ragged_batch(11, 7, 40, 150, 64, chain)
    bases, preds, off, q_ext, l_len, n_nodes = inputs
    stack = dict(bases=bases, preds=preds, off=off, q_ext=q_ext)
    kw = dict(band=64, device="cpu", **GAPS)
    bad = n_nodes.copy()
    bad[0] = 39             # problem 0 fills the bin: cuts a real node off
    with pytest.raises(ValueError, match="cuts a real node off"):
        poa_cuda.align_bin(stack, l_len, SUB, n_nodes=bad, **kw)
    widths = []

    def run(*a, n_nodes=None, max_live=None, **k):
        widths.append(max_live)
        return tpoa.poa_align_scan_affine(*a, **k)

    monkeypatch.setattr(poa_cuda, "poa_chain" if chain else "poa_affine",
                        run)
    # two chunks of four and three problems
    per_problem = 40 * 64 * (poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL
                             + (0 if chain else 12))
    dirs, ends = poa_cuda.align_bin(stack, l_len, SUB, n_nodes=n_nodes,
                                    max_launch_bytes=4 * per_problem, **kw)
    assert widths == [poa_cuda.check_live(preds, off, l_len, n_nodes,
                                          64)] * 2
    _H, dp, ep = _plain(inputs, 64)
    live = _mask(inputs, 64)
    np.testing.assert_array_equal(dirs[live], dp[live])
    real = np.arange(40)[None, :] < n_nodes[:, None]
    np.testing.assert_array_equal(ends[real], ep[real])


def test_a_live_cell_is_read(monkeypatch):
    groups = _groups(4, 6)
    params = PoaParams()
    want = [_graph_key(g)
            for g in tpoa.poa_msa_batch(groups, params, device="cpu")]
    _patch_runs(monkeypatch, 6, corrupt_live=True)
    got = [_graph_key(g)
           for g in tpoa.poa_msa_batch(groups, params, device="cpu")]
    assert all(a != b for a, b in zip(got, want))


# ----------------------------------------------- the kernels' schedules

def row0_at(j, g):
    c = np.minimum(g["o1"] + j * g["e1"], g["o2"] + j * g["e2"])
    return np.where(j == 0, 0, np.where(j > 0, -c, NEG))


def pack(v, k):
    """csrc/poa.cu pack: value * 4 + 3 - slot, whose max is the first
    maximum over the slots."""
    return v * 4 + 3 - k


class Cands:
    """csrc/poa.cu Cands: the packed opens, extends and diagonal of a
    row's cells."""

    def __init__(self, shape):
        self.o1, self.o2, self.x1, self.x2, self.d = (
            np.full(shape, INT_MIN, np.int64) for _ in range(5))

    def empty(self, k, s, g):
        """The lowest empty slot k stands for all of them."""
        self.o1 = np.maximum(self.o1, pack(NEG - g["o1"] - g["e1"], k))
        self.o2 = np.maximum(self.o2, pack(NEG - g["o2"] - g["e2"], k))
        self.x1 = np.maximum(self.x1, pack(NEG - g["e1"], k))
        self.x2 = np.maximum(self.x2, pack(NEG - g["e2"], k))
        self.d = np.maximum(self.d, pack(NEG + s, k))

    def slot(self, k, H, F1, F2, Hd, s, g):
        self.o1 = np.maximum(self.o1, pack(H - g["o1"] - g["e1"], k))
        self.o2 = np.maximum(self.o2, pack(H - g["o2"] - g["e2"], k))
        self.x1 = np.maximum(self.x1, pack(F1 - g["e1"], k))
        self.x2 = np.maximum(self.x2, pack(F2 - g["e2"], k))
        self.d = np.maximum(self.d, pack(Hd + s, k))

    def cell(self):
        """(h0, F1, F2, code): csrc/poa.cu cands_cell."""
        open1 = (self.o1 >> 2) >= (self.x1 >> 2)
        open2 = (self.o2 >> 2) >= (self.x2 >> 2)
        p1 = np.where(open1, self.o1, self.x1)
        p2 = np.where(open2, self.o2, self.x2)
        F1, F2, diag = p1 >> 2, p2 >> 2, self.d >> 2
        h0 = np.maximum(diag, np.maximum(F1, F2))
        move = np.where(diag == h0, 0, np.where(F1 == h0, 1, 2))
        code = (move | ((3 - (self.d & 3)) << 3) | ((3 - (p1 & 3)) << 5)
                | np.where(open1, 0, 128) | ((3 - (p2 & 3)) << 8)
                | np.where(open2, 0, 1024))
        return h0, F1, F2, code


def pass2(h0, code, r1, r2, b, g):
    """csrc/poa.cu cell_pass2_live (no mask past the query)."""
    E1 = np.maximum(NEG, r1 - g["o1"] - g["e1"] * b)
    E2 = np.maximum(NEG, r2 - g["o2"] - g["e2"] * b)
    H = np.maximum(h0, np.maximum(E1, E2))
    code = np.where(H != h0, (code & ~7) | np.where(H == E1, 3, 4), code)
    return H, E1, E2, code


def ext_bits(E1, E2, pE1, pE2, g):
    return (np.where(E1 == pE1 - g["e1"], 2048, 0)
            | np.where(E2 == pE2 - g["e2"], 4096, 0))


def seg_excl_scan(agg, width):
    """Exclusive max-scan within segments of `width` lanes (INT_MIN at
    each segment's first lane), as the kernels' shuffle scans give it."""
    out = np.empty_like(agg)
    for s in range(0, len(agg), width):
        seg = agg[s:s + width]
        out[s:s + width] = np.concatenate(
            [[INT_MIN], np.maximum.accumulate(seg)[:-1]])
    return out


class TeamRow:
    """One team's view of a node row: lanes, warps, the lane scan and the
    cross-warp carries, as the kernels compute them."""

    def __init__(self, shape):
        self.C, self.TL, self.NW = shape
        self.lanes = self.TL * self.NW
        self.cover = self.lanes * self.C
        self.b = np.arange(self.cover, dtype=np.int64)

    def pass2_row(self, h0, code, g):
        """The scan, the carries across warps (from the published
        aggregates), pass 2 and the extend bits.  Returns (H, code,
        edges): the neighbour warps' edge cells rebuilt from what each
        warp published."""
        C, b = self.C, self.b
        Z1 = (h0 + g["e1"] * b).reshape(self.lanes, C)
        Z2 = (h0 + g["e2"] * b).reshape(self.lanes, C)
        agg1, agg2 = Z1.max(axis=1), Z2.max(axis=1)
        aggx1 = Z1[:, :C - 1].max(axis=1)
        aggx2 = Z2[:, :C - 1].max(axis=1)
        x1 = seg_excl_scan(agg1, 32 if self.NW > 1 else self.TL)
        x2 = seg_excl_scan(agg2, 32 if self.NW > 1 else self.TL)
        carry1 = np.full(self.lanes, NEG, np.int64)
        carry2 = np.full(self.lanes, NEG, np.int64)
        pub = []
        if self.NW > 1:
            for w in range(self.NW):
                last, first = 32 * w + 31, 32 * w
                pub.append(dict(
                    w1=max(x1[last], agg1[last]), w2=max(x2[last], agg2[last]),
                    a1=max(x1[last], aggx1[last]),
                    a2=max(x2[last], aggx2[last]),
                    h0f=h0[first * C], h0l=h0[last * C + C - 1]))
            c1 = c2 = NEG
            for w in range(self.NW):
                carry1[32 * w:32 * w + 32] = c1
                carry2[32 * w:32 * w + 32] = c2
                c1, c2 = max(c1, pub[w]["w1"]), max(c2, pub[w]["w2"])
        r1 = np.maximum(carry1, x1)[:, None]
        r2 = np.maximum(carry2, x2)[:, None]
        # exclusive prefix maxima inside each lane
        pre1 = np.concatenate([r1, np.maximum(
            r1, np.maximum.accumulate(Z1, axis=1))[:, :-1]], axis=1)
        pre2 = np.concatenate([r2, np.maximum(
            r2, np.maximum.accumulate(Z2, axis=1))[:, :-1]], axis=1)
        H, E1, E2, code = pass2(h0, code, pre1.reshape(-1),
                                pre2.reshape(-1), b, g)
        # the E of cell b - 1: the same lane, the left lane of the
        # segment, NEG at the team's first lane, and at a warp's first
        # lane the previous warp's last cell rebuilt from what it published
        pE1 = np.concatenate([[NEG], E1[:-1]])
        pE2 = np.concatenate([[NEG], E2[:-1]])
        seg = 32 * C if self.NW > 1 else self.TL * C
        pE1[::seg] = NEG
        pE2[::seg] = NEG
        edges = {}
        if self.NW > 1:
            for w in range(1, self.NW):
                bl = 32 * C * w - 1
                c_prev1 = max([NEG] + [pub[u]["w1"] for u in range(w - 1)])
                c_prev2 = max([NEG] + [pub[u]["w2"] for u in range(w - 1)])
                Hl, El1, El2, _ = pass2(
                    pub[w - 1]["h0l"], 0, max(c_prev1, pub[w - 1]["a1"]),
                    max(c_prev2, pub[w - 1]["a2"]), bl, g)
                assert Hl == H[bl] and El1 == E1[bl] and El2 == E2[bl]
                pE1[bl + 1], pE2[bl + 1] = El1, El2
                edges[("left", w)] = int(Hl)
            for w in range(self.NW - 1):
                bf = 32 * C * (w + 1)
                Hf, _e1, _e2, _ = pass2(
                    pub[w + 1]["h0f"], 0, int(carry1[32 * w + 32]),
                    int(carry2[32 * w + 32]), bf, g)
                assert Hf == H[bf]
                edges[("right", w)] = int(Hf)
        code = code | ext_bits(E1, E2, pE1, pE2, g)
        return H, code, edges

    def neighbours(self, row, edges, which):
        """row[b - 1] (left) or row[b + 1] (right) as a lane reads it:
        shuffles inside a segment, NEG past the team's cover, and at a
        warp's edge the cell rebuilt from the neighbour warp's published
        values (edges; F1/F2 of a first cell are published as they are)."""
        C = self.C
        if which == "left":
            out = np.concatenate([[NEG], row[:-1]])
            for w in range(1, self.NW):
                out[32 * C * w] = edges.get(("left", w), row[32 * C * w - 1])
        else:
            out = np.concatenate([row[1:], [NEG]])
            for w in range(self.NW - 1):
                out[32 * C * (w + 1) - 1] = edges.get(("right", w),
                                                      row[32 * C * (w + 1)])
        return out


def _stage_q(q_row, qlo, L, Lq, width):
    """The staged query window: codes qlo .. qlo + width - 1 (5 past the
    query)."""
    j = qlo + np.arange(width)
    return np.where(j <= min(L, Lq - 1), q_row[np.minimum(j, Lq - 1)], 5)


def _q_codes(q_row, win, qlo, j, L):
    """A cell's code from the staged window, or from device memory when
    its column falls outside it."""
    jj = np.clip(j, 0, L)
    k = jj - qlo
    inside = (k >= 0) & (k < len(win))
    return np.where(inside, win[np.clip(k, 0, len(win) - 1)], q_row[jj])


def chain_model(inputs, band, shape):
    """poa_chain_kernel<C, TL, NW>'s schedule: H, dirs and ends with the
    unwritten cells POISON."""
    bases, preds, off, q_ext, l_len, n_nodes = inputs
    g = GAPS
    P, N = bases.shape
    Lq = q_ext.shape[1]
    team = TeamRow(shape)
    C, TL, NW, cover = team.C, team.TL, team.NW, team.cover
    assert cover <= band
    tile = 32 * NW if NW > 1 else 64
    qwin = cover + tile
    per_warp = 32 // TL if NW == 1 else 1
    H = np.full((P, N, band), POISON, np.int64)
    dirs = np.full((P, N, band), POISON, np.int64)
    ends = np.full((P, N), POISON, np.int64)
    b = team.b
    for w0 in range(0, P, per_warp):
        warp = range(w0, min(P, w0 + per_warp))
        nv = max(int(n_nodes[p]) for p in warp)
        for p in warp:
            L, n = int(l_len[p]), int(n_nodes[p])
            pH = np.full(cover, NEG, np.int64)
            pF1, pF2 = pH.copy(), pH.copy()
            edges = {}
            off_prev = 0
            for v0 in range(0, nv, tile):
                words = [int(off[p, v]) * 16 + (int(bases[p, v]) << 1)
                         + int(preds[p, v, 0] < 0) if v < n else 0
                         for v in range(v0, v0 + tile)]
                qlo = max(0, int(off[p, v0])) if v0 < n else 0
                win = _stage_q(q_ext[p], qlo, L, Lq, qwin)
                for i in range(min(tile, nv - v0)):
                    v = v0 + i
                    wd = words[i]
                    off_v, base, src = wd >> 4, (wd >> 1) & 7, wd & 1
                    d = 0 if src else off_v - off_prev
                    j = off_v + b
                    s = SUB[base, _q_codes(q_ext[p], win, qlo, j, L)]
                    if src:
                        Hk, Hd = row0_at(j, g), row0_at(j - 1, g)
                        F1k = F2k = np.full(cover, NEG, np.int64)
                    elif d:
                        Hk = team.neighbours(pH, edges, "right")
                        F1k = np.concatenate([pF1[1:], [NEG]])
                        F2k = np.concatenate([pF2[1:], [NEG]])
                        Hd = pH
                    else:
                        Hk, F1k, F2k = pH, pF1, pF2
                        Hd = team.neighbours(pH, edges, "left")
                    cd = Cands(cover)
                    cd.empty(1, s, g)
                    cd.slot(0, Hk, F1k, F2k, Hd, s, g)
                    h0, F1o, F2o, code = cd.cell()
                    Hrow, code, edges = team.pass2_row(h0, code, g)
                    pH, pF1, pF2, off_prev = Hrow, F1o, F2o, off_v
                    if v < n:
                        live = j <= L
                        H[p, v, :cover][live] = Hrow[live]
                        dirs[p, v, :cover][live] = code[live]
                        bL = L - off_v
                        ends[p, v] = Hrow[bL] if 0 <= bL < band else NEG
    return H, dirs, ends


def _check_model(got, inputs, band):
    H, dirs, ends = got
    Hp, dp, ep = _plain(inputs, band)
    live = _mask(inputs, band)
    np.testing.assert_array_equal(H[live], Hp[live])
    np.testing.assert_array_equal(dirs[live].astype(np.int16), dp[live])
    assert (H[~live] == POISON).all() and (dirs[~live] == POISON).all()
    n = inputs[5]
    real = np.arange(H.shape[1])[None, :] < n[:, None]
    np.testing.assert_array_equal(ends[real], ep[real])
    assert (ends[~real] == POISON).all()


@pytest.mark.parametrize("P,N,lq,band,shift", [
    (9, 64, 60, 64, 0),     # full width, offsets 0, ragged n and L
    (6, 48, 200, 64, 0),    # banded, offsets stepping (and jumping at a
                            # middle source)
    (5, 40, 110, 128, 0),
    (3, 70, 300, 256, 0),
    # negative offsets: live cells left of column 0, where F runs below
    # NEG and an empty slot's extend candidate wins
    (6, 40, 50, 64, -9)])
def test_chain_model_equals_plain(P, N, lq, band, shift):
    inputs = ragged_batch(P * N + band, P, N, lq, band, chain=True)
    inputs[2][:] += shift
    assert poa_cuda.chain_certified(inputs[1], inputs[2])
    max_live = poa_cuda.check_live(*(inputs[k] for k in (1, 2, 4, 5)),
                                   band)
    if not shift:
        assert max_live <= banded_cuda.live_width(inputs[4], band)
    shape = poa_cuda.team_shape(max_live, "poa_chain", P)
    _check_model(chain_model(inputs, band, shape), inputs, band)
    if shift:
        dirs = _plain(inputs, band)[1][_mask(inputs, band)]
        assert ((dirs >> 5) & 7 == 5).any()      # F1: slot 1, extend


def _shipped(kernel):
    """(shape, cover, problems): each team shape of `kernel` with a launch
    size that team_shape picks it for."""
    out = [(shape, cover, 3 if shape[2] > 1 else 6)
           for cover, shape in poa_cuda.TEAM_SHAPES[kernel].items()]
    if kernel == "poa_chain":
        out.append((poa_cuda.POA_CHAIN_PACKED, 64,
                    poa_cuda.POA_CHAIN_PACKED_PROBLEMS))
    return out


def _macro_shapes(name):
    """The (C, TL, NW) instances a shape macro of csrc/poa.cu lists."""
    import pathlib
    import re
    src = (pathlib.Path(poa_cuda.__file__).parent.parent / "csrc"
           / "poa.cu").read_text()
    body = re.search(rf"#define {name}\(.*?\)((?:.*\\\n)*.*)", src).group(1)
    return [tuple(int(x) for x in m)
            for m in re.findall(r"\((\d+), (\d+), (\d+)\)", body)]


def test_team_shapes():
    """Every cover's shape covers it, csrc/poa.cu compiles exactly the
    table's shapes, and team_shape picks each: the fewest cells a lane,
    but poa_chain (and poa_linear, one problem a launch) 4 from cover 512
    on and poa_chain on large cover-64 launches.  Rows past the widest
    cover take the wide route."""
    for kernel in ("poa_chain", "poa_affine", "poa_linear"):
        table = poa_cuda.TEAM_SHAPES[kernel]
        assert list(table) == [32 << k for k in range(10)]
        for cover, (C, TL, NW) in table.items():
            assert C * TL * NW == cover and TL in (16, 32)
            assert NW == 1 or TL == 32
        for shape, cover, problems in _shipped(kernel):
            assert poa_cuda.team_shape(cover, kernel, problems) == shape
            assert poa_cuda.team_shape(cover // 2 + 1, kernel,
                                       problems) == shape
    assert sorted(_macro_shapes("POA_CHAIN_SHAPES")) == sorted(
        s for s, _c, _p in _shipped("poa_chain"))
    assert sorted(_macro_shapes("POA_AFFINE_SHAPES")) == sorted(
        s for s, _c, _p in _shipped("poa_affine"))
    assert sorted(_macro_shapes("POA_LINEAR_SHAPES")) == sorted(
        s for s, _c, _p in _shipped("poa_linear"))
    assert poa_cuda.team_cover(1) == 32
    shape = poa_cuda.team_shape
    assert shape(11, "poa_affine", 2) == (2, 16, 1)
    assert shape(62, "poa_chain", 3952) == (2, 32, 1)
    assert shape(62, "poa_chain", 15771) == (4, 16, 1)
    assert shape(62, "poa_affine", 4866) == (2, 32, 1)
    assert shape(411, "poa_chain", 1) == (4, 32, 4)
    assert shape(411, "poa_affine", 1) == (2, 32, 8)
    assert shape(3001, "poa_chain", 1) == (8, 32, 16)
    assert shape(10001, "poa_affine", 1) == (32, 32, 16)
    assert shape(513, "poa_linear", 1) == (4, 32, 8)
    assert shape(382, "poa_linear", 1) == (4, 32, 4)
    assert poa_cuda.poa_route(poa_cuda.POA_MAX_COVER) == "team"
    assert poa_cuda.poa_route(poa_cuda.POA_MAX_COVER + 1) == "wide"
    assert poa_cuda.team_cover(poa_cuda.POA_MAX_COVER + 1) == \
        2 * poa_cuda.POA_MAX_COVER
    assert [poa_cuda.history_stride(w) for w in (1, 11, 12, 62)] == [
        4, 12, 12, 64]


def _filling_batch(seed, shape, band, chain):
    """A batch whose widest row fills the team's cover, so every lane,
    segment edge and warp edge meets live cells."""
    C, TL, NW = shape
    cover = C * TL * NW
    inputs = ragged_batch(seed, 3 if NW > 1 else 6, 24, cover + 40, band,
                          chain=chain, n_lo=10)
    inputs[4][:] = np.minimum(inputs[4], cover - 1 + inputs[2][:, 0])
    inputs[4][0] = cover - 1
    max_live = poa_cuda.check_live(*(inputs[k] for k in (1, 2, 4, 5)), band)
    assert cover // 2 < max_live <= cover
    return inputs, max_live


@pytest.mark.parametrize("shape,band,problems", _shipped("poa_chain"))
def test_chain_model_every_team_shape(shape, band, problems):
    """Each team shape poa_chain ships, on a batch that fills its cover."""
    inputs, _live = _filling_batch(band + shape[0] + 1, shape, band, True)
    _check_model(chain_model(inputs, band, shape), inputs, band)


def affine_model(inputs, band, shape, max_live):
    """poa_affine_kernel<C, TL, NW>'s schedule: each team's history rows
    (H, F1, F2 of the cover cells, written on live cells only, POISON
    elsewhere) read at each predecessor slot's offset step, the slots the
    contract reads as NEG rows (empty, or p >= v) staged as -1."""
    bases, preds, off, q_ext, l_len, n_nodes = inputs
    g = GAPS
    P, N = bases.shape
    Lq = q_ext.shape[1]
    team = TeamRow(shape)
    C, TL, NW, cover = team.C, team.TL, team.NW, team.cover
    assert cover <= band
    tile = 32 * NW if NW > 1 else 32
    qwin = cover + tile
    per_warp = 32 // TL if NW == 1 else 1
    H = np.full((P, N, band), POISON, np.int64)
    dirs = np.full((P, N, band), POISON, np.int64)
    ends = np.full((P, N), POISON, np.int64)
    b = team.b
    for w0 in range(0, P, per_warp):
        warp = range(w0, min(P, w0 + per_warp))
        nv = max(int(n_nodes[p]) for p in warp)
        for p in warp:
            L, n = int(l_len[p]), int(n_nodes[p])
            stride = poa_cuda.history_stride(max_live)
            hist = np.full((3, N, stride), POISON, np.int64)
            for v0 in range(0, nv, tile):
                staged = []
                for v in range(v0, v0 + tile):
                    if v >= n:
                        staged.append((0, [-1] * MP, [0] * MP))
                        continue
                    pv = preds[p, v]
                    slots = [int(x) if 0 <= x < v else -1 for x in pv]
                    steps = [int(off[p, v]) - int(off[p, x]) if x >= 0 else 0
                             for x in slots]
                    word = (int(off[p, v]) * 16 + (int(bases[p, v]) << 1)
                            + int(not (pv >= 0).any()))
                    staged.append((word, slots, steps))
                qlo = max(0, int(off[p, v0])) if v0 < n else 0
                win = _stage_q(q_ext[p], qlo, L, Lq, qwin)
                for i in range(min(tile, nv - v0)):
                    v = v0 + i
                    wd, slots, steps = staged[i]
                    off_v, base, src = wd >> 4, (wd >> 1) & 7, wd & 1
                    j = off_v + b
                    s = SUB[base, _q_codes(q_ext[p], win, qlo, j, L)]
                    cd = Cands(cover)
                    empty = [k for k in range(MP)
                             if slots[k] < 0 and not (src and k == 0)]
                    if empty:
                        cd.empty(min(empty), s, g)
                    if src:
                        cd.slot(0, row0_at(j, g), NEG, NEG, row0_at(j - 1, g),
                                s, g)
                    for k, (x, dv) in enumerate(zip(slots, steps)):
                        if x < 0:
                            continue
                        gi = dv + b
                        ok = (gi >= 0) & (gi < stride)
                        okd = (gi - 1 >= 0) & (gi - 1 < stride)
                        gc = np.clip(gi, 0, stride - 1)
                        gd = np.clip(gi - 1, 0, stride - 1)
                        Hk = np.where(ok, hist[0, x, gc], NEG)
                        Hd = np.where(okd, hist[0, x, gd], NEG)
                        # a live cell reads only written history cells
                        live = (j <= L) & (v < n)
                        assert (Hk[live & ok] != POISON).all()
                        assert (Hd[live & okd] != POISON).all()
                        cd.slot(k, Hk, np.where(ok, hist[1, x, gc], NEG),
                                np.where(ok, hist[2, x, gc], NEG), Hd, s, g)
                    h0, F1o, F2o, code = cd.cell()
                    Hrow, code, _edges = team.pass2_row(h0, code, g)
                    if v < n:
                        live = j <= L
                        assert not live[stride:].any()
                        H[p, v, :cover][live] = Hrow[live]
                        dirs[p, v, :cover][live] = code[live]
                        hist[0, v][live[:stride]] = Hrow[:stride][live[:stride]]
                        hist[1, v][live[:stride]] = F1o[:stride][live[:stride]]
                        hist[2, v][live[:stride]] = F2o[:stride][live[:stride]]
                        bL = L - off_v
                        ends[p, v] = Hrow[bL] if 0 <= bL < band else NEG
    return H, dirs, ends


@pytest.mark.parametrize("P,N,lq,band,shift", [
    (9, 64, 60, 64, 0),     # full width, ragged n and L
    (7, 40, 40, 64, 0),     # history rows narrower than the cover
    (6, 48, 200, 64, 0),    # banded, offsets jumping by up to 3
    (5, 40, 110, 128, 0),
    (3, 60, 300, 256, 0),
    (6, 40, 50, 64, -9)])   # negative offsets
def test_affine_model_equals_plain(P, N, lq, band, shift):
    inputs = ragged_batch(P * N + band + 1, P, N, lq, band, chain=False)
    inputs[2][:] += shift
    assert not poa_cuda.chain_certified(inputs[1], inputs[2])
    max_live = poa_cuda.check_live(*(inputs[k] for k in (1, 2, 4, 5)),
                                   band)
    shape = poa_cuda.team_shape(max_live, "poa_affine", P)
    _check_model(affine_model(inputs, band, shape, max_live), inputs, band)


@pytest.mark.parametrize("shape,band,problems", _shipped("poa_affine"))
def test_affine_model_team_shapes(shape, band, problems):
    """Each team shape poa_affine ships, on a batch that fills its cover."""
    inputs, max_live = _filling_batch(band + 2, shape, band, False)
    _check_model(affine_model(inputs, band, shape, max_live), inputs, band)


# ---------------------------------------------------------------- poa_linear

def linear_model(bases, preds, q, n, L, shape, gap=30, match=10,
                 mismatch=-15):
    """poa_linear_kernel<C, NW>'s schedule: one team of NW warps, C cells
    a lane (lane t owns columns t C .. t C + C - 1 of the cover), only the
    real nodes v < n and the columns j <= L.  Per node: packed first-maximum
    candidates over the four slots (the lowest slot that reads NEG rows
    standing for all of them; the previous node's row from the lanes'
    registers, its cell left of each lane from the lane before or, at a
    warp's edge, rebuilt from the warp carries; other rows from the rows
    written so far), the warp's inclusive max-scan of h0 + gap j and its
    exclusive shift, the warps' carries from their aggregates, pass 2, and
    stores on the live cells only.  Unwritten cells hold POISON."""
    C, _TL, NW = shape
    lanes = 32 * NW
    N, Lq = len(bases), len(q)
    H = np.full((N, Lq + 1), POISON, np.int64)
    dirs = np.full((N, Lq + 1), POISON & 0xFF, np.int64)
    ends = np.full(N, POISON, np.int64)
    j = np.arange(lanes * C).reshape(lanes, C)
    qc = np.where((j >= 1) & (j <= L), q[np.clip(j - 1, 0, Lq - 1)], 5)
    warp = np.arange(lanes) // 32
    bw = np.arange(NW) * 32 * C
    pH = np.full((lanes, C), NEG, np.int64)
    xl = np.full(NW, NEG, np.int64)

    def pack(val, k):
        out = val * 4 + 3 - k
        assert (np.abs(out) < 1 << 31).all()
        return out

    for v in range(n):
        has = (preds[v] >= 0).any()
        src = not has
        prk = [int(p) if 0 <= p < v else -1 for p in preds[v]]
        empty = [k for k in range(MP) if prk[k] < 0 and not (src and k == 0)]
        s = np.where(qc == bases[v], match, mismatch)
        cd = np.full((lanes, C), INT_MIN, np.int64)
        cl = np.full((lanes, C), INT_MIN, np.int64)
        if empty:
            k = min(empty)
            cd = pack(np.where(j > 0, NEG + s, NEG), k)
            cl = pack(np.full_like(j, NEG - gap), k)
        if src:
            cd = np.maximum(cd, pack(np.where(j > 0, -gap * (j - 1) + s,
                                              NEG), 0))
            cl = np.maximum(cl, pack(-gap * j - gap, 0))
        # the previous row's cell left of each lane's first cell
        hl = np.concatenate([[NEG], pH[:-1, C - 1]])
        hl[::32] = xl
        for k, p in enumerate(prk):
            if p < 0:
                continue
            if p == v - 1:
                hw = np.concatenate([hl[:, None], pH], axis=1)
            else:
                cols = np.arange(-1, lanes * C).reshape(1, -1)
                ok = (cols >= 0) & (cols <= L)
                row = np.where(ok, H[p, np.clip(cols, 0, Lq)], NEG)[0]
                assert (row != POISON).all()    # only written cells
                hw = np.stack([row[t * C:t * C + C + 1]
                               for t in range(lanes)])
            cd = np.maximum(cd, pack(np.where(j > 0, hw[:, :C] + s, NEG), k))
            cl = np.maximum(cl, pack(hw[:, 1:] - gap, k))
        bd, bl = cd >> 2, cl >> 2
        h0 = np.maximum(bd, bl)
        code = np.where(bd >= bl, (3 - (cd & 3)) << 2,
                        1 | ((3 - (cl & 3)) << 2))
        agg = (h0 + gap * j).max(axis=1)
        incl = np.concatenate([np.maximum.accumulate(agg[w * 32:w * 32 + 32])
                               for w in range(NW)])
        x = np.concatenate([[INT_MIN], incl[:-1]])
        x[::32] = INT_MIN
        tot = incl[31::32]
        carry = np.array([tot[:w].max(initial=INT_MIN) for w in range(NW)])
        xl = np.where(np.arange(NW) > 0, carry - gap * (bw - 1), NEG)
        r = np.maximum(carry[warp], x)
        for c in range(C):
            r = np.maximum(r, h0[:, c] + gap * j[:, c])
            y = r - gap * j[:, c]
            code[:, c] = np.where(y != h0[:, c], (code[:, c] & ~3) | 2,
                                  code[:, c])
            pH[:, c] = y
        live = j.ravel() <= L
        H[v, j.ravel()[live]] = pH.ravel()[live]
        dirs[v, j.ravel()[live]] = code.ravel()[live]
        if L == Lq:
            ends[v] = H[v, Lq]
    return H, dirs, ends


def _linear_case(seed, N, n, Lq, L):
    """A bubbled DAG with forward predecessors in a bin of N nodes (the
    pad nodes after its n real nodes are sources) and a query of L codes
    padded to Lq, as poa_align pads them."""
    rng = np.random.default_rng(seed)
    bases = np.zeros(N, np.uint8)
    preds = np.full((N, MP), -1, np.int32)
    bases[:n], preds[:n] = _dag(rng, n)
    preds[:n][preds[:n] >= n] = -1
    q = np.full(Lq, 5, np.uint8)
    q[:L] = rng.integers(0, 4, L)
    return bases, preds, q


def _check_linear_model(bases, preds, q, n, L, shape):
    H, dirs, ends = linear_model(bases, preds, q, n, L, shape)
    Hp, dp, ep = (x.numpy() for x in tpoa.poa_align_scan(
        *(torch.from_numpy(a) for a in (bases, preds, q)), gap=30,
        match=10, mismatch=-15))
    live = poa_cuda.linear_live_mask(len(bases), len(q), n, L).numpy()
    np.testing.assert_array_equal(H[live], Hp[live])
    np.testing.assert_array_equal(dirs[live], dp[live])
    assert (H[~live] == POISON).all()
    if L == len(q):
        np.testing.assert_array_equal(ends[:n], ep[:n])


@pytest.mark.parametrize("shape,cover,_p", _shipped("poa_linear")[:8])
def test_linear_model_every_team_shape(shape, cover, _p):
    """Each poa_linear team shape up to cover 4096 on a query that fills
    its cover, with pad nodes and pad columns outside the live cells."""
    bases, preds, q = _linear_case(cover, 40, 33, cover, cover - 1)
    assert poa_cuda.team_shape(cover - 1 + 1, "poa_linear", 1) == shape
    _check_linear_model(bases, preds, q, 33, cover - 1, shape)


@pytest.mark.parametrize("N,n,Lq,L", [(64, 64, 40, 40), (128, 90, 128, 100),
                                      (16, 1, 64, 0), (32, 20, 256, 200)])
def test_linear_model_live_extents(N, n, Lq, L):
    """poa_align's extents: a full grid (ends on the real nodes), a padded
    one, a single node with an empty query, rows narrower than the cover
    the warps' lanes span."""
    bases, preds, q = _linear_case(N + L, N, n, Lq, L)
    shape = poa_cuda.team_shape(L + 1, "poa_linear", 1)
    _check_linear_model(bases, preds, q, n, L, shape)
