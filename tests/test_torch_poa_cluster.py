"""The POA wide route's thread-block clusters, modelled on the CPU.

csrc/poa_cluster.cu runs rows wider than the widest team cover (poa_route)
as one thread-block cluster a problem: each CTA a contiguous slice of the
live row, each lane C cells of it.  A node is pass 1 (the predecessor
cells: the previous row from the lanes' registers, any other row of a DAG
from its history rows at the slot's band-offset step, anywhere in the
row), the row's exchange (the lanes' max-scans by warp, each warp's
published totals and edge cells, each CTA's totals pushed into the later
CTAs and its edge cells into its neighbours', one cluster barrier; the
carries and the cells across warp and CTA edges rebuilt from those) and
pass 2.  Here:
- numpy models of both cluster kernels' schedules, scaled down so that
  CTA edges fall inside small rows (2-16 CTAs x 1-2 warps of 2-8 lanes x
  2-6 cells; a warp has 32 lanes on the card), on band offsets that step
  across CTA slices (chip_smoke.poa_offset_batch, scaled down), a chain's
  middle source that jumps past a slice, DAG predecessors many slices
  away, ragged n_nodes and l_len, duplicate predecessor slots (exact
  first-maximum ties), negative offsets and covers past the band: each
  bit-equal to the plain version and to the JAX package on the live
  cells, writing no other cell, and every edge cell rebuilt from the
  published values equal to the row's own;
- the Python side's cluster constants are the ones csrc compiles, and
  the old one-block wide kernels are gone.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cactus_tpu.ops import poa as jpoa
from cactus_tpu_torch.ops import poa as tpoa
from cactus_tpu_torch.ops import poa_cuda
from test_torch_poa_live import (GAPS, INT_MIN, MP, NEG, POISON, SUB, Cands,
                                 _check_model, _linear_case, _mask,
                                 ext_bits, pass2, row0_at)

CSRC = pathlib.Path(poa_cuda.__file__).parent.parent / "csrc"
LINEAR = dict(gap=30, match=10, mismatch=-15)


class Cluster:
    """One cluster's geometry: `ctas` CTAs of `warps` warps of `wl` lanes,
    C consecutive cells a lane (lane G owns cells G C .. G C + C - 1)."""

    def __init__(self, ctas, warps, wl, C):
        self.ctas, self.warps, self.wl, self.C = ctas, warps, wl, C
        self.lanes = ctas * warps * wl
        self.nwg = ctas * warps                 # warps of the cluster
        self.cover = self.lanes * C
        self.b = np.arange(self.cover, dtype=np.int64)
        self.wcells = wl * C                    # cells a warp
        self.bw = np.arange(self.nwg) * self.wcells   # each warp's first

    def rank(self, w):
        return w // self.warps

    def left(self, row, xl):
        """row[b - 1] as the lanes read it: their own cells, the left
        lane's last by a shuffle, at a warp's first cell the rebuilt edge
        (xl, NEG left of the row)."""
        out = np.concatenate([[NEG], row[:-1]])
        out[self.bw] = xl
        return out

    def right(self, row, xr):
        """row[b + 1]: at a warp's last cell the rebuilt edge (xr)."""
        out = np.concatenate([row[1:], [NEG]])
        out[self.bw + self.wcells - 1] = xr
        return out

    def lane_max(self, Z):
        """Each lane's max of Z, and the same without its last cell."""
        Z = Z.reshape(self.lanes, self.C)
        return Z.max(axis=1), Z[:, :-1].max(axis=1, initial=INT_MIN)

    def warp_scan(self, agg):
        """The exclusive and inclusive max-scans inside each warp."""
        x = np.empty_like(agg)
        for w in range(self.nwg):
            seg = agg[w * self.wl:(w + 1) * self.wl]
            x[w * self.wl:(w + 1) * self.wl] = np.concatenate(
                [[INT_MIN], np.maximum.accumulate(seg)[:-1]])
        return x, np.maximum(x, agg)

    def carries(self, wtot, seed):
        """From each warp's total: the carry entering each CTA and the one
        before it (the later CTAs' rings: the earlier CTAs' totals), and
        entering each warp and the warp before it (its CTA's published
        totals).  seed: the carry entering the row."""
        ctot = [max(wtot[k * self.warps:(k + 1) * self.warps])
                for k in range(self.ctas)]
        cc = [max([seed] + ctot[:k]) for k in range(self.ctas)]
        cp = [max([seed] + ctot[:k - 1]) for k in range(self.ctas)]
        cw, wp = np.empty(self.nwg, np.int64), np.empty(self.nwg, np.int64)
        for w in range(self.nwg):
            k, u = self.rank(w), w % self.warps
            first = k * self.warps
            cw[w] = max([cc[k]] + list(wtot[first:first + u]))
            wp[w] = max([cc[k]] + list(wtot[first:first + max(0, u - 1)]))
        return ctot, cc, cp, cw, wp


def _affine_exchange(cl, h0, code, nF1, nF2, g, edges):
    """The affine row's exchange and pass 2, as poa_cluster_kernel runs
    them; edges holds the rebuilt neighbour cells (xl_H, xr_H, xr_F1,
    xr_F2 by warp), updated in place.  Returns (H, code)."""
    C, b = cl.C, cl.b
    Z1, Z2 = h0 + g["e1"] * b, h0 + g["e2"] * b
    agg1, aggx1 = cl.lane_max(Z1)
    agg2, aggx2 = cl.lane_max(Z2)
    x1, r1 = cl.warp_scan(agg1)
    x2, r2 = cl.warp_scan(agg2)
    last = np.arange(cl.nwg) * cl.wl + cl.wl - 1     # each warp's last lane
    first = np.arange(cl.nwg) * cl.wl
    # what each warp publishes
    w1, w2 = r1[last], r2[last]
    a1 = np.maximum(x1[last], aggx1[last])
    a2 = np.maximum(x2[last], aggx2[last])
    h0l, h0f = h0[last * C + C - 1], h0[first * C]
    F1f, F2f = nF1[first * C], nF2[first * C]
    # each CTA's totals, and without its last cell (pushed to the next)
    _ct1, _cc1, cp1, cw1, wp1 = cl.carries(w1, NEG)
    _ct2, _cc2, cp2, cw2, wp2 = cl.carries(w2, NEG)
    X1 = [max(list(w1[k * cl.warps:(k + 1) * cl.warps - 1])
              + [a1[(k + 1) * cl.warps - 1]]) for k in range(cl.ctas)]
    X2 = [max(list(w2[k * cl.warps:(k + 1) * cl.warps - 1])
              + [a2[(k + 1) * cl.warps - 1]]) for k in range(cl.ctas)]
    # pass 2 from the lane's carry
    lane_warp = np.arange(cl.lanes) // cl.wl
    q1 = np.maximum(cw1[lane_warp], x1)[:, None]
    q2 = np.maximum(cw2[lane_warp], x2)[:, None]
    pre1 = np.concatenate([q1, np.maximum(q1, np.maximum.accumulate(
        Z1.reshape(cl.lanes, C), axis=1))[:, :-1]], axis=1).reshape(-1)
    pre2 = np.concatenate([q2, np.maximum(q2, np.maximum.accumulate(
        Z2.reshape(cl.lanes, C), axis=1))[:, :-1]], axis=1).reshape(-1)
    H, E1, E2, code = pass2(h0, code, pre1, pre2, b, g)
    # the E of cell b - 1: the lane's own, the left lane's by a shuffle,
    # and across a warp's (CTA's) left edge the cell rebuilt from the
    # published values
    pE1 = np.concatenate([[NEG], E1[:-1]])
    pE2 = np.concatenate([[NEG], E2[:-1]])
    for w in range(cl.nwg):
        k, u = cl.rank(w), w % cl.warps
        bl = cl.bw[w] - 1
        if u > 0:
            Hl, El1, El2, _ = pass2(h0l[w - 1], 0, max(wp1[w], a1[w - 1]),
                                    max(wp2[w], a2[w - 1]), bl, g)
        elif k > 0:
            prev = k * cl.warps - 1     # the previous CTA's last warp
            Hl, El1, El2, _ = pass2(h0l[prev], 0, max(cp1[k], X1[k - 1]),
                                    max(cp2[k], X2[k - 1]), bl, g)
        else:
            Hl = El1 = El2 = NEG
        if w > 0:
            assert (Hl, El1, El2) == (H[bl], E1[bl], E2[bl])
        pE1[cl.bw[w]], pE2[cl.bw[w]] = El1, El2
        edges["xl_H"][w] = Hl
        # the cell right of the warp's last, for the next node
        cn1, cn2 = max(cw1[w], w1[w]), max(cw2[w], w2[w])
        bf = cl.bw[w] + cl.wcells
        if u < cl.warps - 1 or k < cl.ctas - 1:
            Hr, _e1, _e2, _ = pass2(h0f[w + 1], 0, cn1, cn2, bf, g)
            assert Hr == H[bf]
            edges["xr_H"][w] = Hr
            edges["xr_F1"][w], edges["xr_F2"][w] = F1f[w + 1], F2f[w + 1]
            assert F1f[w + 1] == nF1[bf] and F2f[w + 1] == nF2[bf]
    code = code | ext_bits(E1, E2, pE1, pE2, g)
    return H, code


def cluster_affine_model(inputs, band, max_live, geom, dag):
    """poa_cluster_kernel's schedule (kDag: history rows of every node in
    global scratch, read at each slot's step; else a chain_certified batch
    read from the registers): H, dirs and ends with the unwritten cells
    POISON."""
    bases, preds, off, q_ext, l_len, n_nodes = inputs
    g = GAPS
    cl = Cluster(*geom)
    assert cl.cover >= max_live
    P, N = bases.shape
    b = cl.b
    stride = poa_cuda.history_stride(max_live)
    H = np.full((P, N, band), POISON, np.int64)
    dirs = np.full((P, N, band), POISON, np.int64)
    ends = np.full((P, N), POISON, np.int64)
    for p in range(P):
        L, n = int(l_len[p]), int(n_nodes[p])
        pH = np.full(cl.cover, NEG, np.int64)
        pF1, pF2 = pH.copy(), pH.copy()
        edges = {k: np.full(cl.nwg, NEG, np.int64)
                 for k in ("xl_H", "xr_H", "xr_F1", "xr_F2")}
        hist = np.full((3, N, stride), POISON, np.int64)
        off_prev = 0
        for v in range(n):
            ov = int(off[p, v])
            src = not (preds[p, v] >= 0).any()
            if dag:
                slots = [int(x) if 0 <= x < v else -1 for x in preds[p, v]]
                steps = [ov - int(off[p, x]) if x >= 0 else 0 for x in slots]
                empty = [k for k in range(MP)
                         if slots[k] < 0 and not (src and k == 0)]
                kmin = min(empty, default=MP)
            else:
                slots = [-1 if src else v - 1] + [-1] * (MP - 1)
                steps = [0 if src else ov - off_prev] + [0] * (MP - 1)
                kmin = 1
            reg = [x == v - 1 and d in (0, 1) for x, d in zip(slots, steps)]
            j = ov + b
            s = SUB[int(bases[p, v]), q_ext[p, np.clip(j, 0, L)]]
            live = (j <= L) & (b < band)
            Hl = cl.left(pH, edges["xl_H"])
            # the cell right of b, NEG past the band (a cover wider than
            # the band computes cells there)
            out = b + 1 >= band
            Hr = np.where(out, NEG, cl.right(pH, edges["xr_H"]))
            F1r = np.where(out, NEG, cl.right(pF1, edges["xr_F1"]))
            F2r = np.where(out, NEG, cl.right(pF2, edges["xr_F2"]))
            cd = Cands(cl.cover)
            if kmin < MP:
                cd.empty(kmin, s, g)
            if src:
                cd.slot(0, row0_at(j, g), NEG, NEG, row0_at(j - 1, g), s, g)
            for k, (x, d) in enumerate(zip(slots, steps)):
                if x < 0:
                    continue
                if reg[k]:
                    one = d == 1
                    cd.slot(k, Hr if one else pH, F1r if one else pF1,
                            F2r if one else pF2, pH if one else Hl, s, g)
                    continue
                assert dag
                gi = d + b
                ok = (gi >= 0) & (gi < stride)
                okd = (gi >= 1) & (gi - 1 < stride)
                gc, gd = np.clip(gi, 0, stride - 1), np.clip(gi - 1, 0,
                                                            stride - 1)
                Hk = np.where(ok, hist[0, x, gc], NEG)
                Hd = np.where(okd, hist[0, x, gd], NEG)
                # a live cell reads only written history cells
                assert (Hk[live & ok] != POISON).all()
                assert (Hd[live & okd] != POISON).all()
                cd.slot(k, Hk, np.where(ok, hist[1, x, gc], NEG),
                        np.where(ok, hist[2, x, gc], NEG), Hd, s, g)
            h0, F1o, F2o, code = cd.cell()
            Hrow, code = _affine_exchange(cl, h0, code, F1o, F2o, g, edges)
            bs = b[live]
            assert (bs < max_live).all()
            H[p, v, bs] = Hrow[live]
            dirs[p, v, bs] = code[live]
            if dag:
                hist[0, v, bs], hist[1, v, bs], hist[2, v, bs] = (
                    Hrow[live], F1o[live], F2o[live])
            bL = L - ov
            ends[p, v] = Hrow[bL] if 0 <= bL < band else NEG
            pH, pF1, pF2, off_prev = Hrow, F1o, F2o, ov
    return H, dirs, ends


_JAX_AFFINE = {}


def _jax_affine(inputs, band):
    """jax.vmap(poa_align_scan_affine) on the inputs, as
    tests/test_torch_wide.py runs it (one jit a band)."""
    if band not in _JAX_AFFINE:
        sm = jnp.asarray(SUB)
        _JAX_AFFINE[band] = jax.jit(jax.vmap(
            lambda bs, pr, of, qe, ll: jpoa.poa_align_scan_affine(
                bs, pr, of, qe, sm, band=band, l_len=ll, **GAPS)))
    return [np.asarray(x) for x in _JAX_AFFINE[band](
        *(jnp.asarray(a) for a in inputs[:5]))]


def _small_batch(seed, chain, shift=0, ties=False):
    """chip_smoke.poa_offset_batch scaled to band 64: 3 problems of up to
    32 nodes, queries of up to 150 bases, a chain's middle source jumping
    by 40 cells, DAG steps up to 12 and predecessors up to 24 nodes back;
    `shift` moves every offset (negative: live cells left of column 0);
    `ties` copies slot 0 into an empty slot on every other node (equal
    candidates, the first maximum picks the lower slot)."""
    inputs = chip_smoke.poa_offset_batch(seed, 3, 32, 150, 64, chain=chain,
                                         n_lo=6, jump=40, far=24, step=12)
    inputs[2][:] += shift
    if ties:
        preds = inputs[1]
        for p in range(preds.shape[0]):
            for v in range(1, int(inputs[5][p]), 2):
                free = np.flatnonzero(preds[p, v] < 0)
                if len(free) and preds[p, v, 0] >= 0:
                    preds[p, v, free[0]] = preds[p, v, 0]
    return inputs


GEOMS = [(2, 1, 8, 4), (2, 2, 4, 4), (4, 2, 4, 2), (8, 1, 4, 2),
         (16, 1, 2, 2), (8, 2, 2, 2), (3, 2, 4, 4)]


@pytest.mark.parametrize("dag", [False, True])
@pytest.mark.parametrize("geom", GEOMS)
def test_cluster_affine_model_equals_plain_and_jax(dag, geom):
    """Each geometry (16 CTAs of one 2-lane warp, ..., a cover of 96 past
    the band of 64) on chains and DAGs whose band offsets move across CTA
    slices of 8-32 cells."""
    inputs = _small_batch(sum(geom) + 10 * dag, chain=not dag)
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == (not dag)
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], 64)
    slice_ = Cluster(*geom).cover // geom[0]
    off = inputs[2].astype(np.int64)
    if dag:
        assert chip_smoke.poa_max_shift(inputs) > slice_
    else:
        assert np.diff(off[0, :int(inputs[5][0])]).max() > slice_
    got = cluster_affine_model(inputs, 64, max_live, geom, dag)
    _check_model(got, inputs, 64)
    jH, jd, je = _jax_affine(inputs, 64)
    live = _mask(inputs, 64)
    np.testing.assert_array_equal(got[0][live], jH[live])
    np.testing.assert_array_equal(got[1][live].astype(np.int16),
                                  jd[live].astype(np.int16))
    real = np.arange(32)[None, :] < inputs[5][:, None]
    np.testing.assert_array_equal(got[2][real], je[real])


@pytest.mark.parametrize("dag,shift,ties", [
    (False, -9, False), (True, -9, False), (True, 0, True),
    (True, 5, True)])
def test_cluster_affine_model_offsets_and_ties(dag, shift, ties):
    """Negative offsets (live cells left of column 0, where an empty
    slot's extend candidate wins) and duplicate predecessor slots (exact
    ties on every cell of a node, the lower slot kept), in 4 CTAs of two
    4-lane warps of 2 cells."""
    inputs = _small_batch(40 + shift, chain=not dag, shift=shift, ties=ties)
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], 64)
    got = cluster_affine_model(inputs, 64, max_live, (4, 2, 4, 2), dag)
    _check_model(got, inputs, 64)
    jH, jd, _je = _jax_affine(inputs, 64)
    live = _mask(inputs, 64)
    np.testing.assert_array_equal(got[0][live], jH[live])
    np.testing.assert_array_equal(got[1][live].astype(np.int16),
                                  jd[live].astype(np.int16))
    if ties:
        # a copied slot ties with slot 0 on every cell, so neither the
        # diagonal's nor F1's slot (bits 3-4, 5-6) is ever the copy
        seen = 0
        for p in range(3):
            for v in range(1, int(inputs[5][p]), 2):
                dup = [k for k in range(1, MP)
                       if inputs[1][p, v, k] == inputs[1][p, v, 0] >= 0]
                row = got[1][p, v][live[p, v]]
                for k in dup:
                    seen += len(row)
                    assert ((row >> 3) & 3 != k).all()
                    assert ((row >> 5) & 3 != k).all()
        assert seen > 0


def cluster_linear_model(bases, preds, q, n, L, geom, gap=30, match=10,
                         mismatch=-15):
    """poa_linear_cluster_kernel's schedule over the columns [0, L + 1):
    the previous node's row from the lanes' registers (its cell left of a
    warp's first rebuilt from the carry entering the warp), other rows
    from the H rows written so far; each warp's total, each CTA's pushed
    into the later CTAs, the carries, pass 2; stores on the live cells
    only, the rest POISON."""
    cl = Cluster(*geom)
    assert cl.cover >= L + 1
    N, Lq = len(bases), len(q)
    H = np.full((N, Lq + 1), POISON, np.int64)
    dirs = np.full((N, Lq + 1), POISON & 0xFF, np.int64)
    ends = np.full(N, POISON, np.int64)
    j = cl.b
    qc = np.where((j >= 1) & (j <= L), q[np.clip(j - 1, 0, Lq - 1)], 5)
    pH = np.full(cl.cover, NEG, np.int64)
    xl = np.full(cl.nwg, NEG, np.int64)

    def pack(val, k):
        out = val * 4 + 3 - k
        assert (np.abs(out) < 1 << 31).all()
        return out

    for v in range(n):
        src = not (preds[v] >= 0).any()
        prk = [int(x) if 0 <= x < v else -1 for x in preds[v]]
        empty = [k for k in range(MP) if prk[k] < 0 and not (src and k == 0)]
        s = np.where(qc == bases[v], match, mismatch)
        cd = np.full(cl.cover, INT_MIN, np.int64)
        cg = np.full(cl.cover, INT_MIN, np.int64)
        if empty:
            k = min(empty)
            cd = pack(np.where(j > 0, NEG + s, NEG), k)
            cg = pack(np.full_like(j, NEG - gap), k)
        if src:
            cd = np.maximum(cd, pack(np.where(j > 0, -gap * (j - 1) + s,
                                              NEG), 0))
            cg = np.maximum(cg, pack(-gap * j - gap, 0))
        Hl = cl.left(pH, xl)
        for k, x in enumerate(prk):
            if x < 0:
                continue
            if x == v - 1:
                hwl, hwc = Hl, pH
            else:
                okl = (j >= 1) & (j - 1 <= L)
                okc = j <= L
                hwl = np.where(okl, H[x, np.clip(j - 1, 0, Lq)], NEG)
                hwc = np.where(okc, H[x, np.clip(j, 0, Lq)], NEG)
                live = j <= L
                assert (hwl[live & okl] != POISON).all()
                assert (hwc[live & okc] != POISON).all()
            cd = np.maximum(cd, pack(np.where(j > 0, hwl + s, NEG), k))
            cg = np.maximum(cg, pack(hwc - gap, k))
        bd, bl = cd >> 2, cg >> 2
        h0 = np.maximum(bd, bl)
        code = np.where(bd >= bl, (3 - (cd & 3)) << 2,
                        1 | ((3 - (cg & 3)) << 2))
        agg, _x = cl.lane_max(h0 + gap * j)
        x, r = cl.warp_scan(agg)
        wtot = r[np.arange(cl.nwg) * cl.wl + cl.wl - 1]
        _ct, _cc, _cp, cw, _wp = cl.carries(wtot, INT_MIN)
        lane_warp = np.arange(cl.lanes) // cl.wl
        q0 = np.maximum(cw[lane_warp], x)[:, None]
        run = np.maximum(q0, np.maximum.accumulate(
            (h0 + gap * j).reshape(cl.lanes, cl.C), axis=1)).reshape(-1)
        y = run - gap * j
        code = np.where(y != h0, (code & ~3) | 2, code)
        # the cell left of each warp's first, for the next node, from the
        # carry entering the warp
        for w in range(cl.nwg):
            if cl.bw[w] > 0:
                xl[w] = cw[w] - gap * (cl.bw[w] - 1)
                assert xl[w] == y[cl.bw[w] - 1]
        pH = y
        live = j <= L
        H[v, j[live]] = y[live]
        dirs[v, j[live]] = code[live]
        if L == Lq:
            ends[v] = y[Lq]
    return H, dirs, ends


@pytest.mark.parametrize("geom", [(2, 1, 8, 4), (4, 2, 4, 2), (8, 1, 2, 4),
                                  (16, 1, 2, 2), (3, 1, 4, 6)])
@pytest.mark.parametrize("n,Lq,L,ties", [(40, 63, 63, False),
                                         (33, 64, 50, True),
                                         (12, 64, 63, False)])
def test_cluster_linear_model_equals_plain_and_jax(geom, n, Lq, L, ties):
    """A bubbled DAG with forward predecessors in a bin of 40 nodes and a
    query of 63 codes (the whole query: ends) or padded to 64 (l_len 50,
    63), every geometry covering the live row; `ties` copies slot 0 into
    an empty slot on every other node."""
    bases, preds, q = _linear_case(sum(geom) + n + L, 40, n, Lq, L)
    if ties:
        for v in range(1, n, 2):
            free = np.flatnonzero(preds[v] < 0)
            if len(free) and preds[v, 0] >= 0:
                preds[v, free[0]] = preds[v, 0]
    H, dirs, ends = cluster_linear_model(bases, preds, q, n, L, geom)
    Hp, dp, ep = (x.numpy() for x in tpoa.poa_align_scan(
        *(torch.from_numpy(a) for a in (bases, preds, q)), **LINEAR))
    jH, jd, je = (np.asarray(x) for x in jpoa.poa_align_scan(
        jnp.asarray(bases), jnp.asarray(preds), jnp.asarray(q), **LINEAR))
    live = poa_cuda.linear_live_mask(40, Lq, n, L).numpy()
    for ref_H, ref_d in ((Hp, dp), (jH, jd)):
        np.testing.assert_array_equal(H[live], ref_H[live])
        np.testing.assert_array_equal(dirs[live], ref_d[live])
    assert (H[~live] == POISON).all()
    if L == Lq:
        np.testing.assert_array_equal(ends[:n], ep[:n])
        np.testing.assert_array_equal(ends[:n], je[:n])


def _constants(src: str) -> dict:
    return {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                        src)}


def test_cluster_constants_are_the_ones_csrc_compiles():
    """ops/poa_cuda.py's cluster constants equal csrc/poa_cluster.cu's:
    up to 16 CTAs, 4 cells a lane in CTAs of up to 512 threads in
    registers, 512-thread CTAs past that; the register covers (32,768
    cells) lie past the widest team cover, so a wide launch of phase 8's
    width (20,001) keeps its cells in registers;
    one expression sizes each kernel's global scratch; the one-block wide
    kernels and their launchers are gone from csrc/poa.cu."""
    src = (CSRC / "poa_cluster.cu").read_text()
    k = _constants(src)
    assert int(k["kClusterMax"]) == poa_cuda.POA_CLUSTER_MAX_CTAS == 16
    assert int(k["kCells"]) == poa_cuda.POA_CLUSTER_CELLS == 4
    assert int(k["kRegThreads"]) == poa_cuda.POA_CLUSTER_REG_THREADS
    assert int(k["kScratchThreads"]) == poa_cuda.POA_CLUSTER_SCRATCH_THREADS
    cover = (poa_cuda.POA_CLUSTER_MAX_CTAS * poa_cuda.POA_CLUSTER_REG_THREADS
             * poa_cuda.POA_CLUSTER_CELLS)
    assert cover >= 2 * poa_cuda.POA_MAX_COVER > 20001
    assert k["kMaxWarps"] == "kScratchThreads / 32"
    assert k["kQWin"] == "kRegThreads * kCells + kNodeTile"
    # the kernels' scratch offsets and poa_cluster_shape's words
    assert src.count("(size_t)p * kAffinePlanes * pl") == 1
    assert "(linear ? kLinearPlanes : kAffinePlanes) * sh.ctas" in src
    # the shared parts come from poa.cuh, the launcher from cluster.cuh
    assert '#include "poa.cuh"' in src and '#include "cluster.cuh"' in src
    old = (CSRC / "poa.cu").read_text()
    for gone in ("poa_wide_kernel", "poa_linear_wide_kernel",
                 "poa_wide_launch", "poa_linear_wide_launch"):
        assert gone not in old
    assert "poa_cluster.cu" in (CSRC / "cluster.cuh").read_text()[:200]
