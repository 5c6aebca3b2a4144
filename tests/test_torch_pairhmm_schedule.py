"""A torch model of the 3-state pair-HMM kernels' schedule (csrc/pairhmm.cu)
against the plain versions and the JAX package's Pallas kernel (CPU).

The kernels rescale the band once per R = 8 rows, by the reciprocal of the
step's last row maximum, as the Pallas kernel does
(cactus_tpu/ops/pairhmm_pallas.py:15-20, :169-175).  Unlike it, they still
take every row's band maximum, and sum the logs of the per-row scales the
plain version uses (each row maximum over the one before it): a running
float32 sum of thousands of row log-scales rounds differently from a sum
of step log-scales by ~1e-2 at 4096 rows, far above the 5e-3 at which the
card's posteriors are held to the plain version's.  The rows of a step
stay unscaled until it ends; then each stored fM row is divided by its own
maximum and its lsF is that running sum, as in the plain version (the
backward pass scales its rows' posteriors alike), so that the posterior's
clip at exp(+-60) sees the plain version's exponent.  The in-row chains
run as on the card: lanes of C cells fold their cells, a
Kogge-Stone scan with the constant multipliers e^(C 2^l) combines the 32
lanes of a warp, and each warp adds the earlier warps' totals.

This model is held to the plain posterior_banded_batch of the port and to
cactus_tpu's posterior_banded_batch_pallas(..., interpret=True) (which
also rescales once per 8 rows), on seeded numpy inputs: the edges of the
rescale step (m_len 0, 1, R-1, R, R+1 and M), n < m, identical pieces
(emissions at their largest: upward drift between rescales) and unrelated
ones (downward drift), at bands 128 and 512.  Tolerances: POST_ATOL to the
plain version (at these ~100-row inputs the two differ by rounding,
~1e-4), PALLAS_ATOL to the Pallas kernel (tests/test_pairhmm_pallas.py's
bound against XLA).

Bands past 16384 take the cluster kernels, modelled below
(`cluster_forward`, `cluster_backward`; the section's comment sets out
the schedule) for (C, nw, ncta) = (8, 1, 1), (8, 2, 3) and (4, 1, 16): the
same rescale step's edges, n < m, rows whose live window is empty, a
window that moves on a column a row (delta 1), and a long gap (0.999 a
base, chip_smoke.WIDE_HMM_GAPS) at a band that spreads a query's window
over every CTA.  They are held to the plain versions (POST_ATOL,
LOGZ_RTOL, log(fM) + lsF) and to the JAX package's posterior_banded_batch,
the XLA scan it runs wide bands on, within PALLAS_ATOL (the Pallas kernel
in interpret mode takes ~40 s a call at these bands); a model that reads
0 across the warp and CTA edges, or drops the earlier CTAs' chain totals,
fails them.  The plain version's zeros outside the live windows, which
the cluster kernels rest on, are held at several bands and offsets.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cactus_tpu.ops import pairhmm as jp
from cactus_tpu.ops.pairhmm_pallas import posterior_banded_batch_pallas
from cactus_tpu_torch.ops import banded_cuda
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops.banded import pack_band_batch
from chip_smoke import LOGZ_RTOL, window_span_share

R = 8
TINY = 1e-30
CARRY = 1.0            # the maximum a step's carry is rescaled to
F32 = torch.float32
POST_ATOL = 1e-3
PALLAS_ATOL = 2e-3
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")


def _f(x):
    return torch.tensor(x, dtype=F32)


def lane_cells(band: int) -> int:
    """Cells a lane owns on the card in the narrow kernels
    (csrc/pairhmm.cu launch_shape, bands up to 16384)."""
    c = 4
    while c < 16 and 256 * c < band:
        c *= 2
    return c if 32 * 16 * c >= band else 32


def chain_carry(v, coef, e, C, reverse):
    """The chain w[b] = coef*v[b] + e*w[b-1] (reverse: w[b+1]) as the
    kernels scan it: the value carried into each lane's first cell (the
    last, reversed), for lanes of C cells in warps of 32."""
    L = v.numel() // C
    v = v.view(L, C)
    if reverse:
        v = v.flip(0).flip(1)
    fold = torch.zeros(L, dtype=F32)
    eC = _f(1.0)
    for c in range(C):
        fold = _f(e) * fold + _f(coef) * v[:, c]
        eC = eC * _f(e)
    W = -(-L // 32)
    inc = torch.cat([fold, torch.zeros(W * 32 - L, dtype=F32)]).view(W, 32)
    E = eC
    off = 1
    while off < 32:
        inc = torch.cat([inc[:, :off], inc[:, off:] + E * inc[:, :-off]], 1)
        E = E * E
        off *= 2
    excl = torch.cat([torch.zeros(W, 1, dtype=F32), inc[:, :-1]], 1)
    lane_mult = [_f(1.0)]
    for _ in range(31):
        lane_mult.append(lane_mult[-1] * eC)
    lane_mult = torch.stack(lane_mult)
    warp_carry, acc = [], _f(0.0)
    for w in range(W):
        warp_carry.append(acc)
        acc = E * acc + inc[w, 31]            # E is e^(32 C) here
    carry = excl + lane_mult[None, :] * torch.stack(warp_carry)[:, None]
    carry = carry.reshape(-1)[:L]
    return carry.flip(0) if reverse else carry


def step_bookkeeping(S, maxes):
    """The plain version's running log-scale through each row of a step
    (each row's scale is its maximum over the one before it; the step's
    carry has maximum CARRY)."""
    out, prev = [], _f(CARRY)
    for mk in maxes:
        s = torch.clamp_min(mk / prev, TINY) if prev > 0 else _f(TINY)
        S = S + torch.log(s)
        out.append(S)
        prev = mk
    return S, out


def model_forward(q, t_shift, m_len, n_len, lo, em, band, delta, epsilon,
                  drop=None):
    """(fM, lsF, logZ, the largest unscaled row maximum) by the kernel's
    schedule.  drop="S" leaves the running log-scale out of lsF, drop="max"
    stores each fM row without dividing it by its maximum (mutations)."""
    P, M = q.shape
    B, C = band, lane_cells(band)
    Bp = -(-B // (32 * C)) * 32 * C
    d, e = _f(delta), _f(epsilon)
    tMM, omE = _f(1.0 - 2.0 * delta), _f(1.0 - epsilon)
    b = torch.arange(Bp)
    zero = torch.zeros(1, dtype=F32)
    fM_out = torch.zeros(P, M, B, dtype=F32)
    lsF = torch.zeros(P, M, dtype=F32)
    logZ = torch.zeros(P, dtype=F32)
    ltiny = torch.log(_f(TINY))
    peak = _f(0.0)
    for p in range(P):
        m, n, lp = int(m_len[p]), int(n_len[p]), int(lo[p])
        j0 = lp + b
        fM = ((j0 == 0) & (b < B)).to(F32)
        fY = torch.where((j0 >= 1) & (j0 <= n) & (b < B),
                         d * torch.pow(e, torch.clamp_min(j0 - 1, 0).to(F32)),
                         _f(0.0))
        fX = torch.zeros(Bp, dtype=F32)
        fM, fY = fM * CARRY, fY * CARRY
        S, end_row, end = _f(0.0), max(m, 1), None
        for i0 in range(1, m + 1, R):
            rows = range(i0, min(i0 + R, m + 1))
            maxes = []
            for i in rows:
                tc = torch.full((Bp,), 5, dtype=torch.long)
                tc[:B] = t_shift[p, i - 1:i - 1 + B].long()
                emit = em[int(q[p, i - 1]), tc]
                j = i + lp + b
                okM = (j >= 1) & (j <= n) & (b < B)
                mM = torch.where(okM, emit * (tMM * fM + omE * (fX + fY)),
                                 _f(0.0))
                mX = torch.where((j >= 0) & (j <= n) & (b < B),
                                 d * torch.cat([fM[1:], zero])
                                 + e * torch.cat([fX[1:], zero]), _f(0.0))
                w = chain_carry(mM, float(d), float(e), C, False)
                mY = torch.empty(Bp, dtype=F32).view(-1, C)
                for c in range(C):
                    mY[:, c] = w
                    w = d * mM.view(-1, C)[:, c] + e * w
                mY = torch.where(okM, mY.reshape(-1), _f(0.0))
                fM, fX, fY = mM, mX, mY
                fM_out[p, i - 1] = fM[:B]           # unscaled until the step ends
                maxes.append(((mM + mX) + mY).max())
                if i == end_row:
                    be = n - m - lp
                    end = (fM[be], fX[be], fY[be])
            S, books = step_bookkeeping(S, maxes)
            peak = torch.maximum(peak, max(maxes))
            for k, i in enumerate(rows):
                S_i = books[k]
                lsF[p, i - 1] = _f(0.0) if drop == "S" else S_i
                if drop != "max":
                    fM_out[p, i - 1] *= 1.0 / torch.clamp_min(maxes[k], TINY)
                if i == end_row:
                    mc = torch.clamp_min(maxes[k], TINY)
                    tot = end[0] / mc + (end[1] / mc + end[2] / mc)
                    logZ[p] = torch.log(torch.clamp_min(tot, TINY)) + S_i
            inv = CARRY / torch.clamp_min(maxes[-1], TINY)
            fM, fX, fY = fM * inv, fX * inv, fY * inv
        for i in range(m + 1, M + 1):
            S = S + ltiny
            lsF[p, i - 1] = S
            if i == end_row:
                logZ[p] = ltiny + S
    return fM_out, lsF, logZ, peak


def model_backward(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band,
                   delta, epsilon):
    """The posterior by the kernel's schedule: the backward rows unscaled
    within a step, each row's posterior scaled once the step's maxima are
    known."""
    P, M = q.shape
    B, C = band, lane_cells(band)
    Bp = -(-B // (32 * C)) * 32 * C
    d, e = _f(delta), _f(epsilon)
    tMM, omE = _f(1.0 - 2.0 * delta), _f(1.0 - epsilon)
    b = torch.arange(Bp)
    zero = torch.zeros(1, dtype=F32)
    post = torch.zeros(P, M, B, dtype=F32)
    for p in range(P):
        m, n, lp = int(m_len[p]), int(n_len[p]), int(lo[p])
        if not 1 <= m <= M:
            continue
        lz = logZ[p]

        def combine(i, bm, ls):
            g = torch.exp(torch.clamp(lsF[p, i - 1] + ls - lz, -60.0, 60.0))
            post[p, i - 1] = torch.clamp((fM[p, i - 1] * bm[:B]) * g, 0, 1.5)

        jn = n - (m + lp + b)
        bM = torch.where((jn == 0) & (b < B), _f(1.0), torch.where(
            (jn > 0) & (b < B),
            d * torch.pow(e, torch.clamp_min(jn - 1, 0).to(F32)), _f(0.0)))
        bX = ((jn == 0) & (b < B)).to(F32)
        combine(m, bM, _f(0.0))
        bM, bX = bM * CARRY, bX * CARRY
        S = _f(0.0)
        for r0 in range(m - 1, 0, -R):
            rows = range(r0, max(r0 - R, 0), -1)
            maxes, kept = [], []
            for i in rows:                    # row i from the carry i + 1
                tc = torch.full((Bp,), 5, dtype=torch.long)
                tc[:B] = t_shift[p, i:i + B].long()
                emit = em[int(q[p, i]), tc]
                jp = i + lp + b
                mm = torch.where((jp + 1 <= n) & (b < B), emit * bM, _f(0.0))
                x = torch.where((jp >= 0) & (jp <= n),
                                torch.cat([zero, bX[:-1]]), _f(0.0))
                nX = omE * mm + e * x
                yn = chain_carry(mm, float(omE), float(e), C, True)
                y = torch.empty(Bp, dtype=F32).view(-1, C)
                ynext = torch.empty(Bp, dtype=F32).view(-1, C)
                for c in range(C - 1, -1, -1):
                    ynext[:, c] = yn
                    yn = omE * mm.view(-1, C)[:, c] + e * yn
                    y[:, c] = yn
                nM = (tMM * mm + d * x) + d * ynext.reshape(-1)
                ok = (jp >= 0) & (jp <= n) & (b < B)
                bM = torch.where(ok, nM, _f(0.0))
                bX = torch.where(ok, nX, _f(0.0))
                nY = torch.where(ok, y.reshape(-1), _f(0.0))
                maxes.append(((bM + bX) + nY).max())
                kept.append(bM)
            S, books = step_bookkeeping(S, maxes)
            for k, i in enumerate(rows):
                g = torch.exp(torch.clamp(lsF[p, i - 1] + books[k] - lz,
                                          -60.0, 60.0))
                inv = 1.0 / torch.clamp_min(maxes[k], TINY)
                post[p, i - 1] = torch.clamp(
                    ((fM[p, i - 1] * kept[k][:B]) * inv) * g, 0, 1.5)
            inv = CARRY / torch.clamp_min(maxes[-1], TINY)
            bM, bX = bM * inv, bX * inv
    return post


def _pairs(seed):
    """Query lengths at the rescale step's edges (0, 1, R-1, R, R+1 and
    the batch's padded M = 64), a target shorter than its query, an
    identical pair and an unrelated one."""
    rng = np.random.default_rng(seed)

    def mutated(q):
        t = q.copy()
        flip = rng.random(len(t)) < 0.1
        t[flip] = rng.integers(0, 4, int(flip.sum()))
        return t

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = [(codes(0), codes(5))]
    for m in (1, R - 1, R, R + 1, 64):
        q = codes(m)
        pairs.append((q, mutated(q)))
    q = codes(40)
    pairs.append((q, mutated(q)[5:33]))                    # n < m
    q = codes(60)
    pairs.append((q, q.copy()))                            # identical
    pairs.append((codes(50), codes(55)))                   # unrelated
    return pairs


def _run(band, drop=None):
    pairs = _pairs(band)
    packed = pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions())
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    *fwd, peak = model_forward(*args, em, **kw, drop=drop)
    post = model_backward(*fwd, *args, em, **kw)
    ref_fwd = tp.forward_banded(*args, em, **kw)
    ref = tp.backward_posterior(*ref_fwd, *args, em, **kw)
    return packed, args, em, kw, fwd, peak, post, ref_fwd, ref


@pytest.mark.parametrize("band", [128, 512])
def test_schedule_model_matches_plain_and_pallas(band):
    packed, args, em, kw, (fM, lsF, logZ), peak, post, ref_fwd, ref = \
        _run(band)
    assert int(packed["q"].shape[1]) == 64
    assert {0, 1, R - 1, R, R + 1, 64} <= set(packed["m_len"].tolist())
    for x in (fM, lsF, logZ, post):
        assert torch.isfinite(x).all()
    # identical pieces grow by ~14 a row between rescales, unrelated
    # ones shrink: fM * exp(lsF) still equals the plain version's
    live = ref_fwd[0] > 1e-30
    gap = ((torch.log(fM) + lsF[..., None])
           - (torch.log(ref_fwd[0]) + ref_fwd[1][..., None]))[live]
    assert float(gap.abs().max()) < 1e-3
    assert float(peak) > 1e6              # the identical pair's drift
    assert bool(((logZ - ref_fwd[2]).abs()
                 <= LOGZ_RTOL * ref_fwd[2].abs().clamp_min(1.0)).all())
    assert float((post - ref).abs().max()) <= POST_ATOL
    rows = torch.arange(1, post.shape[1] + 1)[None, :]
    assert bool((post[rows > args[2][:, None]] == 0).all())
    jargs = [jnp.asarray(packed[k]) for k in KEYS] + [jnp.asarray(em.numpy())]
    pallas = np.asarray(posterior_banded_batch_pallas(
        *jargs, band=band, delta=kw["delta"], epsilon=kw["epsilon"],
        interpret=True))
    assert np.abs(post.numpy() - pallas).max() <= PALLAS_ATOL


def test_schedule_model_keeps_the_plain_clip_on_diffuse_posteriors():
    """Unrelated pieces of 480 and 467 bases at band 512: the forward and
    backward masses of a row lie apart, so the plain version's exponent
    lsF + lsB - logZ passes 60 and its clip binds.  The kernels' stored rows
    and log-scales are the plain version's, so the clip binds alike (with
    unscaled rows and their log maximum moved into lsF, the posterior was
    0.89 away here)."""
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 4, 480).astype(np.uint8),
              rng.integers(0, 4, 467).astype(np.uint8))]
    packed = pack_band_batch(pairs, 512, min_batch=1)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions())
    kw = dict(band=512, delta=p.delta, epsilon=p.epsilon)
    *fwd, _peak = model_forward(*args, em, **kw)
    post = model_backward(*fwd, *args, em, **kw)
    ref = tp.backward_posterior(*tp.forward_banded(*args, em, **kw), *args,
                                em, **kw)
    assert torch.isfinite(post).all()
    assert float((post - ref).abs().max()) <= POST_ATOL


@pytest.mark.parametrize("drop", ["S", "max"])
def test_schedule_model_needs_both_log_scale_terms(drop):
    """lsF without the running log-scale, or fM rows left unscaled, move
    the posterior far from the plain version's."""
    *_, post, _ref_fwd, ref = _run(128, drop=drop)
    assert float((post - ref).abs().max()) > 100 * POST_ATOL


# ---------------------------------------------------- the cluster kernels
# Bands past 16384 take csrc/pairhmm.cu's cluster kernels: one thread-block
# cluster a pair, ncta CTAs of nw warps of lanes of C window cells, on each
# row's live window j = jlo(i) .. jhi(i) only (cell k = j - jlo(i)).  The
# model below follows them step by step: each row's M and X from the row
# before at k - 1 + delta and k + delta (delta = jlo(i) - jlo(i - 1)), the
# cells across a warp or CTA edge from the edge values the kernels
# exchange (never from the row itself), the Y chain's totals carried
# across warps and CTAs by powers of e, the step's row maxima known only
# at the next step's first row (or the last exchange), the rows written
# when their step ends and the first row of each later step rescaled after
# it is computed.

def cluster_consts(epsilon, C, nw):
    """The kernels' chain constants, by repeated float32 products: e^c,
    e^(C 2^l), e^(C lane), e^(32 C) (a warp), e^(32 C nw) (a CTA) and
    e^(32 C - 1), e^(32 C nw - 1) (a warp's and a CTA's cells less one)."""
    e = _f(epsilon)
    epow = [_f(1.0)]
    for _ in range(1, C):
        epow.append(epow[-1] * e)
    eC = epow[-1] * e
    lev = [eC]
    for _ in range(1, 6):
        lev.append(lev[-1] * lev[-1])
    lane_mult = [_f(1.0)]
    for _ in range(31):
        lane_mult.append(lane_mult[-1] * eC)
    e32m1 = lane_mult[31] * epow[C - 1]
    ecta, ectam1 = _f(1.0), e32m1
    for w in range(nw):
        ecta = ecta * lev[5]
        if w:
            ectam1 = ectam1 * lev[5]
    return dict(epow=torch.stack(epow), lev=lev,
                lane_mult=torch.stack(lane_mult), E32=lev[5], e32m1=e32m1,
                Ecta=ecta, ectam1=ectam1)


def window(i, n, lo, B):
    """(jlo, width) of row i's live columns (width 0: none)."""
    jlo = max(0, i + lo)
    return jlo, max(0, min(n, i + lo + B - 1) - jlo + 1)


def _shift(x, s):
    """x[k + s] over the cover, 0 outside it."""
    out = torch.zeros_like(x)
    if s >= 0:
        out[:x.numel() - s] = x[s:]
    else:
        out[-s:] = x[:s]
    return out


def _tree(v):
    """Sum over the last axis as the kernels' lanes fold their cells."""
    v = list(v.unbind(-1))
    st = 1
    while st < len(v):
        for c in range(0, len(v) - st, 2 * st):
            v[c] = v[c] + v[c + st]
        st *= 2
    return v[0]


def _scan(v, lev, reverse):
    """Inclusive Kogge-Stone scan over the 32 lanes of each warp (rows of
    v): lane l adds e^(C 2^s) times lane l - 2^s (reverse: l + 2^s)."""
    for s in range(5):
        off = 1 << s
        if reverse:
            v = torch.cat([v[:, :-off] + lev[s] * v[:, off:], v[:, -off:]], 1)
        else:
            v = torch.cat([v[:, :off], v[:, off:] + lev[s] * v[:, :-off]], 1)
    return v


def _carries(tot, K, reverse):
    """The chain value entering each CTA and each warp from the CTAs and
    warps before it (reverse: after it), Horner's rule in e^(32 C nw) and
    e^(32 C) over the published totals, and each one's value entering
    its neighbour before (after) it: (cw (ncta, nw), c_nb (ncta, nw))."""
    ncta, nw = tot.shape
    T, Tb = torch.zeros(ncta), torch.zeros(ncta)
    order = range(nw - 1, -1, -1) if reverse else range(nw)
    for w in order:
        if w == (0 if reverse else nw - 1):
            Tb = T.clone()
        T = K["E32"] * T + tot[:, w]
    cta, cta_nb = torch.zeros(ncta), torch.zeros(ncta)
    for r in range(ncta):
        c, cn = _f(0.0), _f(0.0)
        for s in (range(ncta - 1, r, -1) if reverse else range(r)):
            if s == (r + 1 if reverse else r - 1):
                cn = c
            c = K["Ecta"] * c + T[s]
        cta[r], cta_nb[r] = c, cn
    cw, c_nb = torch.zeros(ncta, nw), torch.zeros(ncta, nw)
    for r in range(ncta):
        for w in range(nw):
            c, cn = cta[r], _f(0.0)
            for v in (range(nw - 1, w, -1) if reverse else range(w)):
                if v == (w + 1 if reverse else w - 1):
                    cn = c
                c = K["E32"] * c + tot[r, v]
            cw[r, w], c_nb[r, w] = c, cn
    return cw, c_nb, Tb, cta_nb


def _lanes(C, nw, ncta):
    lanes = ncta * nw * 32
    L = torch.arange(lanes)
    lane, warp, rank = L % 32, (L // 32) % nw, L // (32 * nw)
    return (lanes, L * C, (lane == 0) & (L > 0),
            (lane == 31) & (L + 1 < lanes), warp, rank)


def cluster_forward(q, t_shift, m_len, n_len, lo, em, band, delta, epsilon,
                    C, nw, ncta, drop=None):
    """(fM, lsF, logZ) by the cluster kernels' schedule.  drop="edge"
    reads 0 for the cells across a warp or CTA edge, drop="carry" leaves
    the chain totals of the CTAs before out (mutations)."""
    P, M = q.shape
    B = band
    lanes, k0, first, last, warp, rank = _lanes(C, nw, ncta)
    cover = lanes * C
    K = cluster_consts(epsilon, C, nw)
    d, e = _f(delta), _f(epsilon)
    tMM, omE = _f(1.0 - 2.0 * delta), _f(1.0 - epsilon)
    wgt = torch.stack([d * K["epow"][C - 1 - c] for c in range(C)])
    k = torch.arange(cover)
    fM_out = torch.zeros(P, M, B, dtype=F32)
    lsF = torch.zeros(P, M, dtype=F32)
    logZ = torch.zeros(P, dtype=F32)
    ltiny = torch.log(_f(TINY))
    for p in range(P):
        m, n, lp = min(int(m_len[p]), M), int(n_len[p]), int(lo[p])
        assert min(B, n + 1) <= cover
        end_row = max(m, 1)
        jlo, wd = window(0, n, lp, B)
        j = jlo + k
        ring = torch.zeros(R, cover, dtype=F32)     # a step's M rows
        ring[0] = ((k < wd) & (j == 0)).to(F32)
        sX = torch.zeros(cover, dtype=F32)
        sY = torch.where((k < wd) & (j >= 1),
                         d * torch.pow(e, (j - 1).clamp_min(0).to(F32)),
                         _f(0.0))
        # the cells across each lane's warp edge, as the closed form gives
        # them for row 0
        nbL = torch.stack([x[(k0 - 1).clamp_min(0)] for x in
                           (ring[0], sX, sY)], 1)
        nbR = torch.stack([_shift(x, C)[k0] for x in (ring[0], sX)], 1)
        S, pending, maxes, end = _f(0.0), None, [], None

        def write_step(S, first_row, mx):
            prev = _f(CARRY)
            for r, mk in enumerate(mx):
                row = first_row + r
                s = torch.clamp_min(mk / prev, TINY) if prev > 0 else \
                    _f(TINY)
                S = S + torch.log(s)
                lsF[p, row - 1] = S
                jl, w = window(row, n, lp, B)
                bb = jl - row - lp
                fM_out[p, row - 1, bb:bb + w] = \
                    ring[row % R][:w] * (1.0 / torch.clamp_min(mk, TINY))
                if row == end_row:
                    mc = torch.clamp_min(mk, TINY)
                    tot = end[0] / mc + (end[1] / mc + end[2] / mc) \
                        if end is not None else _f(0.0)
                    logZ[p] = torch.log(torch.clamp_min(tot, TINY)) + S
                prev = mk
            return S

        for i in range(1, m + 1):
            jlo_p = jlo
            jlo, wd = window(i, n, lp, B)
            dl = jlo - jlo_p
            bb = jlo - i - lp
            r = (i - 1) % R
            pM = ring[(i - 1) % R]
            fm, fx, fy = (_shift(x, dl - 1) for x in (pM, sX, sY))
            fmu, fxu = _shift(pM, dl), _shift(sX, dl)
            edge = 0.0 if drop == "edge" else 1.0
            if dl == 0:
                at = k0[first]
                fm[at], fx[at], fy[at] = (nbL[first] * edge).unbind(1)
            else:
                at = k0[last] + C - 1
                fmu[at], fxu[at] = (nbR[last] * edge).unbind(1)
            okx = k < wd
            ok = okx & (jlo + k >= 1)
            tc = torch.full((cover,), 5, dtype=torch.long)
            tc[:wd] = t_shift[p, i - 1 + bb:i - 1 + bb + wd].long()
            emit = em[int(q[p, i - 1]), tc]
            Mv = torch.where(ok, emit * (tMM * fm + omE * (fx + fy)), _f(0.0))
            Xv = torch.where(okx, d * fmu + e * fxu, _f(0.0))
            Ml = Mv.view(lanes, C)
            inc = _scan(_tree(wgt * Ml).view(-1, 32), K["lev"], False)
            excl = torch.cat([torch.zeros(inc.shape[0], 1), inc[:, :-1]], 1)
            y0 = torch.zeros(lanes, C, dtype=F32)
            for c in range(1, C):
                y0[:, c] = d * Ml[:, c - 1] + e * y0[:, c - 1]
            tot = inc[:, 31].view(ncta, nw)
            near = (y0.view(-1, 32, C)[:, 31, C - 1]
                    + K["epow"][C - 1] * excl[:, 31]).view(ncta, nw)
            if drop == "carry":
                tot = tot * (torch.arange(ncta) == 0)[:, None]
            cw, c_nb, Tb, cta_nb = _carries(tot, K, False)
            nearC = near[:, nw - 1] + K["e32m1"] * Tb
            wl = excl + K["lane_mult"][None, :] * cw.reshape(-1)[:, None]
            Y = torch.where(ok, (y0 + K["epow"][None, :]
                                 * wl.reshape(-1)[:, None]).reshape(-1),
                            _f(0.0))
            g = _f(1.0)
            if r == 0 and i > 1:
                S = write_step(S, *pending)
                g = 1.0 / torch.clamp_min(pending[1][-1], TINY)
            vM, vX, vY = Mv * g, Xv * g, Y * g
            ring[i % R], sX, sY = vM, vX, vY
            maxes.append(((vM + vX) + vY).max())
            if i == end_row and 0 <= n - jlo < wd:
                end = (vM[n - jlo], vX[n - jlo], vY[n - jlo])
            # the next row's edge cells: the pass-1 M and X of the cells
            # across the edge, and the previous warp's (CTA's) last Y from
            # its zero-carry value and the carry entering it
            kr = (k0[last] + C).clamp_max(cover - 1)
            nbR[last] = torch.stack([Mv[kr], Xv[kr]], 1) * g
            kl = k0[first] - 1
            w_, r_ = warp[first], rank[first]
            yl = torch.where(
                w_ > 0, near[r_, (w_ - 1).clamp_min(0)]
                + K["e32m1"] * c_nb[r_, w_],
                nearC[(r_ - 1).clamp_min(0)] + K["ectam1"] * cta_nb[r_])
            nbL[first] = torch.stack(
                [Mv[kl], Xv[kl], torch.where(ok[kl], yl, _f(0.0))], 1) * g
            if r == R - 1 or i == m:
                pending, maxes = (i - r, maxes), []
        if m >= 1:
            S = write_step(S, *pending)
        for i in range(m + 1, M + 1):
            S = S + ltiny
            lsF[p, i - 1] = S
            if i == end_row:
                logZ[p] = ltiny + S
        if M < end_row:
            logZ[p] = ltiny + S
    return fM_out, lsF, logZ


def cluster_backward(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band,
                     delta, epsilon, C, nw, ncta, drop=None):
    """The posterior by the cluster kernels' schedule (drop as
    cluster_forward's)."""
    P, M = q.shape
    B = band
    lanes, k0, first, last, warp, rank = _lanes(C, nw, ncta)
    cover = lanes * C
    K = cluster_consts(epsilon, C, nw)
    d, e = _f(delta), _f(epsilon)
    tMM, omE = _f(1.0 - 2.0 * delta), _f(1.0 - epsilon)
    wgt = omE * K["epow"]
    rev = K["lane_mult"].flip(0)                 # e^(C (31 - lane))
    k = torch.arange(cover)
    post = torch.zeros(P, M, B, dtype=F32)
    for p in range(P):
        m, n, lp = int(m_len[p]), int(n_len[p]), int(lo[p])
        if not 1 <= m <= M:
            continue
        assert min(B, n + 1) <= cover
        lz = logZ[p]
        jlo, wd = window(m, n, lp, B)
        jn = n - (jlo + k)
        ring = torch.zeros(R, cover, dtype=F32)     # a step's bM rows
        ring[m % R] = torch.where(
            k < wd, torch.where(jn == 0, _f(1.0), d * torch.pow(
                e, (jn - 1).clamp_min(0).to(F32))), _f(0.0))
        sX = ((k < wd) & (jn == 0)).to(F32)
        bb = jlo - m - lp
        g = torch.exp(torch.clamp(lsF[p, m - 1] - lz, -60.0, 60.0))
        post[p, m - 1, bb:bb + wd] = torch.clamp(
            (fM[p, m - 1, bb:bb + wd] * ring[m % R][:wd]) * g, 0, 1.5)
        nbR = _shift(ring[m % R], C)[k0]
        nbL = sX[(k0 - 1).clamp_min(0)]
        S, pending, maxes = _f(0.0), None, []

        def write_step(S, r0, mx):
            prev = _f(CARRY)
            for r, mk in enumerate(mx):
                row = r0 - r
                s = torch.clamp_min(mk / prev, TINY) if prev > 0 else \
                    _f(TINY)
                S = S + torch.log(s)
                g = torch.exp(torch.clamp((lsF[p, row - 1] + S) - lz,
                                          -60.0, 60.0))
                jl, w = window(row, n, lp, B)
                bb = jl - row - lp
                post[p, row - 1, bb:bb + w] = torch.clamp(
                    ((fM[p, row - 1, bb:bb + w] * ring[row % R][:w])
                     * (1.0 / torch.clamp_min(mk, TINY))) * g, 0, 1.5)
                prev = mk
            return S

        for i in range(m - 1, 0, -1):         # row i from the carry i + 1
            jlo_c = jlo
            jlo, wd = window(i, n, lp, B)
            dl = jlo_c - jlo
            bb = jlo - i - lp
            r = (m - 1 - i) % R
            bmv = _shift(ring[(i + 1) % R], 1 - dl)
            xv = _shift(sX, -dl)
            edge = 0.0 if drop == "edge" else 1.0
            if dl == 0:
                bmv[k0[last] + C - 1] = nbR[last] * edge
            else:
                xv[k0[first]] = nbL[first] * edge
            okp = k < wd
            okm = okp & (jlo + k + 1 <= n)
            tc = torch.full((cover,), 5, dtype=torch.long)
            tc[:wd] = t_shift[p, i + bb:i + bb + wd].long()
            emit = em[int(q[p, i]), tc]
            mm = torch.where(okm, emit * bmv, _f(0.0))
            xs = torch.where(okp, xv, _f(0.0))
            ml = mm.view(lanes, C)
            inc = _scan(_tree(wgt * ml).view(-1, 32), K["lev"], True)
            excl = torch.cat([inc[:, 1:], torch.zeros(inc.shape[0], 1)], 1)
            y0 = torch.zeros(lanes, C, dtype=F32)
            for c in range(C - 2, -1, -1):
                y0[:, c] = omE * ml[:, c + 1] + e * y0[:, c + 1]
            tot = inc[:, 0].view(ncta, nw)
            rest = (y0.view(-1, 32, C)[:, 0, 0]
                    + K["epow"][C - 1] * excl[:, 0]).view(ncta, nw)
            if drop == "carry":
                tot = tot * (torch.arange(ncta) == ncta - 1)[:, None]
            cw, c_nb, Tb, cta_nb = _carries(tot, K, True)
            restC = rest[:, 0] + K["e32m1"] * Tb
            yn = excl + rev[None, :] * cw.reshape(-1)[:, None]
            ync = (y0 + K["epow"].flip(0)[None, :]
                   * yn.reshape(-1)[:, None]).reshape(-1)
            y = omE * mm + e * ync
            bM = torch.where(okp, (tMM * mm + d * xs) + d * ync, _f(0.0))
            bX = torch.where(okp, omE * mm + e * xs, _f(0.0))
            yv = torch.where(okp, y, _f(0.0))
            g = _f(1.0)
            if r == 0 and i != m - 1:
                S = write_step(S, *pending)
                g = 1.0 / torch.clamp_min(pending[1][-1], TINY)
            bM, bX, yv = bM * g, bX * g, yv * g
            ring[i % R], sX = bM, bX
            maxes.append(((bM + bX) + yv).max())
            # the next row's edge cells: the next warp's (CTA's) first bM
            # from its pass-1 values and the chain at its second cell, the
            # previous one's last bX
            kr = (k0[last] + C).clamp_max(cover - 1)
            w_, r_ = warp[last], rank[last]
            y2 = torch.where(
                w_ + 1 < nw, rest[r_, (w_ + 1).clamp_max(nw - 1)]
                + K["e32m1"] * c_nb[r_, w_],
                restC[(r_ + 1).clamp_max(ncta - 1)] + K["ectam1"]
                * cta_nb[r_])
            nbR[last] = torch.where(k0[last] + C < wd,
                                    (tMM * mm[kr] + d * xs[kr]) + d * y2,
                                    _f(0.0)) * g
            nbL[first] = torch.where(okp[k0[first] - 1],
                                     omE * mm[k0[first] - 1]
                                     + e * xs[k0[first] - 1], _f(0.0)) * g
            if r == R - 1 or i == 1:
                pending, maxes = (i + r, maxes), []
        if m >= 2:
            S = write_step(S, *pending)
    return post


# (C, nw, ncta) of the cluster cases, and the band each spreads its
# long pair's window over every CTA at: (8, 1, 1) one warp, (8, 2, 3)
# three CTAs of two warps (CTA edges and warp edges), (4, 1, 16) sixteen
# CTAs of one warp, as many as a cluster takes
CLUSTER_SHAPES = {(8, 1, 1): 256, (8, 2, 3): 1536, (4, 1, 16): 2048}
# the long gaps of the wide-route checks (chip_smoke.WIDE_HMM_GAPS): at the
# default 0.79 a gap of hundreds of bases sits below float32's range
LONG_GAP = 0.999


def _pack(pairs, band, lo_override=None):
    """pack_band_batch, with lo and t_shift of pair k set to
    lo_override[k] (the plain version takes any lo)."""
    packed = pack_band_batch(pairs, band, min_batch=1)
    for p, lo_p in (lo_override or {}).items():
        t = pairs[p][1]
        packed["lo"][p] = lo_p
        row = np.full(packed["t_shift"].shape[1], 5, np.uint8)
        y = np.arange(row.size)
        ok = (y + lo_p >= 0) & (y + lo_p < len(t))
        row[ok] = t[(y + lo_p)[ok]]
        packed["t_shift"][p] = row
    return packed


def _cluster_pairs(band, seed):
    """Query lengths at the rescale step's edges (0, 1, R-1, R, R+1 and the
    padded M = 64), a target shorter than its query (n < m), the same
    with lo at its lowest (its first rows' windows are empty), a query
    copied into a target of band - 36 bases (the long gap: its window
    spreads over every CTA), and a query at the start of such a target
    with lo = -3 (from row 4 on each row's window starts one column
    later: the other edge reads).  Returns (packed, pairs)."""
    rng = np.random.default_rng(seed)

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    def mutated(q):
        t = q.copy()
        flip = rng.random(len(t)) < 0.1
        t[flip] = rng.integers(0, 4, int(flip.sum()))
        return t

    pairs = [(codes(0), codes(5))]
    for m in (1, R - 1, R, R + 1, 64):
        q = codes(m)
        pairs.append((q, mutated(q)))
    q = codes(40)
    pairs.append((q, mutated(q)[5:33]))                       # n < m
    q = codes(40)
    pairs.append((q, mutated(q)[:12]))                        # empty rows
    q = codes(24)
    n = band - 36
    at = n // 3
    pairs.append((q, np.concatenate([codes(at), mutated(q),
                                     codes(n)])[:n]))         # long gap
    q = codes(60)
    pairs.append((q, np.concatenate([mutated(q), codes(n)])[:n]))
    m, n = len(pairs[-3][0]), len(pairs[-3][1])
    # the empty rows: lo at its lowest; the last pair's band starts at
    # j = i - 3, so its window moves on (delta 1) from row 4
    packed = _pack(pairs, band, {len(pairs) - 3: n - m - band + 1,
                                 len(pairs) - 1: -3})
    return packed, pairs


def _run_cluster(shape, epsilon, drop=None):
    C, nw, ncta = shape
    band = CLUSTER_SHAPES[shape]
    packed, pairs = _cluster_pairs(band, band + C + nw)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    p = tp.HmmParams(epsilon=epsilon)
    em = torch.from_numpy(p.emissions())
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fwd = cluster_forward(*args, em, **kw, C=C, nw=nw, ncta=ncta, drop=drop)
    post = cluster_backward(*fwd, *args, em, **kw, C=C, nw=nw, ncta=ncta,
                            drop=drop)
    ref_fwd = tp.forward_banded(*args, em, **kw)
    ref = tp.backward_posterior(*ref_fwd, *args, em, **kw)
    return packed, pairs, args, p, kw, fwd, post, ref_fwd, ref


@pytest.fixture
def one_torch_thread():
    """The models run wide rows of many small ops: beside the other test
    workers torch's intra-op threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("epsilon", [0.79, LONG_GAP], ids=["default",
                                                           "long_gap"])
@pytest.mark.parametrize("shape", list(CLUSTER_SHAPES),
                         ids=lambda s: "C%d-nw%d-cta%d" % s)
def test_cluster_model_matches_plain_and_jax(shape, epsilon,
                                             one_torch_thread):
    """The cluster kernels' schedule against the plain versions (fM and
    lsF in log space, logZ within LOGZ_RTOL, the posterior within
    POST_ATOL, zeros outside the live windows) and the JAX package's
    posterior_banded_batch (the XLA scan its wide bands take) within
    PALLAS_ATOL, the bound of an 8-row rescale against that scan."""
    packed, pairs, args, p, kw, (fM, lsF, logZ), post, ref_fwd, ref = \
        _run_cluster(shape, epsilon)
    assert int(packed["q"].shape[1]) == 64
    assert {0, 1, R - 1, R, R + 1, 64} <= set(packed["m_len"].tolist())
    M, band = args[0].shape[1], kw["band"]
    live = banded_cuda.live_mask(*args[2:], M, band)
    empty = [i for i in range(1, 41) if window(i, int(args[3][-3]),
                                              int(args[4][-3]), band)[1] == 0]
    assert len(empty) >= 10               # the pair with empty rows
    for x in (fM, lsF, logZ, post):
        assert torch.isfinite(x).all()
    assert not bool(fM[~live].any()) and not bool(post[~live].any())
    on = ref_fwd[0] > 1e-30
    gap = ((torch.log(fM) + lsF[..., None])
           - (torch.log(ref_fwd[0]) + ref_fwd[1][..., None]))[on]
    assert float(gap.abs().max()) < 1e-3
    assert bool(((logZ - ref_fwd[2]).abs()
                 <= LOGZ_RTOL * ref_fwd[2].abs().clamp_min(1.0)).all())
    assert float((post - ref).abs().max()) <= POST_ATOL
    jref = np.asarray(jp.posterior_banded_batch(
        *[jnp.asarray(packed[k]) for k in KEYS], jnp.asarray(p.emissions()),
        **kw))
    assert np.abs(post.numpy() - jref).max() <= PALLAS_ATOL
    long_ = len(pairs) - 2
    if epsilon == LONG_GAP:
        # the check sees the long pair: its posterior reaches 1 and its
        # forward values pass 1e-30 across the window (every CTA)
        assert float(ref[long_].max()) > 0.5
        assert window_span_share(ref_fwd[0][long_], live[long_]) >= 0.9


@pytest.mark.parametrize("drop", ["edge", "carry"])
def test_cluster_model_needs_its_edges_and_carries(drop, one_torch_thread):
    """Cells across a warp or CTA edge read as 0, or the chain totals of
    the CTAs before (after) a CTA left out: on the long pair (delta 0, edge
    reads to the left) and on the shifted one (delta 1, to the right) the
    posterior or the forward values move a hundred times past the
    tolerances the checks above hold, so they see every edge."""
    packed, pairs, *_, (fM, lsF, _z), post, ref_fwd, ref = _run_cluster(
        (8, 2, 3), LONG_GAP, drop=drop)
    for k in (len(pairs) - 2, len(pairs) - 1):
        on = ref_fwd[0][k] > 1e-30
        d_fwd = ((torch.log(fM[k]) + lsF[k][:, None])
                 - (torch.log(ref_fwd[0][k]) + ref_fwd[1][k][:, None]))[on]
        d_post = float((post[k] - ref[k]).abs().max())
        assert d_post > 100 * POST_ATOL or \
            float(d_fwd.abs().max()) > 100 * 1e-3, k


@pytest.mark.parametrize("band,shift", [(16, 0), (64, 0), (64, -5),
                                        (128, 3), (256, 0)])
def test_plain_is_zero_outside_the_live_window(band, shift):
    """The plain forward_banded and backward_posterior give exactly 0 in
    fM and the posterior outside each row's live window j = jlo(i) ..
    jhi(i) and past m, at several bands and offsets lo: the cluster
    kernels compute only those windows."""
    rng = np.random.default_rng(band + 7)
    pairs = []
    while len(pairs) < 6:
        m = int(rng.integers(1, 3 * band // 2))
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = q.copy()
        flip = rng.random(m) < 0.1
        t[flip] = rng.integers(0, 4, int(flip.sum()))
        t = t[:max(0, m - int(rng.integers(0, band // 2)))]
        if abs(len(t) - m) < band:
            pairs.append((q, t))
    pairs += [(rng.integers(0, 4, 3).astype(np.uint8),
               np.zeros(0, np.uint8))]
    over = {}
    if shift:
        base = pack_band_batch(pairs, band, min_batch=1)["lo"]
        for k, (q, t) in enumerate(pairs):
            # any lo that keeps the end cell in the band
            over[k] = int(np.clip(base[k] + shift, len(t) - len(q) - band
                                  + 1, min(0, len(t) - len(q))))
    packed = _pack(pairs, band, over)
    args = [torch.from_numpy(packed[k]) for k in KEYS]
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions())
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fM, lsF, logZ = tp.forward_banded(*args, em, **kw)
    post = tp.backward_posterior(fM, lsF, logZ, *args, em, **kw)
    live = banded_cuda.live_mask(*args[2:], fM.shape[1], band)
    assert not bool(fM[~live].any()) and not bool(post[~live].any())
    assert int((fM[live] > 0).sum()) > 0
