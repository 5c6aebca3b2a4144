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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cactus_tpu.ops.pairhmm_pallas import posterior_banded_batch_pallas
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops.banded import pack_band_batch
from chip_smoke import LOGZ_RTOL

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
    """Cells a lane owns on the card (csrc/pairhmm.cu launch_shape; past
    band 16384 the wide kernels' kWideC = 8, whose tiles of 16 warps pass
    the chain's value on from tile to tile, so their warps' carries are
    the one sequence chain_carry forms over all warps)."""
    if band > 16384:
        return 8
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


def test_schedule_model_wide_route_matches_plain():
    """The wide kernels' schedule (band 16448, past the narrow kernels'
    16384: five tiles of 4096 cells, the last partly filled, 8 cells a
    lane, the same 8-row rescale) against the plain version on the
    rescale step's edges.  On one torch thread: its many small ops on
    wide rows only contend for the cores beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        packed, args, em, kw, (fM, lsF, logZ), peak, post, ref_fwd, ref = \
            _run(16448)
    finally:
        torch.set_num_threads(threads)
    for x in (fM, lsF, logZ, post):
        assert torch.isfinite(x).all()
    live = ref_fwd[0] > 1e-30
    gap = ((torch.log(fM) + lsF[..., None])
           - (torch.log(ref_fwd[0]) + ref_fwd[1][..., None]))[live]
    assert float(gap.abs().max()) < 1e-3
    assert bool(((logZ - ref_fwd[2]).abs()
                 <= LOGZ_RTOL * ref_fwd[2].abs().clamp_min(1.0)).all())
    assert float((post - ref).abs().max()) <= POST_ATOL


@pytest.mark.parametrize("drop", ["S", "max"])
def test_schedule_model_needs_both_log_scale_terms(drop):
    """lsF without the running log-scale, or fM rows left unscaled, move
    the posterior far from the plain version's."""
    *_, post, _ref_fwd, ref = _run(128, drop=drop)
    assert float((post - ref).abs().max()) > 100 * POST_ATOL
