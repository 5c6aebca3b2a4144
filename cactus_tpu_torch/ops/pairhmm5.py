"""Batched banded FIVE-STATE pair-HMM posteriors (cPecan stateMachine5).

The reference BAR pecan path runs `stateMachine5_construct(fiveState)`
(bar/impl/bar.c:65): a pair-HMM with a match state plus SHORT and LONG
gap states on each side (SX/LX consume query, SY/LY consume target).
Short gaps model small indels (fast open, fast return); long gaps model
structural indels (rare open, near-unit extension), and short<->long
switch transitions let a gap change regime mid-run.

Same banded scaled-LINEAR-space layout as ops/pairhmm.py (per-row max
renormalisation instead of log-sum-exp).  The in-row target-consuming
chain is a COUPLED 2-vector linear recurrence

    [SY, LY][b] = A @ [SY, LY][b-1] + c[b],
    A = [[e_s, w_ls], [w_sl, e_l]]

(A transposed and reversed in the backward pass).

The contract (cactus_tpu/ops/pairhmm5.py::posterior_banded_batch5) is
split in two here, each with a plain PyTorch version that mirrors the
contract op for op (the matrix Kogge-Stone order of the in-row chains
included): `forward_banded5` and `backward_posterior5`.  Their
hand-written CUDA kernels are ops/pairhmm5_cuda.py::pairhmm5_fwd and
::pairhmm5_bwd, which `posterior_pairs_banded5` launches for every batch
on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..trace import span
from . import resolve_device
from .pairhmm import banded_hits, dispatch_by_length, pack_to_device

TINY = 1e-30


@dataclass(frozen=True)
class Hmm5Params:
    """Five-state pair-HMM (symmetric in query/target gaps).

    match_continue: M->M;  open_short/open_long: M->{S,L} gap opens;
    extend_short/extend_long: gap self-loops; switch_sl / switch_ls:
    short->long / long->short regime changes inside a gap;
    M-returns are the complements (match_from_short = 1 - extend_short -
    switch_sl, match_from_long = 1 - extend_long - switch_ls).
    """
    match_continue: float = 0.9703833696510062
    open_short: float = 0.0129868352330243
    open_long: float = 0.0018197996414636
    extend_short: float = 0.7126062401851738
    extend_long: float = 0.9965634257906200
    switch_sl: float = 0.0007315179552849
    switch_ls: float = 0.0007315179552849
    p_match: float = 0.94

    @property
    def match_from_short(self) -> float:
        return 1.0 - self.extend_short - self.switch_sl

    @property
    def match_from_long(self) -> float:
        return 1.0 - self.extend_long - self.switch_ls

    def emissions(self) -> np.ndarray:
        """Match-state pair emissions as odds ratios vs the uniform null
        (same convention as HmmParams.emissions)."""
        e = np.full((6, 6), (1.0 - self.p_match) / 3.0, dtype=np.float32)
        np.fill_diagonal(e[:4, :4], self.p_match)
        e[4:, :] = 1.0 / 16.0
        e[:, 4:] = 1.0 / 16.0
        return e * 16.0

    def transitions(self) -> tuple[float, ...]:
        """(mc, os, ol, es, el, wsl, wls, ms, ml): the nine transition
        weights in the contract's order."""
        return (self.match_continue, self.open_short, self.open_long,
                self.extend_short, self.extend_long, self.switch_sl,
                self.switch_ls, self.match_from_short, self.match_from_long)


# --------------------------------------------------------------------------
# numpy oracle (full matrix)
# --------------------------------------------------------------------------

def posterior5_np(q: np.ndarray, t: np.ndarray, p: Hmm5Params) -> np.ndarray:
    """Full O(MN) match-state posterior matrix for the 5-state model.
    Test oracle only."""
    M, N = len(q), len(t)
    em = p.emissions()
    mc, os_, ol = p.match_continue, p.open_short, p.open_long
    es, el = p.extend_short, p.extend_long
    wsl, wls = p.switch_sl, p.switch_ls
    ms, ml = p.match_from_short, p.match_from_long

    fM = np.zeros((M + 1, N + 1))
    fSX = np.zeros((M + 1, N + 1))
    fLX = np.zeros((M + 1, N + 1))
    fSY = np.zeros((M + 1, N + 1))
    fLY = np.zeros((M + 1, N + 1))
    fM[0, 0] = 1.0
    for i in range(M + 1):
        for j in range(N + 1):
            if i > 0 and j > 0:
                fM[i, j] = em[q[i - 1], t[j - 1]] * (
                    mc * fM[i - 1, j - 1]
                    + ms * (fSX[i - 1, j - 1] + fSY[i - 1, j - 1])
                    + ml * (fLX[i - 1, j - 1] + fLY[i - 1, j - 1]))
            if i > 0:
                fSX[i, j] += (os_ * fM[i - 1, j] + es * fSX[i - 1, j]
                              + wls * fLX[i - 1, j])
                fLX[i, j] += (ol * fM[i - 1, j] + el * fLX[i - 1, j]
                              + wsl * fSX[i - 1, j])
            if j > 0:
                fSY[i, j] += (os_ * fM[i, j - 1] + es * fSY[i, j - 1]
                              + wls * fLY[i, j - 1])
                fLY[i, j] += (ol * fM[i, j - 1] + el * fLY[i, j - 1]
                              + wsl * fSY[i, j - 1])
    Z = (fM[M, N] + fSX[M, N] + fLX[M, N] + fSY[M, N] + fLY[M, N])

    bM = np.zeros((M + 1, N + 1))
    bSX = np.zeros((M + 1, N + 1))
    bLX = np.zeros((M + 1, N + 1))
    bSY = np.zeros((M + 1, N + 1))
    bLY = np.zeros((M + 1, N + 1))
    bM[M, N] = bSX[M, N] = bLX[M, N] = bSY[M, N] = bLY[M, N] = 1.0
    for i in range(M, -1, -1):
        for j in range(N, -1, -1):
            if i == M and j == N:
                continue
            mm = (em[q[i], t[j]] * bM[i + 1, j + 1]
                  if (i < M and j < N) else 0.0)
            sx = bSX[i + 1, j] if i < M else 0.0
            lx = bLX[i + 1, j] if i < M else 0.0
            sy = bSY[i, j + 1] if j < N else 0.0
            ly = bLY[i, j + 1] if j < N else 0.0
            bM[i, j] = mc * mm + os_ * (sx + sy) + ol * (lx + ly)
            bSX[i, j] = ms * mm + es * sx + wsl * lx
            bLX[i, j] = ml * mm + el * lx + wls * sx
            bSY[i, j] = ms * mm + es * sy + wsl * ly
            bLY[i, j] = ml * mm + el * ly + wls * sy
    post = np.zeros((M, N))
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            post[i - 1, j - 1] = fM[i, j] * bM[i, j] / max(Z, TINY)
    return post


# --------------------------------------------------------------------------
# batched banded forward/backward (plain PyTorch)
# --------------------------------------------------------------------------

def _mat_chain(c1, c2, A, reverse: bool):
    """Solve v[b] = A v[b-1] + c[b] along the band (reverse: v[b] =
    A v[b+1] + c[b]) by the contract's 2-vector matrix Kogge-Stone.
    c1/c2 (P, B); A = (a11, a12, a21, a22).  Returns (y1, y2)."""
    P, B = c1.shape
    dev = c1.device
    y1, y2 = c1, c2
    F11, F12, F21, F22 = (torch.full((P, B), a, dtype=torch.float32,
                                     device=dev) for a in A)

    def shift(x, off):
        z = torch.zeros((P, off), dtype=torch.float32, device=dev)
        if reverse:
            return torch.cat([x[:, off:], z], dim=1)
        return torch.cat([z, x[:, :-off]], dim=1)

    off = 1
    while off < B:
        s1, s2 = shift(y1, off), shift(y2, off)
        y1 = y1 + F11 * s1 + F12 * s2
        y2 = y2 + F21 * s1 + F22 * s2
        G11, G12 = shift(F11, off), shift(F12, off)
        G21, G22 = shift(F21, off), shift(F22, off)
        F11, F12, F21, F22 = (F11 * G11 + F12 * G21, F11 * G12 + F12 * G22,
                              F21 * G11 + F22 * G21, F21 * G12 + F22 * G22)
        off *= 2
    return y1, y2


def _band_frame(q, lo, m_len, n_len, band: int):
    """Shared set-up of both passes: (P, Mmax, b_idx, lo, m, n columns,
    sl, sr) with sl: x[b] <- x[b+1] and sr: x[b] <- x[b-1]."""
    P, Mmax = q.shape
    dev = q.device
    b_idx = torch.arange(band, dtype=torch.int32, device=dev)[None, :]
    zcol = torch.zeros((P, 1), dtype=torch.float32, device=dev)

    def sl(x):
        return torch.cat([x[:, 1:], zcol], dim=1)

    def sr(x):
        return torch.cat([zcol, x[:, :-1]], dim=1)

    return (P, Mmax, b_idx, lo.to(torch.int32)[:, None],
            m_len.to(torch.int32)[:, None], n_len.to(torch.int32)[:, None],
            sl, sr)


def forward_banded5(q, t_shift, m_len, n_len, lo, em, band: int,
                    params: Hmm5Params):
    """Forward pass: (fM (P, M, B) f32 match band of every row after its
    rescale, lsF (P, M) f32 running log-scale after each row, logZ (P,)
    f32).  Plain PyTorch, mirroring cactus_tpu/ops/pairhmm5.py:204-275."""
    P, Mmax, b_idx, lo_c, m_c, n_c, sl, sr = _band_frame(
        q, lo, m_len, n_len, band)
    B = band
    dev = q.device
    f32 = torch.float32
    mc, os_, ol, es, el, wsl, wls, ms, ml = params.transitions()
    A_fwd = (es, wls, wsl, el)        # [SY,LY][b] = A [SY,LY][b-1] + c
    em = em.to(f32)

    # row 0: M at j == 0; the SY/LY chains seeded by the M cell
    j0 = lo_c + b_idx
    fM = torch.where(j0 == 0, 1.0, 0.0).to(f32)
    okY0 = ((j0 >= 1) & (j0 <= n_c)).to(f32)
    fSY, fLY = _mat_chain(okY0 * os_ * sr(fM), okY0 * ol * sr(fM), A_fwd,
                          reverse=False)
    fSY = fSY * okY0
    fLY = fLY * okY0
    fSX = torch.zeros((P, B), dtype=f32, device=dev)
    fLX = torch.zeros((P, B), dtype=f32, device=dev)
    ls = torch.zeros(P, dtype=f32, device=dev)

    q_l = q.long()
    t_l = t_shift.long()
    fM_rows = torch.empty((P, Mmax, B), dtype=f32, device=dev)
    lsF_rows = torch.empty((P, Mmax), dtype=f32, device=dev)
    b_end = n_len.long() - m_len.long() - lo.long()
    end_row = torch.clamp_min(m_len.long(), 1)     # row i = max(m, 1)
    end_tot = torch.zeros(P, dtype=f32, device=dev)
    pidx = torch.arange(P, device=dev)
    for i in range(1, Mmax + 1):
        emit = em[q_l[:, i - 1:i], t_l[:, i - 1:i - 1 + B]]
        j = i + lo_c + b_idx
        ok = (j >= 1) & (j <= n_c) & (i <= m_c)
        okx = (j >= 0) & (j <= n_c) & (i <= m_c)
        mM = emit * (mc * fM + ms * (fSX + fSY) + ml * (fLX + fLY))
        mM = torch.where(ok, mM, 0.0)
        mSX = os_ * sl(fM) + es * sl(fSX) + wls * sl(fLX)
        mLX = ol * sl(fM) + el * sl(fLX) + wsl * sl(fSX)
        mSX = torch.where(okx, mSX, 0.0)
        mLX = torch.where(okx, mLX, 0.0)
        okf = ok.to(f32)
        mSY, mLY = _mat_chain(okf * os_ * sr(mM), okf * ol * sr(mM), A_fwd,
                              reverse=False)
        mSY = mSY * okf
        mLY = mLY * okf
        tot = mM + mSX + mLX + mSY + mLY
        scale = torch.clamp_min(tot.amax(dim=1, keepdim=True), TINY)
        fM, fSX, fLX = mM / scale, mSX / scale, mLX / scale
        fSY, fLY = mSY / scale, mLY / scale
        ls = ls + torch.log(scale[:, 0])
        fM_rows[:, i - 1] = fM
        lsF_rows[:, i - 1] = ls
        at = end_row == i
        if bool(at.any()):
            sel = pidx[at]
            be = b_end[at]
            end_tot[sel] = fM[sel, be] + (fSX + fLX + fSY + fLY)[sel, be]
    end_ls = lsF_rows.gather(1, (end_row - 1)[:, None])[:, 0]
    logZ = torch.log(torch.clamp_min(end_tot, TINY)) + end_ls
    return fM_rows, lsF_rows, logZ


def backward_posterior5(fM_rows, lsF_rows, logZ, q, t_shift, m_len, n_len,
                        lo, em, band: int, params: Hmm5Params):
    """Backward pass fused with the posterior combine: post (P, M, B) f32,
    fM*bM*exp(clip(lsF+lsB-logZ, -60, 60)) clipped to [0, 1.5], zero past
    each pair's m_len.  Plain PyTorch, mirroring
    cactus_tpu/ops/pairhmm5.py:277-352."""
    P, Mmax, b_idx, lo_c, m_c, n_c, sl, sr = _band_frame(
        q, lo, m_len, n_len, band)
    B = band
    dev = q.device
    f32 = torch.float32
    mc, os_, ol, es, el, wsl, wls, ms, ml = params.transitions()
    A_bwd = (es, wsl, wls, el)        # the forward chain's transpose
    em = em.to(f32)

    def terminal_row(i):
        """Backward values for row i == m_len: only Y-gap chains remain.
        v[j] = A^T v[j+1] with v[n] = (1,1); bM[j] = opens . v[j+1]."""
        j = i + lo_c + b_idx
        jn = n_c - j
        at_end = (jn == 0).to(f32)
        okc = ((jn >= 0) & (j >= 0)).to(f32)
        ty1, ty2 = _mat_chain(at_end, at_end, A_bwd, reverse=True)
        ty1 = ty1 * okc
        ty2 = ty2 * okc
        bm = at_end + (os_ * sl(ty1) + ol * sl(ty2)) * okc * (1.0 - at_end)
        return bm, at_end, at_end, ty1, ty2

    q_l = q.long()
    t_l = t_shift.long()
    zero = torch.zeros((P, B), dtype=f32, device=dev)
    bM, bSX, bLX, bSY, bLY = zero, zero, zero, zero, zero
    ls = torch.zeros(P, dtype=f32, device=dev)
    post = torch.empty((P, Mmax, B), dtype=f32, device=dev)
    term_rows = set(int(x) for x in m_len.tolist())
    for i in range(Mmax, 0, -1):
        if i in term_rows:
            # reset the pairs whose terminal row is i (the contract
            # evaluates the terminal form on every row and keeps it only
            # there; the values kept are the same)
            is_term = m_c == i
            tm, tsx, tlx, tsy, tly = terminal_row(i)
            bM = torch.where(is_term, tm, bM)
            bSX = torch.where(is_term, tsx, bSX)
            bLX = torch.where(is_term, tlx, bLX)
            bSY = torch.where(is_term, tsy, bSY)
            bLY = torch.where(is_term, tly, bLY)
            ls = torch.where(is_term[:, 0], 0.0, ls)
        # the carry holds row i: its posterior (exclusive log-scale), then
        # row i-1
        g = torch.exp(torch.clamp(lsF_rows[:, i - 1] + ls - logZ,
                                  -60.0, 60.0))
        post[:, i - 1] = fM_rows[:, i - 1] * bM * g[:, None]
        emit = em[q_l[:, i - 1:i], t_l[:, i - 1:i - 1 + B]]
        jprev = (i - 1) + lo_c + b_idx
        live = i <= m_c
        mm = emit * bM
        mm = torch.where((jprev + 1 <= n_c) & live, mm, 0.0)
        okx = (jprev >= 0) & (jprev <= n_c) & live
        sx = torch.where(okx, sr(bSX), 0.0)
        lx = torch.where(okx, sr(bLX), 0.0)
        nSX = ms * mm + es * sx + wsl * lx
        nLX = ml * mm + el * lx + wls * sx
        ySY, yLY = _mat_chain(ms * mm, ml * mm, A_bwd, reverse=True)
        nM = mc * mm + os_ * (sx + sl(ySY)) + ol * (lx + sl(yLY))
        okp = (jprev >= 0) & (jprev <= n_c)
        nM = torch.where(okp, nM, 0.0)
        nSX = torch.where(okp, nSX, 0.0)
        nLX = torch.where(okp, nLX, 0.0)
        nSY = torch.where(okp, ySY, 0.0)
        nLY = torch.where(okp, yLY, 0.0)
        tot = nM + nSX + nLX + nSY + nLY
        scale = torch.clamp_min(tot.amax(dim=1, keepdim=True), TINY)
        ls2 = ls + torch.where(live[:, 0], torch.log(scale[:, 0]), 0.0)
        bM = torch.where(live, nM / scale, bM)
        bSX = torch.where(live, nSX / scale, bSX)
        bLX = torch.where(live, nLX / scale, bLX)
        bSY = torch.where(live, nSY / scale, bSY)
        bLY = torch.where(live, nLY / scale, bLY)
        ls = torch.where(live[:, 0], ls2, ls)
    row_ids = torch.arange(1, Mmax + 1, device=dev)[None, :, None]
    post = torch.where(row_ids <= m_len.long()[:, None, None], post, 0.0)
    return torch.clamp(post, 0.0, 1.5)


def posterior_banded_batch5(q, t_shift, m_len, n_len, lo, em, band: int,
                            params: Hmm5Params, max_live: int | None = None):
    """Match posteriors over the band, five-state machine: post (P, Mmax,
    B) float32, band cell (i, b) is target position j = i + lo + b
    (1-based rows); rows beyond each pair's m_len are zero.

    Runs the CUDA kernels for CUDA tensors and the plain PyTorch versions
    for CPU tensors (ops/pairhmm5_cuda.py).  max_live bounds every row's
    live width min(band, n + 1) (default: the band); the kernels size
    their blocks by it, and a value below a pair's width raises."""
    from .pairhmm5_cuda import pairhmm5_bwd, pairhmm5_fwd
    kw = dict(band=band, params=params, max_live=max_live)
    fM, lsF, logZ = pairhmm5_fwd(q, t_shift, m_len, n_len, lo, em, **kw)
    return pairhmm5_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em,
                        **kw)


def posterior_pairs_banded5(pairs, params: Hmm5Params, band: int = 128,
                            gamma: float = 0.5,
                            max_batch_bytes: int = 1 << 30, device=None):
    """Aligned (qpos, tpos, posterior) per pair via the 5-state kernels.

    Pairs dispatch in pow2 query-length bins (pairhmm.dispatch_by_length)
    so one long pair cannot pad the whole batch to its row count, and
    each bin splits so that a dispatch's two (P, rows, band) float32
    tensors stay under max_batch_bytes.  A pair's hits do not depend on
    the rest of its batch.  Spans (cactus_tpu_torch/trace.py) as
    pairhmm.posterior_pairs_banded's, the call's named
    `cactus.posterior_pairs_banded5`."""
    if not pairs:
        return []
    dev = resolve_device(device)

    def run(chunk):
        with span("cactus.pack"):
            packed, t = pack_to_device(chunk, band, dev)
        # the widest live row, from the host lengths (no device sync)
        live = max(min(band, len(tt) + 1) for _q, tt in chunk)
        return banded_hits(
            posterior_banded_batch5(*t, em, band=band, params=params,
                                    max_live=live),
            chunk, packed["lo"], gamma)

    with span("cactus.posterior_pairs_banded5"):
        em = torch.from_numpy(params.emissions()).to(dev)
        return dispatch_by_length(pairs, band, run,
                                  max_batch_bytes=max_batch_bytes)
