"""Plain PyTorch reference of the banded 5-state pair-HMM posteriors.

The semantics the 5-state engine (`posterior_pairs_banded5`, cPecan's
stateMachine5) owes its callers, written again here without any code of
the program: match M, short and long gaps on each side (SX / LX consume
the query, SY / LY the target) with the nine transitions of the
configuration (match_continue, open_short, open_long, extend_short,
extend_long, switch_sl, switch_ls and the two returns to M, 1 - extend -
switch), emissions as in the 3-state reference, in the band placement
of `banded.band_offset` and in scaled linear space (each row divided by
its band maximum, the log of the scale carried).  The in-row target gap
chain is the coupled recurrence [SY, LY][b] = A [SY, LY][b - 1] + c[b]
(A transposed and reversed backward).  Posterior and hits as in
`pairhmm.posterior`.

`dtype`: float64 is the reference, bfloat16 the control.
"""

from __future__ import annotations

import torch

from .pairhmm import TINY, emissions, pack, shift_left, shift_right

TRANSITIONS = ("match_continue", "open_short", "open_long", "extend_short",
               "extend_long", "switch_sl", "switch_ls")


def mat_chain(c1, c2, A, reverse: bool):
    """v[b] = A v[b -/+ 1] + c[b] along the band by doubling; A = (a11,
    a12, a21, a22)."""
    P, B = c1.shape
    y1, y2 = c1, c2
    F = [torch.full_like(c1, a) for a in A]

    def sh(x, off):
        if reverse:
            return torch.nn.functional.pad(x[:, off:], (0, off))
        return torch.nn.functional.pad(x[:, :-off], (off, 0))

    off = 1
    while off < B:
        s1, s2 = sh(y1, off), sh(y2, off)
        y1 = y1 + F[0] * s1 + F[1] * s2
        y2 = y2 + F[2] * s1 + F[3] * s2
        G = [sh(f, off) for f in F]
        F = [F[0] * G[0] + F[1] * G[2], F[0] * G[1] + F[1] * G[3],
             F[2] * G[0] + F[3] * G[2], F[2] * G[1] + F[3] * G[3]]
        off *= 2
    return y1, y2


def posterior(pairs, band: int, params: dict, dtype=torch.float64,
              device="cpu"):
    """(post (P, M, band) float32 on the host, lo (P,)); params: the
    seven transitions and p_match."""
    dev = torch.device(device)
    q, ts, m, n, lo = pack(pairs, band, dev)
    P, M = q.shape
    B = band
    mc_, os_, ol, es, el, wsl, wls = (params[k] for k in TRANSITIONS)
    ms, ml = 1.0 - es - wsl, 1.0 - el - wls
    A_fwd = (es, wls, wsl, el)
    A_bwd = (es, wsl, wls, el)
    em = emissions(params["p_match"], dtype, dev)
    b = torch.arange(B, device=dev)[None, :]
    loc, mc, nc = lo[:, None], m[:, None], n[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    # forward: row 0 holds M at j = 0 and the target gap chains it seeds
    j0 = loc + b
    fM = torch.where(j0 == 0, one, zero)
    okY0 = ((j0 >= 1) & (j0 <= nc)).to(dtype)
    fSY, fLY = mat_chain(okY0 * os_ * shift_right(fM),
                         okY0 * ol * shift_right(fM), A_fwd, False)
    fSY, fLY = fSY * okY0, fLY * okY0
    fSX = torch.zeros((P, B), dtype=dtype, device=dev)
    fLX = torch.zeros_like(fSX)
    ls = torch.zeros(P, dtype=dtype, device=dev)
    fM_rows = torch.empty((P, M, B), dtype=dtype, device=dev)
    lsF = torch.empty((P, M), dtype=dtype, device=dev)
    end_row = torch.clamp_min(m, 1)
    b_end = n - m - lo
    end_tot = torch.zeros(P, dtype=dtype, device=dev)
    for i in range(1, M + 1):
        emit = em[q[:, i - 1:i], ts[:, i - 1:i - 1 + B]]
        j = i + loc + b
        ok = (j >= 1) & (j <= nc) & (i <= mc)
        okx = (j >= 0) & (j <= nc) & (i <= mc)
        mM = torch.where(ok, emit * (mc_ * fM + ms * (fSX + fSY)
                                     + ml * (fLX + fLY)), zero)
        mSX = torch.where(okx, os_ * shift_left(fM) + es * shift_left(fSX)
                          + wls * shift_left(fLX), zero)
        mLX = torch.where(okx, ol * shift_left(fM) + el * shift_left(fLX)
                          + wsl * shift_left(fSX), zero)
        okf = ok.to(dtype)
        mSY, mLY = mat_chain(okf * os_ * shift_right(mM),
                             okf * ol * shift_right(mM), A_fwd, False)
        mSY, mLY = mSY * okf, mLY * okf
        tot = mM + mSX + mLX + mSY + mLY
        scale = torch.clamp_min(tot.amax(dim=1, keepdim=True), TINY)
        fM, fSX, fLX = mM / scale, mSX / scale, mLX / scale
        fSY, fLY = mSY / scale, mLY / scale
        ls = ls + torch.log(scale[:, 0])
        fM_rows[:, i - 1] = fM
        lsF[:, i - 1] = ls
        at = torch.nonzero(end_row == i)[:, 0]
        if len(at):
            be = b_end[at]
            end_tot[at] = fM[at, be] + (fSX + fLX + fSY + fLY)[at, be]
    end_ls = lsF.gather(1, (end_row - 1)[:, None])[:, 0]
    logZ = torch.log(torch.clamp_min(end_tot, TINY)) + end_ls

    # backward; at a pair's last row only the target gap chains remain:
    # v[j] = A^T v[j + 1] from v[n] = (1, 1), bM[j] = opens . v[j + 1]
    bM = torch.zeros((P, B), dtype=dtype, device=dev)
    bSX, bLX = torch.zeros_like(bM), torch.zeros_like(bM)
    ls = torch.zeros(P, dtype=dtype, device=dev)
    post = torch.zeros((P, M, B), dtype=torch.float32, device=dev)
    for i in range(M, 0, -1):
        term = mc == i
        if bool(term.any()):
            j = i + loc + b
            jn = nc - j
            at_end = (jn == 0).to(dtype)
            okc = ((jn >= 0) & (j >= 0)).to(dtype)
            ty1, ty2 = mat_chain(at_end, at_end, A_bwd, True)
            ty1, ty2 = ty1 * okc, ty2 * okc
            tm = at_end + (os_ * shift_left(ty1) + ol * shift_left(ty2)) \
                * okc * (1.0 - at_end)
            bM = torch.where(term, tm, bM)
            bSX = torch.where(term, at_end, bSX)
            bLX = torch.where(term, at_end, bLX)
            ls = torch.where(term[:, 0], zero, ls)
        g = torch.exp(torch.clamp(lsF[:, i - 1] + ls - logZ, -60.0, 60.0))
        row = fM_rows[:, i - 1] * bM * g[:, None]
        post[:, i - 1] = torch.clamp(row, 0.0, 1.5).float()
        emit = em[q[:, i - 1:i], ts[:, i - 1:i - 1 + B]]
        jp = (i - 1) + loc + b
        live = i <= mc
        mm = torch.where((jp + 1 <= nc) & live, emit * bM, zero)
        okx = (jp >= 0) & (jp <= nc) & live
        sx = torch.where(okx, shift_right(bSX), zero)
        lx = torch.where(okx, shift_right(bLX), zero)
        nSX = ms * mm + es * sx + wsl * lx
        nLX = ml * mm + el * lx + wls * sx
        ySY, yLY = mat_chain(ms * mm, ml * mm, A_bwd, True)
        nM = mc_ * mm + os_ * (sx + shift_left(ySY)) + ol * (
            lx + shift_left(yLY))
        okp = (jp >= 0) & (jp <= nc)
        nM = torch.where(okp, nM, zero)
        nSX = torch.where(okp, nSX, zero)
        nLX = torch.where(okp, nLX, zero)
        nSY = torch.where(okp, ySY, zero)
        nLY = torch.where(okp, yLY, zero)
        tot = nM + nSX + nLX + nSY + nLY
        scale = torch.clamp_min(tot.amax(dim=1, keepdim=True), TINY)
        ls = torch.where(live[:, 0], ls + torch.log(scale[:, 0]), ls)
        bM = torch.where(live, nM / scale, bM)
        bSX = torch.where(live, nSX / scale, bSX)
        bLX = torch.where(live, nLX / scale, bLX)
    rows = torch.arange(1, M + 1, device=dev)[None, :, None]
    post = torch.where(rows <= m[:, None, None], post, 0.0)
    return post.cpu().numpy(), lo.cpu().numpy()
