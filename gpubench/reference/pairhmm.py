"""Plain PyTorch reference of the banded 3-state pair-HMM posteriors.

The semantics the 3-state engine (`posterior_pairs_banded`) owes its
callers, written again here without any code of the program.  A pair
(q, t) runs inside the band [lo, lo + band) of ops/banded.py's placement
(`banded.band_offset`): match M, X (consumes the query) and Y (consumes
the target) with gap open delta and extend epsilon, emissions as odds
ratios against the uniform null (p_match on a same-base pair, the rest
spread over the mismatches, 1/16 against a pad or N, all times 16), in
scaled linear space: every row is divided by its band maximum and the
log of the scale is carried.  The posterior of band cell (i, b) is
fM * bM * exp(clip(lsF + lsB - logZ, -60, 60)) clipped to [0, 1.5]; a
hit is a query row's first band argmax where it reaches gamma and lands
inside the target.

`dtype` is the floating type of every value: float64 is the reference;
bfloat16 is the control (the nearest precision below the
configuration's float32).
"""

from __future__ import annotations

import numpy as np
import torch

from . import banded

TINY = 1e-30


def emissions(p_match: float, dtype, device):
    e = np.full((6, 6), (1.0 - p_match) / 3.0)
    np.fill_diagonal(e[:4, :4], p_match)
    e[4:, :] = 1.0 / 16.0
    e[:, 4:] = 1.0 / 16.0
    return torch.tensor(e * 16.0, dtype=dtype, device=device)


def pack(pairs, band: int, device):
    """banded.pack's arrays as tensors on the device."""
    return [torch.from_numpy(x).to(device) for x in banded.pack(pairs, band)]


def shift_right(x):
    """x[b] <- x[b - 1], 0 at b = 0."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0))


def shift_left(x):
    """x[b] <- x[b + 1], 0 at the last b."""
    return torch.nn.functional.pad(x[:, 1:], (0, 1))


def chain(s, e: float, reverse: bool):
    """y[b] = s[b] + e * y[b -/+ 1] along the band, by doubling."""
    P, B = s.shape
    y = s
    f = torch.full_like(s, e)
    off = 1
    while off < B:
        if reverse:
            y = y + f * torch.nn.functional.pad(y[:, off:], (0, off))
            f = f * torch.nn.functional.pad(f[:, off:], (0, off))
        else:
            y = y + f * torch.nn.functional.pad(y[:, :-off], (off, 0))
            f = f * torch.nn.functional.pad(f[:, :-off], (off, 0))
        off *= 2
    return y


def posterior(pairs, band: int, delta: float, epsilon: float,
              p_match: float, dtype=torch.float64, device="cpu"):
    """(post (P, M, band) float32 on the host, lo (P,)): the match
    posterior of every band cell of rows 1..M (zero past each pair's m)."""
    dev = torch.device(device)
    q, ts, m, n, lo = pack(pairs, band, dev)
    P, M = q.shape
    B = band
    d, e = delta, epsilon
    tMM = 1.0 - 2.0 * d
    em = emissions(p_match, dtype, dev)
    b = torch.arange(B, device=dev)[None, :]
    loc, mc, nc = lo[:, None], m[:, None], n[:, None]

    def full(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def epow(k):
        return torch.pow(full(e), k.to(dtype))

    zero = full(0.0)
    # forward
    j0 = loc + b
    fM = torch.where(j0 == 0, full(1.0), zero)
    fY = torch.where((j0 >= 1) & (j0 <= nc),
                     d * epow(torch.clamp_min(j0 - 1, 0)), zero)
    fX = torch.zeros((P, B), dtype=dtype, device=dev)
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
        mM = torch.where(ok, emit * (tMM * fM + (1 - e) * (fX + fY)), zero)
        mX = d * shift_left(fM) + e * shift_left(fX)
        mX = torch.where((j >= 0) & (j <= nc) & (i <= mc), mX, zero)
        mY = torch.where(ok, chain(d * shift_right(mM), e, False), zero)
        scale = torch.clamp_min((mM + mX + mY).amax(dim=1, keepdim=True),
                                TINY)
        fM, fX, fY = mM / scale, mX / scale, mY / scale
        ls = ls + torch.log(scale[:, 0])
        fM_rows[:, i - 1] = fM
        lsF[:, i - 1] = ls
        at = torch.nonzero(end_row == i)[:, 0]
        if len(at):
            be = b_end[at]
            end_tot[at] = fM[at, be] + (fX + fY)[at, be]
    end_ls = lsF.gather(1, (end_row - 1)[:, None])[:, 0]
    logZ = torch.log(torch.clamp_min(end_tot, TINY)) + end_ls

    # backward, with the posterior of each row as the carry reaches it
    bM = torch.zeros((P, B), dtype=dtype, device=dev)
    bX = torch.zeros_like(bM)
    ls = torch.zeros(P, dtype=dtype, device=dev)
    post = torch.zeros((P, M, B), dtype=torch.float32, device=dev)
    for i in range(M, 0, -1):
        term = mc == i
        if bool(term.any()):
            j = i + loc + b
            jn = nc - j
            tm = torch.where(jn == 0, full(1.0), torch.where(
                jn > 0, d * epow(torch.clamp_min(jn - 1, 0)), zero))
            tx = torch.where(jn == 0, full(1.0), zero)
            bM = torch.where(term, tm, bM)
            bX = torch.where(term, tx, bX)
            ls = torch.where(term[:, 0], zero, ls)
        g = torch.exp(torch.clamp(lsF[:, i - 1] + ls - logZ, -60.0, 60.0))
        row = fM_rows[:, i - 1] * bM * g[:, None]
        post[:, i - 1] = torch.clamp(row, 0.0, 1.5).float()
        emit = em[q[:, i - 1:i], ts[:, i - 1:i - 1 + B]]
        jp = (i - 1) + loc + b
        live = i <= mc
        mm = torch.where((jp + 1 <= nc) & live, emit * bM, zero)
        x = torch.where((jp >= 0) & (jp <= nc) & live, shift_right(bX), zero)
        nX = (1 - e) * mm + e * x
        y = chain((1 - e) * mm, e, True)
        nM = tMM * mm + d * x + d * shift_left(y)
        okp = (jp >= 0) & (jp <= nc)
        nM = torch.where(okp, nM, zero)
        nX = torch.where(okp, nX, zero)
        nY = torch.where(okp, y, zero)
        scale = torch.clamp_min((nM + nX + nY).amax(dim=1, keepdim=True),
                                TINY)
        ls = torch.where(live[:, 0], ls + torch.log(scale[:, 0]), ls)
        bM = torch.where(live, nM / scale, bM)
        bX = torch.where(live, nX / scale, bX)
    rows = torch.arange(1, M + 1, device=dev)[None, :, None]
    post = torch.where(rows <= m[:, None, None], post, 0.0)
    return post.cpu().numpy(), lo.cpu().numpy()
