"""Batched banded pair-HMM forward/backward posteriors (PyTorch port).

Replaces cPecan's pairwise-HMM posterior aligner (reference: submodule
cPecan, pairwiseAligner.h; consumed by the BAR pecan path at
bar/impl/bar.c:65 with banding params cactus_progressive_config.xml:
276-280).  A three-state (match M / insert X / delete Y) HMM runs in
SCALED LINEAR space: every row is renormalised by its band maximum and
the log of the scale is carried, so every cell is float32 multiply-add
with no transcendentals in the hot loop.  X consumes query, Y consumes
target; Y's in-row chain is the first-order linear recurrence
y[b] = s[b] + e*y[b-1].

Band geometry is shared with ops/banded.py (host-shifted targets,
j = i + lo + b).  Outputs are match-state posteriors per band cell;
aligned pairs come from thresholding (posteriorGamma) with per-row
argmax.

The contract (cactus_tpu/ops/pairhmm.py::posterior_banded_batch) is
split in two here, each with a plain PyTorch version that mirrors the
contract op for op (Kogge-Stone order of the in-row chains included):
`forward_banded` and `backward_posterior`.  Their hand-written CUDA
kernels are ops/pairhmm_cuda.py::pairhmm_fwd and ::pairhmm_bwd, which
`posterior_pairs_banded` launches for every batch on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import accumulate

import numpy as np
import torch

from ..trace import span
from . import resolve_device

TINY = 1e-30
# Widest band at which the nested phase aligns a seedless piece at all:
# a piece whose diagonal range needs more is an anchorless long piece
# (wrong strand or unrelated) whose posterior would be diffuse, so it is
# skipped (cactus_tpu/phases/nested.py:105-111).  This is semantics, not
# a backend limit: the CUDA kernels take any band.
NESTED_MAX_BAND = 2048


@dataclass(frozen=True)
class HmmParams:
    """Three-state pair-HMM (symmetric gaps).

    delta: gap open; epsilon: gap extend; p_match: same-base emission
    probability under M (rest spread over mismatches); gap states emit
    uniformly.  Emissions are odds ratios vs the null (keeps scaled
    linear-space values near 1).
    """
    delta: float = 0.025
    epsilon: float = 0.79
    p_match: float = 0.94

    def emissions(self) -> np.ndarray:
        e = np.full((6, 6), (1.0 - self.p_match) / 3.0, dtype=np.float32)
        np.fill_diagonal(e[:4, :4], self.p_match)
        e[4:, :] = 1.0 / 16.0
        e[:, 4:] = 1.0 / 16.0
        return e * 16.0


def _chain_fwd(s, e: float):
    """Solve y[b] = s[b] + e*y[b-1] along the band (Kogge-Stone), in
    s's dtype."""
    P, B = s.shape
    y = s
    f = torch.full((P, B), e, dtype=s.dtype, device=s.device)
    off = 1
    while off < B:
        z = torch.zeros((P, off), dtype=s.dtype, device=s.device)
        y = y + f * torch.cat([z, y[:, :-off]], dim=1)
        f = f * torch.cat([z, f[:, :-off]], dim=1)
        off *= 2
    return y


def _chain_bwd(s, e: float):
    """Solve y[b] = s[b] + e*y[b+1] along the band (reverse Kogge-Stone)."""
    P, B = s.shape
    y = s
    f = torch.full((P, B), e, dtype=torch.float32, device=s.device)
    off = 1
    while off < B:
        z = torch.zeros((P, off), dtype=torch.float32, device=s.device)
        y = y + f * torch.cat([y[:, off:], z], dim=1)
        f = f * torch.cat([f[:, off:], z], dim=1)
        off *= 2
    return y


def _epow(e: float, k, dev, dtype=torch.float32):
    """e ** k in float32 (or dtype) for an int tensor k (the contract's
    e ** j)."""
    return torch.pow(torch.tensor(e, dtype=dtype, device=dev), k.to(dtype))


def forward_banded(q, t_shift, m_len, n_len, lo, em, band: int,
                   delta: float, epsilon: float, dtype=torch.float32):
    """Forward pass: (fM (P, M, B) f32 match band of every row after its
    rescale, lsF (P, M) f32 running log-scale after each row, logZ (P,)
    f32).  Plain PyTorch, mirroring cactus_tpu/ops/pairhmm.py:160-200.
    dtype=torch.float64 runs the same steps in double precision, a
    reference for the float32 values (tests/pairhmm_float64_report.py)."""
    P, Mmax = q.shape
    B = band
    dev = q.device
    f32 = dtype
    d, e = delta, epsilon
    tMM = 1.0 - 2.0 * d
    em = em.to(f32)
    b_idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    lo_c = lo.to(torch.int32)[:, None]
    m_c = m_len.to(torch.int32)[:, None]
    n_c = n_len.to(torch.int32)[:, None]
    zcol = torch.zeros((P, 1), dtype=f32, device=dev)

    def sl(x):  # x[b] <- x[b+1]
        return torch.cat([x[:, 1:], zcol], dim=1)

    def sr(x):  # x[b] <- x[b-1]
        return torch.cat([zcol, x[:, :-1]], dim=1)

    j0 = lo_c + b_idx
    fM = torch.where(j0 == 0, 1.0, 0.0).to(f32)
    fY = torch.where((j0 >= 1) & (j0 <= n_c),
                     d * _epow(e, torch.clamp_min(j0 - 1, 0), dev, f32),
                     0.0).to(f32)
    fX = torch.zeros((P, B), dtype=f32, device=dev)
    ls = torch.zeros(P, dtype=f32, device=dev)
    q_l = q.long()
    t_l = t_shift.long()
    fM_rows = torch.empty((P, Mmax, B), dtype=f32, device=dev)
    lsF_rows = torch.empty((P, Mmax), dtype=f32, device=dev)
    b_end = (n_len.long() - m_len.long() - lo.long())
    end_row = torch.clamp_min(m_len.long(), 1)     # row i = max(m, 1)
    end_tot = torch.zeros(P, dtype=f32, device=dev)
    pidx = torch.arange(P, device=dev)
    for i in range(1, Mmax + 1):
        emit = em[q_l[:, i - 1:i], t_l[:, i - 1:i - 1 + B]]
        j = i + lo_c + b_idx
        ok = (j >= 1) & (j <= n_c) & (i <= m_c)
        mM = emit * (tMM * fM + (1 - e) * (fX + fY))
        mM = torch.where(ok, mM, 0.0)
        mX = d * sl(fM) + e * sl(fX)
        mX = torch.where((j >= 0) & (j <= n_c) & (i <= m_c), mX, 0.0)
        mY = _chain_fwd(d * sr(mM), e)
        mY = torch.where(ok, mY, 0.0)
        scale = torch.clamp_min((mM + mX + mY).amax(dim=1, keepdim=True),
                                TINY)
        fM, fX, fY = mM / scale, mX / scale, mY / scale
        ls = ls + torch.log(scale[:, 0])
        fM_rows[:, i - 1] = fM
        lsF_rows[:, i - 1] = ls
        at = end_row == i
        if bool(at.any()):
            sel = pidx[at]
            be = b_end[at]
            end_tot[sel] = fM[sel, be] + (fX + fY)[sel, be]
    end_ls = lsF_rows.gather(1, (end_row - 1)[:, None])[:, 0]
    logZ = torch.log(torch.clamp_min(end_tot, TINY)) + end_ls
    return fM_rows, lsF_rows, logZ


def backward_posterior(fM_rows, lsF_rows, logZ, q, t_shift, m_len, n_len,
                       lo, em, band: int, delta: float, epsilon: float):
    """Backward pass fused with the posterior combine: post (P, M, B) f32,
    fM*bM*exp(clip(lsF+lsB-logZ, -60, 60)) clipped to [0, 1.5], zero past
    each pair's m_len.  Plain PyTorch, mirroring
    cactus_tpu/ops/pairhmm.py:202-269."""
    P, Mmax = q.shape
    B = band
    dev = q.device
    f32 = torch.float32
    d, e = delta, epsilon
    tMM = 1.0 - 2.0 * d
    em = em.to(f32)
    b_idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    lo_c = lo.to(torch.int32)[:, None]
    m_c = m_len.to(torch.int32)[:, None]
    n_c = n_len.to(torch.int32)[:, None]
    zcol = torch.zeros((P, 1), dtype=f32, device=dev)

    def sl(x):
        return torch.cat([x[:, 1:], zcol], dim=1)

    def sr(x):
        return torch.cat([zcol, x[:, :-1]], dim=1)

    def terminal_row(i):
        """Backward values for row i == m_len (per pair)."""
        j = i + lo_c + b_idx
        jn = n_c - j
        at_end = jn == 0
        before = jn > 0
        y = torch.where(at_end, 1.0, torch.where(
            before, _epow(e, torch.clamp_min(jn, 0), dev), 0.0)).to(f32)
        bm = torch.where(at_end, 1.0, torch.where(
            before, d * _epow(e, torch.clamp_min(jn - 1, 0), dev),
            0.0)).to(f32)
        bx = torch.where(at_end, 1.0, 0.0).to(f32)
        return bm, bx, y

    q_l = q.long()
    t_l = t_shift.long()
    bM = torch.zeros((P, B), dtype=f32, device=dev)
    bX = torch.zeros((P, B), dtype=f32, device=dev)
    bY = torch.zeros((P, B), dtype=f32, device=dev)
    ls = torch.zeros(P, dtype=f32, device=dev)
    post = torch.empty((P, Mmax, B), dtype=f32, device=dev)
    for i in range(Mmax, 0, -1):
        # reset pairs whose terminal row is i
        is_term = m_c == i
        tm, tx, ty = terminal_row(i)
        bM = torch.where(is_term, tm, bM)
        bX = torch.where(is_term, tx, bX)
        bY = torch.where(is_term, ty, bY)
        ls = torch.where(is_term[:, 0], 0.0, ls)
        # the carry holds row i: its posterior, then row i-1
        g = torch.exp(torch.clamp(lsF_rows[:, i - 1] + ls - logZ,
                                  -60.0, 60.0))
        post[:, i - 1] = fM_rows[:, i - 1] * bM * g[:, None]
        emit = em[q_l[:, i - 1:i], t_l[:, i - 1:i - 1 + B]]
        jprev = (i - 1) + lo_c + b_idx       # j of row i-1 cells
        # M/X/Y at (i-1, j): the mm move lands on (i, j+1) = band b of row i
        mm = emit * bM
        mm = torch.where((jprev + 1 <= n_c) & (i <= m_c), mm, 0.0)
        x = sr(bX)                            # (i, j) = band b-1 of row i
        x = torch.where((jprev >= 0) & (jprev <= n_c) & (i <= m_c), x, 0.0)
        nX = (1 - e) * mm + e * x
        y = _chain_bwd((1 - e) * mm, e)
        nM = tMM * mm + d * x + d * sl(y)
        nY = y
        okp = (jprev >= 0) & (jprev <= n_c)
        nM = torch.where(okp, nM, 0.0)
        nX = torch.where(okp, nX, 0.0)
        nY = torch.where(okp, nY, 0.0)
        scale = torch.clamp_min((nM + nX + nY).amax(dim=1, keepdim=True),
                                TINY)
        nM, nX, nY = nM / scale, nX / scale, nY / scale
        # pairs at/above their terminal keep the reset (no scale growth
        # before their terminal row); others accumulate
        live = i <= m_c
        ls2 = ls + torch.where(live[:, 0], torch.log(scale[:, 0]), 0.0)
        bM = torch.where(live, nM, bM)
        bX = torch.where(live, nX, bX)
        bY = torch.where(live, nY, bY)
        ls = torch.where(live[:, 0], ls2, ls)
    row_ids = torch.arange(1, Mmax + 1, device=dev)[None, :, None]
    post = torch.where(row_ids <= m_len.long()[:, None, None], post, 0.0)
    return torch.clamp(post, 0.0, 1.5)


def posterior_banded_batch(q, t_shift, m_len, n_len, lo, em, band: int,
                           delta: float, epsilon: float,
                           max_live: int | None = None):
    """Match posteriors over the band for a batch of pairs, post (P, Mmax,
    B) float32: posterior that q[i-1] aligns to t[j-1] (band cell (i, b),
    j = i + lo + b); rows beyond each pair's m_len are zero.

    Runs the CUDA kernels for CUDA tensors and the plain PyTorch versions
    for CPU tensors (ops/pairhmm_cuda.py).  max_live bounds every row's
    live width min(band, n + 1) (default: the band); the wide route sizes
    its clusters by it, and a value below a pair's width raises."""
    from .pairhmm_cuda import pairhmm_bwd, pairhmm_fwd
    kw = dict(band=band, delta=delta, epsilon=epsilon)
    if max_live is not None:
        kw["max_live"] = max_live
    fM, lsF, logZ = pairhmm_fwd(q, t_shift, m_len, n_len, lo, em, **kw)
    return pairhmm_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, **kw)


def _row_argmax(post):
    """Per-row band reduction on the device: (P, Mmax, B) -> first argmax
    (int32) and max.  Only these (P, Mmax) rows leave the device."""
    return torch.argmax(post, dim=2).to(torch.int32), post.amax(dim=2)


def length_bins(pairs, min_rows: int = 256) -> dict[int, list[int]]:
    """Pair indices grouped by pow2 query-length bins (bounds the row
    padding of a batch at 2x)."""
    bins: dict[int, list[int]] = {}
    for i, (q, _t) in enumerate(pairs):
        b = max(min_rows, 1 << (max(1, len(q)) - 1).bit_length())
        bins.setdefault(b, []).append(i)
    return bins


def dispatch_by_length(pairs, band: int, run, min_rows: int = 256,
                       max_batch: int = 0, max_batch_bytes: int = 1 << 30):
    """run(list of pairs) -> one result per pair, called on the pow2
    query-length bins of `pairs` (length_bins), each bin split so that
    max_batch>0 caps a dispatch's pair count and max_batch_bytes its two
    (P, rows, band) float32 tensors.  Results in the order of `pairs`."""
    out: list = [None] * len(pairs)
    for rows, idxs in sorted(length_bins(pairs, min_rows=min_rows).items()):
        step = max_batch if max_batch > 0 else len(idxs)
        step = max(1, min(step, max_batch_bytes // (8 * rows * band)))
        for c in range(0, len(idxs), step):
            chunk = idxs[c:c + step]
            for i, r in zip(chunk, run([pairs[i] for i in chunk])):
                out[i] = r
    return out


def pack_to_device(pairs, band: int, dev, min_batch: int = 8,
                   min_rows: int = 256):
    """pack_band_batch of the pairs: (the numpy dict, its q, t_shift,
    m_len, n_len and lo on dev without the padding pairs)."""
    from .banded import _to_device, pack_band_batch
    packed = pack_band_batch(pairs, band, min_batch=min_batch,
                             min_rows=min_rows)
    t = _to_device(packed, len(pairs), dev)
    return packed, [t[k] for k in ("q", "t_shift", "m_len", "n_len", "lo")]


def banded_hits(post, pairs, lo, gamma: float):
    """(qpos, tpos, posterior) per pair from a (P, Mmax, B) posterior: each
    query row's first band argmax, kept where its posterior reaches gamma
    and it lands inside the target, in row order.  Rows past a pair's
    query and pairs past len(pairs) (batch padding) are never kept.  The
    band reduction runs on the device and only the (P, Mmax) rows leave
    it; the whole batch's hits are then chosen in one numpy pass over the
    pairs' rows and split by pair.  lo: the pairs' band offsets (numpy)."""
    best_b, pr = _row_argmax(post)
    del post
    rows = pr.shape[1]
    with span("cactus.fetch"):
        best_b = best_b.cpu().numpy().ravel()
        pr = pr.cpu().numpy().ravel()
    with span("cactus.unpack"):
        n = len(pairs)
        lens = np.fromiter((k for q, t in pairs for k in (len(q), len(t))),
                           np.int64, 2 * n).reshape(n, 2)
        m = lens[:, 0]
        p = np.repeat(np.arange(n), m)  # the pair of each query row
        i = np.arange(len(p)) - (np.cumsum(m) - m)[p]  # and its row
        flat = p * rows + i
        pv = pr[flat]
        tpos = i + np.asarray(lo[:n], np.int64)[p] + best_b[flat]
        keep = (pv >= gamma) & (tpos >= 0) & (tpos < lens[p, 1])
        hits = list(zip(i[keep].tolist(), tpos[keep].tolist(),
                        pv[keep].tolist()))
        counts = np.bincount(p[keep], minlength=n).tolist()
        return [hits[e - c:e] for e, c in zip(accumulate(counts), counts)]


def posterior_pairs_banded(pairs, params: HmmParams, band: int = 128,
                           gamma: float = 0.5, min_batch: int = 8,
                           min_rows_bin: int = 256, max_batch: int = 0,
                           max_batch_bytes: int = 1 << 30, device=None):
    """Aligned (qpos, tpos, posterior) per pair via the batched kernels.

    Pairs are dispatched in pow2 query-length bins (dispatch_by_length);
    max_batch>0 caps a dispatch's pair count, and max_batch_bytes caps
    its two (P, rows, band) float32 tensors.  A pair's hits do not
    depend on the rest of its batch.  The call from its emission table
    on is the span `cactus.posterior_pairs_banded`
    (cactus_tpu_torch/trace.py); each batch opens `cactus.pack` here and
    `cactus.fetch` and `cactus.unpack` in banded_hits."""
    if not pairs:
        return []
    from .pairhmm_cuda import pairhmm_route
    dev = resolve_device(device)

    def run(chunk):
        with span("cactus.pack"):
            packed, t = pack_to_device(chunk, band, dev, min_batch=min_batch,
                                       min_rows=min_rows_bin)
        # the wide route's widest live row, from the host lengths (the
        # narrow kernels take the band whole and need none)
        live = (max(min(band, len(tt) + 1) for _q, tt in chunk)
                if pairhmm_route(band) == "wide" else None)
        return banded_hits(
            posterior_banded_batch(*t, em, band=band, delta=params.delta,
                                   epsilon=params.epsilon, max_live=live),
            chunk, packed["lo"], gamma)

    with span("cactus.posterior_pairs_banded"):
        em = torch.from_numpy(params.emissions()).to(dev)
        return dispatch_by_length(pairs, band, run, min_rows=min_rows_bin,
                                  max_batch=max_batch,
                                  max_batch_bytes=max_batch_bytes)
