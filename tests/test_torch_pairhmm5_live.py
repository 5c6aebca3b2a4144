"""The 5-state pair-HMM kernels' live-window schedule, modelled on the CPU.

csrc/pairhmm5.cu computes each pair's rows 1..m over the row's live
window only: row i works on the cells k = 0 .. width(i) - 1 of the window
j = jlo(i) .. jhi(i), jlo(i) = max(0, i + lo), jhi(i) = min(n, i + lo +
B - 1), lane after lane C cells each, in as many warps as the launch's
max_live needs.  This file holds, with numpy inputs made from seeds:

(a) the fact that design rests on: the plain forward_banded5 and
    backward_posterior5 give exactly 0 in fM and post outside each row's
    live window (and past m), at several bands, lengths and offsets lo;
(b) a numpy float32 model of the kernels' schedule (`fwd_model`,
    `bwd_model`: lanes of C cells over the window, the 2x2 affine scan
    over lanes and warps, the every-row rescale, and with several warps
    the one-barrier form: a row is computed from the previous row before
    it is rescaled, which the next barrier brings; every rescale is a
    multiply by the reciprocal of the row maximum, as the kernels do it;
    with ncta, the wide route's cluster kernels: ncta CTAs of nw warps,
    each CTA's warp 0 scanning its warps' maps and walking the maps the
    CTAs before it pushed, the row maximum taken over every CTA) against
    the plain versions and the JAX package's posterior_banded_batch5, to
    POST_ULPS ulps of the largest log-scale sum (the tolerance of
    tests/test_torch_pairhmm5.py: the model sums the in-row chains in
    another order, multiplies by reciprocals where the plain version
    divides, and with several warps rescales a row by its own scale and
    the previous row's one after the other);
(c) max_live: below a pair's live width it raises on the CPU too, and
    posterior_pairs_banded5 passes max(min(band, n + 1)) from the host.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cactus_tpu.ops import banded as jb
from cactus_tpu.ops import pairhmm5 as j5
from cactus_tpu_torch.config import params_from_numpy
from cactus_tpu_torch.ops import pairhmm5 as t5
from cactus_tpu_torch.ops import pairhmm5_cuda
from test_torch_pairhmm import KEYS, _mutate, log_scale_ulp
from test_torch_pairhmm5 import POST_ULPS

F = np.float32
TINY = F(1e-30)


# ------------------------------------------------------------------ windows

def window(i, n, lo, B):
    """(jlo, width) of row i: the live columns j = jlo .. jlo + width - 1,
    width 0 when the row has none."""
    jlo = max(0, i + lo)
    jhi = min(n, i + lo + B - 1)
    return jlo, max(0, jhi - jlo + 1)


def live_band_mask(m, n, lo, M, B):
    """(M, B) bool: band cell (i, b) (row i at index i - 1) inside row i's
    live window, for rows 1..m."""
    out = np.zeros((M, B), bool)
    for i in range(1, min(m, M) + 1):
        jlo, w = window(i, n, lo, B)
        b0 = jlo - i - lo
        out[i - 1, b0:b0 + w] = True
    return out


# ------------------------------------------------------------ affine maps
# A map y -> [[a11, a12], [a21, a22]] y + (v1, v2) is a list of six
# float32 arrays; the operations are those of csrc/pairhmm5.cu, in its
# order, each float32 operation rounded (the kernel is built -fmad=false).

def aff_identity(shape):
    one, zero = np.ones(shape, F), np.zeros(shape, F)
    return [one, zero, zero, one, zero.copy(), zero.copy()]


def compose(L, E):
    """L after E."""
    return [L[0] * E[0] + L[1] * E[2], L[0] * E[1] + L[1] * E[3],
            L[2] * E[0] + L[3] * E[2], L[2] * E[1] + L[3] * E[3],
            (L[0] * E[4] + L[1] * E[5]) + L[4],
            (L[2] * E[4] + L[3] * E[5]) + L[5]]


def push_cell(a, A, c1, c2):
    """One chain cell y -> A y + c applied after the map a."""
    m11, m12, m21, m22 = A
    return [m11 * a[0] + m12 * a[2], m11 * a[1] + m12 * a[3],
            m21 * a[0] + m22 * a[2], m21 * a[1] + m22 * a[3],
            (m11 * a[4] + m12 * a[5]) + c1, (m21 * a[4] + m22 * a[5]) + c2]


def apply(T, y1, y2):
    return ((T[0] * y1 + T[1] * y2) + T[4], (T[2] * y1 + T[3] * y2) + T[5])


def where(mask, a, b):
    return [np.where(mask, x, y).astype(F) for x, y in zip(a, b)]


def shift_lanes(x, off, up):
    """The value of lane l - off (up) or l + off (down) along the lane axis
    (warp shuffles); lanes without one keep their own."""
    out = x.copy()
    if up:
        out[:, off:] = x[:, :-off]
    else:
        out[:, :-off] = x[:, off:]
    return out


def warp_scan(a, reverse):
    """Inclusive Kogge-Stone scan of the lanes' maps over each warp (maps
    of lower lanes apply first; reverse: of higher lanes) and the lane
    exclusive maps.  a: six (nw, 32) arrays."""
    lane = np.arange(32)[None, :]
    x = a
    for off in (1, 2, 4, 8, 16):
        o = [shift_lanes(v, off, up=not reverse) for v in x]
        has = lane + off < 32 if reverse else lane >= off
        x = where(has, compose(x, o), x)
    ex = [shift_lanes(v, 1, up=not reverse) for v in x]
    ex = where(lane == (31 if reverse else 0), aff_identity(ex[0].shape), ex)
    return x, ex


def cta_scan(maps, nw, reverse):
    """Warp 0's scan over a CTA's warps, as csrc/pairhmm5.cu cta_publish
    does it: lane w holds warp w's map (identity past nw), a shuffle scan
    over the 32 lanes.  maps: six (ncta, nw) arrays; returns the inclusive
    and exclusive maps, six (ncta, nw) arrays each."""
    ncta = maps[0].shape[0]
    lanes = [v.copy() for v in aff_identity((ncta, 32))]
    for v, m in zip(lanes, maps):
        v[:, :nw] = m
    inc, ex = warp_scan(lanes, reverse)
    return [v[:, :nw] for v in inc], [v[:, :nw] for v in ex]


def cta_walk(agg, near, ncta, reverse):
    """Warp 0's walk after the cluster barrier: for each CTA r, the chain
    value entering it (the CTA maps `agg` of the CTAs before it, or after
    it in reverse, applied to 0 one after the other) and the value that
    the neighbour CTA's map `near` gives (the previous CTA's last cell;
    reverse: the next CTA's second cell)."""
    y = [np.zeros(ncta, F), np.zeros(ncta, F)]
    nb = [np.zeros(ncta, F), np.zeros(ncta, F)]
    for r in range(ncta):
        y1, y2 = F(0), F(0)
        order = range(ncta - 1, r, -1) if reverse else range(r)
        for q in order:
            if q == (r + 1 if reverse else r - 1):
                nb[0][r], nb[1][r] = apply([v[q] for v in near], y1, y2)
            y1, y2 = apply([v[q] for v in agg], y1, y2)
        y[0][r], y[1][r] = y1, y2
    return y, nb


def fwd_chain(c1, c2, A, C, nw, ncta=None):
    """The forward in-row chain y[k] = A y[k-1] + c[k] (y[-1] = 0) over
    the cover's cells as the kernel schedules it.  With several warps a
    warp's first cell is pushed by the warp before it (its published map
    T~ ends with that cell) and replays as the carry itself.  ncta: the
    cluster kernels' schedule, ncta CTAs of nw warps (warp 0 of each CTA
    scans its warps' maps, and walks the CTAs before it).  Returns y1, y2
    (unmasked) and, for each warp w >= 1, the chain value at the last cell
    of warp w - 1, T_{w-1}(carry_{w-1}), which the kernel hands to warp w
    for the next row."""
    cl = ncta is not None
    nt = nw * (ncta or 1)              # warps in all
    multi = nt > 1
    g1, g2 = c1.reshape(nt, 32, C), c2.reshape(nt, 32, C)
    lane = np.arange(32)[None, :]
    warp = np.arange(nt)[:, None]
    skip = multi & (lane == 0) & (warp > 0)
    a = aff_identity((nt, 32))
    for c in range(C):
        pushed = push_cell(a, A, g1[:, :, c], g2[:, :, c])
        a = where(skip, a, pushed) if c == 0 else pushed
    x, ex = warp_scan(a, reverse=False)
    T = [v[:, 31] for v in x]
    carry = [np.zeros(nt, F), np.zeros(nt, F)]
    ylast = [np.zeros(nt, F), np.zeros(nt, F)]
    if multi or cl:
        # T~_w: T_w, then warp w + 1's first cell
        Tt = push_cell(T, A, np.append(g1[1:, 0, 0], F(0)),
                       np.append(g2[1:, 0, 0], F(0)))
    if cl:
        inc, pre = cta_scan([v.reshape(ncta, nw) for v in Tt], nw, False)
        near = compose([v.reshape(ncta, nw) for v in T], pre)
        y, ylc = cta_walk([v[:, -1] for v in inc], [v[:, -1] for v in near],
                          ncta, False)
        for e in range(2):
            carry[e] = apply(pre, y[0][:, None], y[1][:, None])[e].ravel()
            yl = apply(near, y[0][:, None], y[1][:, None])[e]
            # warp w's neighbour: warp w - 1's last cell; warp 0 of a CTA:
            # the previous CTA's last cell
            ylast[e] = np.concatenate([ylc[e][:, None], yl[:, :-1]],
                                      axis=1).ravel().astype(F)
    elif multi:
        y1, y2 = F(0), F(0)
        for w in range(1, nw):
            Tw = [v[w - 1] for v in T]
            Ttw = [v[w - 1] for v in Tt]
            ylast[0][w], ylast[1][w] = apply(Tw, y1, y2)
            y1, y2 = apply(Ttw, y1, y2)
            carry[0][w], carry[1][w] = y1, y2
    nw = nt
    y1, y2 = apply(ex, carry[0][:, None], carry[1][:, None])
    o1, o2 = np.zeros((nw, 32, C), F), np.zeros((nw, 32, C), F)
    for c in range(C):
        n1 = (A[0] * y1 + A[1] * y2) + g1[:, :, c]
        n2 = (A[2] * y1 + A[3] * y2) + g2[:, :, c]
        if c == 0:
            n1, n2 = np.where(skip, y1, n1), np.where(skip, y2, n2)
        y1, y2 = n1.astype(F), n2.astype(F)
        o1[:, :, c], o2[:, :, c] = y1, y2
    return o1.ravel(), o2.ravel(), ylast


def bwd_chain(c1, c2, At, C, nw, ncta=None):
    """The backward chain y[k] = A^T y[k+1] + c[k] (0 past the cover),
    lanes and warps from the right (ncta: the cluster kernels' schedule,
    as fwd_chain).  Returns y1, y2 (unmasked), yr1, yr2 (the chain at
    k + 1: the lane's carry at its last cell) and, for each warp w < nw -
    1, the chain at the second cell of warp w + 1, T'_{w+1}(carry_{w+1})
    (T' is the warp's map without its first cell), from which warp w
    forms that warp's first bM for the next row."""
    nt = nw * (ncta or 1)
    g1, g2 = c1.reshape(nt, 32, C), c2.reshape(nt, 32, C)
    a = aff_identity((nt, 32))
    a_rest = a
    for c in range(C - 1, -1, -1):
        if c == 0:
            a_rest = a
        a = push_cell(a, At, g1[:, :, c], g2[:, :, c])
    x, ex = warp_scan(a, reverse=True)
    T = [v[:, 0] for v in x]
    Tr = compose([v[:, 0] for v in a_rest], [v[:, 0] for v in ex])
    carry = [np.zeros(nt, F), np.zeros(nt, F)]
    ynext = [np.zeros(nt, F), np.zeros(nt, F)]
    if ncta is not None:
        inc, pre = cta_scan([v.reshape(ncta, nw) for v in T], nw, True)
        near = compose([v.reshape(ncta, nw) for v in Tr], pre)
        y, ync = cta_walk([v[:, 0] for v in inc], [v[:, 0] for v in near],
                          ncta, True)
        for e in range(2):
            carry[e] = apply(pre, y[0][:, None], y[1][:, None])[e].ravel()
            yn = apply(near, y[0][:, None], y[1][:, None])[e]
            # warp w's neighbour: warp w + 1's second cell; a CTA's last
            # warp: the next CTA's second cell
            ynext[e] = np.concatenate([yn[:, 1:], ync[e][:, None]],
                                      axis=1).ravel().astype(F)
    else:
        y1, y2 = F(0), F(0)
        for w in range(nw - 2, -1, -1):
            ynext[0][w], ynext[1][w] = apply([v[w + 1] for v in Tr], y1, y2)
            y1, y2 = apply([v[w + 1] for v in T], y1, y2)
            carry[0][w], carry[1][w] = y1, y2
    nw = nt
    y1, y2 = apply(ex, carry[0][:, None], carry[1][:, None])
    o1, o2 = np.zeros((nw, 32, C), F), np.zeros((nw, 32, C), F)
    r1, r2 = np.zeros((nw, 32, C), F), np.zeros((nw, 32, C), F)
    for c in range(C - 1, -1, -1):
        r1[:, :, c], r2[:, :, c] = y1, y2
        n1 = (At[0] * y1 + At[1] * y2) + g1[:, :, c]
        n2 = (At[2] * y1 + At[3] * y2) + g2[:, :, c]
        y1, y2 = n1.astype(F), n2.astype(F)
        o1[:, :, c], o2[:, :, c] = y1, y2
    return o1.ravel(), o2.ravel(), r1.ravel(), r2.ravel(), ynext


def gather(x, idx):
    ok = (idx >= 0) & (idx < len(x))
    return np.where(ok, x[np.clip(idx, 0, len(x) - 1)], F(0)).astype(F)


def _trans(params):
    return [F(v) for v in params.transitions()]


# ------------------------------------------------------------ forward model

def fwd_model(q, ts, m, n, lo, em, B, params, C, nw, ncta=None):
    """One pair's forward pass as csrc/pairhmm5.cu schedules it: (fM (M,
    B), lsF (M,), logZ).  One warp: each row divided by its own maximum
    before the next row reads it (the contract's order).  Several warps,
    or a cluster of ncta CTAs of nw warps: row i is computed from row
    i - 1 as it stood before its rescale, and divided by row i - 1's scale
    (its maximum over every warp and CTA) after the row's exchange; row
    i - 1 is stored then."""
    mc, os_, ol, es, el, wsl, wls, ms, ml = _trans(params)
    A = (es, wls, wsl, el)
    M = len(q)
    m = min(m, M)
    nt = nw * (ncta or 1)
    multi = nt > 1 or ncta is not None
    cover = 32 * C * nt
    k = np.arange(cover)
    k0w = 32 * C * np.arange(nt)
    fM = np.zeros((M, B), F)
    lsF = np.zeros(M, F)
    logZ = None
    end_row = max(m, 1)
    ls = F(0)

    # row 0: M at j == 0, the SY/LY chains it seeds
    jl, wd = window(0, n, lo, B)
    okx = k < wd
    ok = okx & (jl + k >= 1)
    sM = np.where(okx & (jl + k == 0), F(1), F(0)).astype(F)
    left = gather(sM, k - 1)
    y1, y2, ylast = fwd_chain(np.where(ok, os_ * left, F(0)).astype(F),
                              np.where(ok, ol * left, F(0)).astype(F),
                              A, C, nw, ncta)
    S = [sM, np.zeros(cover, F), np.zeros(cover, F),
         np.where(ok, y1, F(0)).astype(F), np.where(ok, y2, F(0)).astype(F)]
    if ncta is None:
        # row 1 reads row 0's cells across warps as stored (after a
        # barrier)
        nbl = [gather(S[3], k0w - 1), gather(S[4], k0w - 1)]
    else:
        # the cluster kernels run row 0 as any row: the cells across a
        # warp edge come from the exchange
        nbl = [np.where(gather(ok.astype(F), k0w - 1) > 0, v, F(0))
               .astype(F) for v in ylast]
    s_prev = F(1)          # several warps: the scale row i - 1 awaits

    def store(i, vals, s, jl_, wd_):
        """Row i's fM (its live cells) after its rescale by s, its lsF,
        and logZ at the end row."""
        nonlocal ls, logZ
        f = [v * (F(1) / s) for v in vals]
        ls = F(ls + np.log(s))
        b = jl_ + k - i - lo
        live = k < wd_
        fM[i - 1, b[live]] = f[0][live]
        lsF[i - 1] = ls
        if i == end_row:
            ke = n - jl_
            s_end = F(0)
            if 0 <= ke < wd_:
                s_end = f[0][ke] + (((f[1][ke] + f[2][ke]) + f[3][ke])
                                    + f[4][ke])
            logZ = F(np.log(max(s_end, TINY)) + ls)

    for i in range(1, m + 1):
        jlp, wdp = jl, wd
        jl, wd = window(i, n, lo, B)
        delta = jl - jlp
        pk, qk = k - 1 + delta, k + delta
        fm, fsx, flx, fsy, fly = (gather(v, pk) for v in S)
        if multi and delta == 0:
            # a warp's first cell reads the last SY/LY cell of the warp
            # before it from that warp's carry
            fsy[k0w[1:]] = nbl[0][1:]
            fly[k0w[1:]] = nbl[1][1:]
        fmu, fsxu, flxu = (gather(v, qk) for v in S[:3])
        okx = k < wd
        ok = okx & (jl + k >= 1)
        b = jl + k - i - lo
        emit = np.zeros(cover, F)
        emit[okx] = em[q[i - 1], ts[i - 1 + b[okx]]]
        mM = np.where(ok, emit * ((mc * fm + ms * (fsx + fsy))
                                  + ml * (flx + fly)), F(0)).astype(F)
        mSX = np.where(okx, (os_ * fmu + es * fsxu) + wls * flxu,
                       F(0)).astype(F)
        mLX = np.where(okx, (ol * fmu + el * flxu) + wsl * fsxu,
                       F(0)).astype(F)
        left = gather(mM, k - 1)
        y1, y2, ylast = fwd_chain(np.where(ok, os_ * left, F(0)).astype(F),
                                  np.where(ok, ol * left, F(0)).astype(F),
                                  A, C, nw, ncta)
        V = [mM, mSX, mLX, np.where(ok, y1, F(0)).astype(F),
             np.where(ok, y2, F(0)).astype(F)]
        nbl = [np.where(gather(ok.astype(F), k0w - 1) > 0, v, F(0))
               .astype(F) for v in ylast]
        if multi:
            if i >= 2:
                store(i - 1, S, s_prev, jlp, wdp)
                V = [v * (F(1) / s_prev) for v in V]
                nbl = [v * (F(1) / s_prev) for v in nbl]
            tot = (((V[0] + V[1]) + V[2]) + V[3]) + V[4]
            s_prev = F(max(tot.max(), TINY))
            S = V
        else:
            tot = (((V[0] + V[1]) + V[2]) + V[3]) + V[4]
            s = F(max(tot.max(), TINY))
            S = [v * (F(1) / s) for v in V]
            store(i, V, s, jl, wd)
    if multi and m >= 1:
        store(m, S, s_prev, jl, wd)
    for i in range(m + 1, M + 1):
        ls = F(ls + np.log(TINY))
        lsF[i - 1] = ls
        if i == end_row:
            logZ = F(np.log(TINY) + ls)
    return fM, lsF, logZ


# ----------------------------------------------------------- backward model

def bwd_model(fM, lsF, logZ, q, ts, m, n, lo, em, B, params, C, nw,
              ncta=None):
    """One pair's backward pass fused with the posterior, as
    csrc/pairhmm5.cu schedules it: post (M, B).  Several warps, or a
    cluster of ncta CTAs: row i - 1 is computed from row i before its
    rescale, divided by row i's scale after the exchange, and row i's
    posterior is formed then."""
    mc, os_, ol, es, el, wsl, wls, ms, ml = _trans(params)
    At = (es, wsl, wls, el)
    M = len(q)
    nt = nw * (ncta or 1)
    multi = nt > 1 or ncta is not None
    cover = 32 * C * nt
    k = np.arange(cover)
    k0w = 32 * C * np.arange(nt)
    post = np.zeros((M, B), F)
    if m < 1 or m > M:
        return post
    lz = F(logZ)
    ls = F(0)

    # terminal row m: the Y-gap chains ty = A^T ty[k+1] + (1, 1)[j == n]
    jl, wd = window(m, n, lo, B)
    okc = k < wd
    at_end = okc & (jl + k == n)
    c = np.where(at_end, F(1), F(0)).astype(F)
    _y1, _y2, r1, r2, ynext = bwd_chain(c, c, At, C, nw, ncta)
    okr = gather(okc.astype(F), k + 1) > 0
    bM = np.where(at_end, F(1), np.where(
        okc & okr, os_ * r1 + ol * r2, F(0))).astype(F)
    S = [bM, c, c.copy()]
    x = k0w + 32 * C
    if ncta is None:
        # row m - 1 reads the next warp's first bM as stored (after a
        # barrier)
        nbr = gather(bM, x)
    else:
        # the cluster kernels form it as any row's, from the next warp's
        # first cell and the chain at its second cell
        okx = (gather(okc.astype(F), x) > 0) & \
            (gather(okc.astype(F), x + 1) > 0)
        nbr = np.where(gather(c, x) != 0, F(1), np.where(
            okx, os_ * ynext[0] + ol * ynext[1], F(0))).astype(F)

    def posterior(i, bm, g_ls, jl_, wd_):
        g = F(np.exp(np.clip(F(F(lsF[i - 1] + g_ls) - lz), -60, 60)))
        b = jl_ + k - i - lo
        live = k < wd_
        v = (fM[i - 1, b[live]] * bm[live]) * g
        post[i - 1, b[live]] = np.clip(v, F(0), F(1.5))

    s_row = F(1)           # several warps: the scale row i awaits
    for i in range(m, 1, -1):
        if not multi:
            posterior(i, S[0], ls, jl, wd)
        jli, wdi = jl, wd
        jl, wd = window(i - 1, n, lo, B)
        delta = jli - jl
        okp = k < wd
        jprev = jl + k
        b = jl + k - (i - 1) - lo
        emit = np.zeros(cover, F)
        emit[okp] = em[q[i - 1], ts[i - 1 + b[okp]]]
        mmv = gather(S[0], k + 1 - delta)
        if multi and delta == 0:
            mmv[k0w[:-1] + 32 * C - 1] = nbr[:-1]
        mm = np.where(okp & (jprev + 1 <= n), emit * mmv, F(0)).astype(F)
        sx = np.where(okp, gather(S[1], k - delta), F(0)).astype(F)
        lx = np.where(okp, gather(S[2], k - delta), F(0)).astype(F)
        nSX = (ms * mm + es * sx) + wsl * lx
        nLX = (ml * mm + el * lx) + wls * sx
        c1, c2 = (ms * mm).astype(F), (ml * mm).astype(F)
        y1, y2, r1, r2, ynext = bwd_chain(c1, c2, At, C, nw, ncta)
        nM = (mc * mm + os_ * (sx + r1)) + ol * (lx + r2)
        V = [np.where(okp, v, F(0)).astype(F)
             for v in (nM, nSX, nLX, y1, y2)]
        # the next warp's first bM, from its pass-1 values and T'
        x = k0w + 32 * C
        okx1 = gather(okp.astype(F), x)
        nbr = np.where(okx1 > 0, (mc * gather(mm, x) + os_ * (
            gather(sx, x) + ynext[0])) + ol * (gather(lx, x) + ynext[1]),
            F(0)).astype(F)
        if multi:
            if i < m:
                ls = F(ls + np.log(s_row))
                bm_i = S[0] * (F(1) / s_row)
                V = [v * (F(1) / s_row) for v in V]
                nbr = nbr * (F(1) / s_row)
            else:
                bm_i = S[0]
            posterior(i, bm_i, ls, jli, wdi)
            tot = (((V[0] + V[1]) + V[2]) + V[3]) + V[4]
            s_row = F(max(tot.max(), TINY))
            S = V[:3]
        else:
            tot = (((V[0] + V[1]) + V[2]) + V[3]) + V[4]
            s = F(max(tot.max(), TINY))
            S = [v * (F(1) / s) for v in V[:3]]
            ls = F(ls + np.log(s))
    if multi and m >= 2:
        ls = F(ls + np.log(s_row))
        posterior(1, S[0] * (F(1) / s_row), ls, jl, wd)
    else:
        posterior(1, S[0], ls, jl, wd)
    return post


def model_batch(packed, band, params, C, nw, ncta=None):
    """fwd_model and bwd_model over a packed batch: (fM, lsF, logZ,
    post) as numpy arrays of the plain versions' shapes."""
    em = params.emissions().astype(F)
    P, M = packed["q"].shape
    fM = np.zeros((P, M, band), F)
    lsF = np.zeros((P, M), F)
    logZ = np.zeros(P, F)
    post = np.zeros((P, M, band), F)
    for p in range(P):
        a = (packed["q"][p], packed["t_shift"][p], int(packed["m_len"][p]),
             int(packed["n_len"][p]), int(packed["lo"][p]), em, band,
             params, C, nw)
        fM[p], lsF[p], logZ[p] = fwd_model(*a, ncta=ncta)
        post[p] = bwd_model(fM[p], lsF[p], logZ[p], *a, ncta=ncta)
    return fM, lsF, logZ, post


# ------------------------------------------------------------------ inputs

def _pairs(seed, n, lo_len, hi_len, band):
    """Homologous ragged pairs whose length difference fits the band, an
    unrelated pair, and the edge cases m = 0, n = 0 and m = 1."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < n:
        q = rng.integers(0, 4, int(rng.integers(lo_len, hi_len))) \
            .astype(np.uint8)
        t = _mutate(rng, q)
        if abs(len(t) - len(q)) < band // 2:
            pairs.append((q, t))
    codes = lambda k: rng.integers(0, 4, k).astype(np.uint8)  # noqa: E731
    return pairs + [(codes(min(40, band // 2)), codes(min(37, band // 2))),
                    (codes(0), codes(min(5, band - 1))), (codes(3), codes(0)),
                    (codes(1), codes(min(2, band - 1)))]


def _params(p_match=0.8):
    jparams = j5.Hmm5Params(p_match=p_match)
    return jparams, params_from_numpy(t5.Hmm5Params,
                                      dataclasses.asdict(jparams))


def _plain(packed, band, params):
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(params.emissions())
    fM, lsF, logZ = t5.forward_banded5(*targs, em, band=band, params=params)
    post = t5.backward_posterior5(fM, lsF, logZ, *targs, em, band=band,
                                  params=params)
    return fM.numpy(), lsF.numpy(), logZ.numpy(), post.numpy()


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("band,shift", [(16, 0), (64, 0), (64, -5),
                                        (128, 3), (256, 0)])
def test_plain_is_zero_outside_the_live_window(band, shift):
    pairs = _pairs(band + 7, 5, 1, 3 * band // 2, band)
    packed = jb.pack_band_batch(pairs, band)
    # any offset: the zeros outside the window hold for every lo
    lo = packed["lo"].copy()
    if shift:
        lo = np.clip(lo + shift, -band + 1, None).astype(np.int32)
        packed = dict(packed, lo=lo)
    _params_j, params = _params()
    fM, _lsF, _logZ, post = _plain(packed, band, params)
    P, M = packed["q"].shape
    checked = 0
    for p in range(P):
        live = live_band_mask(int(packed["m_len"][p]),
                              int(packed["n_len"][p]), int(lo[p]), M, band)
        assert not fM[p][~live].any() and not post[p][~live].any()
        checked += int((fM[p][live] > 0).sum())
    assert checked > 0


# --------------------------------------------------------------------- (b)

def _case(band, C, nw, max_len, ncta=None):
    name = f"{band}-{C}-{nw}-{max_len}"
    return pytest.param(band, C, nw, max_len, ncta,
                        id=name if ncta is None else f"{name}-cta{ncta}")


@pytest.mark.parametrize("band,C,nw,max_len,ncta", [
    _case(64, 4, 1, 90),       # one warp, 128 cells: window <= 64
    _case(128, 8, 1, 200),     # one warp, 256 cells
    _case(256, 4, 2, 300),     # two warps of 4 cells a lane
    _case(256, 4, 3, 300),     # three warps, the middle one's carries
    _case(512, 4, 4, 300),     # four warps, short pairs in a wide band
    # the cluster kernels: ncta CTAs of nw warps
    _case(256, 4, 1, 300, 2),   # 2 CTAs of one warp, windows past CTA 0
    _case(512, 4, 2, 300, 2),   # 2 CTAs of two warps
    _case(512, 8, 1, 300, 2),   # 8 cells a lane, as the kernels take
    _case(384, 4, 1, 300, 3),   # 3 CTAs: the last one idle
    _case(768, 4, 2, 300, 3),   # 3 CTAs of two warps, the last idle
    _case(1024, 4, 2, 250, 3),  # every window inside CTA 0
])
def test_schedule_model_matches_plain_and_jax(band, C, nw, max_len, ncta):
    pairs = _pairs(band + C + nw, 4, 1, max_len, band)
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    widest = max(min(band, len(t) + 1) for _q, t in pairs)
    assert widest <= 32 * C * nw * (ncta or 1)
    jparams, params = _params()
    fM_r, lsF_r, logZ_r, post_r = _plain(packed, band, params)
    fM, lsF, logZ, post = model_batch(packed, band, params, C, nw, ncta)
    tol = POST_ULPS * log_scale_ulp(lsF_r, logZ_r, packed)
    assert float(np.abs(post - post_r).max()) <= tol
    assert float(np.abs(lsF - lsF_r).max()) <= tol
    assert float(np.abs(logZ - logZ_r).max()) <= tol
    # fM: zero outside the live windows; in log space the values agree
    # where the plain fM is above 1e-30 (below it float32 subnormals
    # round the two differently)
    P, M = packed["q"].shape
    for p in range(P):
        live = live_band_mask(int(packed["m_len"][p]),
                              int(packed["n_len"][p]), int(packed["lo"][p]),
                              M, band)
        assert not fM[p][~live].any() and not post[p][~live].any()
    big = fM_r > 1e-30
    gap = np.abs((np.log(fM[big]) + np.repeat(lsF, band).reshape(fM.shape)
                  [big]) - (np.log(fM_r[big]) + np.repeat(
                      lsF_r, band).reshape(fM.shape)[big]))
    assert float(gap.max()) <= tol
    ref = np.asarray(j5.posterior_banded_batch5(
        *[packed[k] for k in KEYS], jparams.emissions(), band=band,
        params=jparams))
    assert float(np.abs(post - ref).max()) <= tol
    assert post.max() > 0.9


def test_schedule_model_several_warps_see_the_whole_window():
    """A pair whose window spans the boundary of every warp, with the band
    left of j = 0 for its first rows and the end cell inside the last
    warp: three warps of 4 cells a lane against one warp of 16."""
    band = 512
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 330).astype(np.uint8)
    pairs = [(q, _mutate(rng, q)), (q[:200], q[:190])]
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    _j, params = _params()
    one = model_batch(packed, band, params, 16, 1)
    three = model_batch(packed, band, params, 4, 3)
    ref = _plain(packed, band, params)
    tol = POST_ULPS * log_scale_ulp(ref[1], ref[2], packed)
    for got in (one, three):
        assert float(np.abs(got[3] - ref[3]).max()) <= tol
        assert float(np.abs(got[2] - ref[2]).max()) <= tol


@pytest.mark.parametrize("C,nw,ncta", [(4, 1, 3), (4, 2, 2), (2, 3, 2)])
def test_schedule_model_clusters_see_the_whole_window(C, nw, ncta):
    """The cluster schedule on pairs whose windows cross every CTA edge
    (and, with 3 CTAs of one warp, every warp edge is one): the carries,
    the neighbour cells across a CTA edge and the row maximum taken over
    the CTAs.  Rows whose largest match value lies past CTA 0 are there,
    so the deferred maximum comes from another CTA."""
    band = 512
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 330).astype(np.uint8)
    pairs = [(q, _mutate(rng, q)), (q[:200], q[:190])]
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    per_cta = 32 * C * nw
    assert per_cta * (ncta - 1) < len(pairs[0][1]) + 1 <= per_cta * ncta
    _j, params = _params()
    got = model_batch(packed, band, params, C, nw, ncta)
    ref = _plain(packed, band, params)
    m, lo = int(packed["m_len"][0]), int(packed["lo"][0])
    rows = np.arange(1, m + 1)
    cta_of_max = (ref[0][0, :m].argmax(1) + rows + lo
                  - np.maximum(0, rows + lo)) // per_cta
    assert (cta_of_max > 0).sum() > 10
    tol = POST_ULPS * log_scale_ulp(ref[1], ref[2], packed)
    assert float(np.abs(got[3] - ref[3]).max()) <= tol
    assert float(np.abs(got[2] - ref[2]).max()) <= tol
    used = np.arange(1, got[1].shape[1] + 1)[None, :] <= \
        packed["m_len"][:, None]
    assert float(np.abs(got[1] - ref[1])[used].max()) <= tol
    assert got[3].max() > 0.9


def test_schedule_model_rows_past_m_and_empty_windows():
    """m = 0 (every row past m, logZ from TINY), n = 0, a band left of
    j = 0 for the first 39 rows (empty windows, rescaled by TINY), and a
    window that grows from j = 0 with the band's right edge inside the
    matrix: fM, lsF, logZ and post as the plain versions give them (each
    end cell (m, n) inside the band, as the contract needs)."""
    band = 32
    _j, params = _params()
    em = params.emissions().astype(F)
    for m, n, lo in ((0, 5, -3), (6, 0, -6), (40, 0, -71), (12, 10, -31)):
        M = 64
        q = np.zeros(M, np.uint8)
        ts = np.full(M + band, 2, np.uint8)
        packed = dict(q=q[None], t_shift=ts[None],
                      m_len=np.array([m], np.int32),
                      n_len=np.array([n], np.int32),
                      lo=np.array([lo], np.int32))
        ref = _plain(packed, band, params)
        for C, nw in ((4, 1), (4, 2)):
            fM, lsF, logZ = fwd_model(q, ts, m, n, lo, em, band, params, C,
                                      nw)
            post = bwd_model(fM, lsF, logZ, q, ts, m, n, lo, em, band,
                             params, C, nw)
            tol = POST_ULPS * log_scale_ulp(ref[1], ref[2], packed)
            np.testing.assert_allclose(lsF, ref[1][0], rtol=0, atol=tol)
            np.testing.assert_allclose(logZ, ref[2][0], rtol=0, atol=tol)
            np.testing.assert_allclose(fM, ref[0][0], rtol=1e-5, atol=1e-30)
            np.testing.assert_allclose(post, ref[3][0], atol=1e-5)


@pytest.mark.parametrize("C,nw,ncta", [(1, 1, 2), (1, 1, 3), (1, 2, 2)])
def test_schedule_model_cluster_rows_past_m_and_empty_windows(C, nw, ncta):
    """The cases of test_schedule_model_rows_past_m_and_empty_windows at
    band 64 (m = 0, n = 0, windows empty for the first rows, a window that
    grows from j = 0), and a pair whose windows cross a CTA edge, through
    the cluster schedule of CTAs of 32 or 64 cells: every CTA takes part
    in each row's exchange, idle or not."""
    band = 64
    _j, params = _params()
    em = params.emissions().astype(F)
    for m, n, lo in ((0, 5, -3), (6, 0, -6), (40, 0, -71), (12, 10, -31),
                     (50, 60, -30)):
        M = 64
        rng = np.random.default_rng(m + n)
        q = rng.integers(0, 4, M).astype(np.uint8)
        ts = rng.integers(0, 4, M + band).astype(np.uint8)
        packed = dict(q=q[None], t_shift=ts[None],
                      m_len=np.array([m], np.int32),
                      n_len=np.array([n], np.int32),
                      lo=np.array([lo], np.int32))
        ref = _plain(packed, band, params)
        fM, lsF, logZ = fwd_model(q, ts, m, n, lo, em, band, params, C, nw,
                                  ncta)
        post = bwd_model(fM, lsF, logZ, q, ts, m, n, lo, em, band, params,
                         C, nw, ncta)
        tol = POST_ULPS * log_scale_ulp(ref[1], ref[2], packed)
        np.testing.assert_allclose(lsF, ref[1][0], rtol=0, atol=tol)
        np.testing.assert_allclose(logZ, ref[2][0], rtol=0, atol=tol)
        np.testing.assert_allclose(fM, ref[0][0], rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(post, ref[3][0], atol=1e-5)


# --------------------------------------------------------------------- (c)

def test_max_live_checked_on_the_cpu():
    band = 64
    pairs = _pairs(3, 4, 1, 40, band)
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    _j, params = _params()
    em = torch.from_numpy(params.emissions())
    widest = max(min(band, len(t) + 1) for _q, t in pairs)
    kw = dict(band=band, params=params)
    ref = pairhmm5_cuda.pairhmm5_fwd(*targs, em, **kw)
    for ok in (widest, band, band + 9, None):
        got = pairhmm5_cuda.pairhmm5_fwd(*targs, em, **kw, max_live=ok)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for bad in (widest - 1, 0):
        with pytest.raises(ValueError, match="max_live"):
            pairhmm5_cuda.pairhmm5_fwd(*targs, em, **kw, max_live=bad)
        with pytest.raises(ValueError, match="max_live"):
            pairhmm5_cuda.pairhmm5_bwd(*ref, *targs, em, **kw, max_live=bad)
        with pytest.raises(ValueError, match="max_live"):
            t5.posterior_banded_batch5(*targs, em, **kw, max_live=bad)


def test_posterior_pairs_passes_the_host_max_live(monkeypatch):
    band = 128
    pairs = _pairs(9, 6, 1, 300, band)
    seen = []
    real = t5.posterior_banded_batch5

    def spy(*a, **kw):
        seen.append((int(a[3].max()), kw["max_live"]))
        return real(*a, **kw)

    monkeypatch.setattr(t5, "posterior_banded_batch5", spy)
    _j, params = _params()
    got = t5.posterior_pairs_banded5(pairs, params, band=band, device="cpu")
    assert len(got) == len(pairs) and seen
    for n_max, live in seen:
        assert live == min(band, n_max + 1)
