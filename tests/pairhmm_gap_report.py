"""Where the port's plain pair-HMM and the JAX package's part ways (CPU).

    JAX_PLATFORMS=cpu python tests/pairhmm_gap_report.py

Both packages evaluate the same float32 operations in the same order
(cactus_tpu/ops/pairhmm.py::posterior_banded_batch against
cactus_tpu_torch/ops/pairhmm.py::forward_banded/backward_posterior), yet
their posteriors differ by a few 1e-5.  This script prints the readings
that locate the difference:

1. the first values that differ: the forward's initial Y row, d * e**k,
   where XLA's pow and ATen's pow round differently;
2. one row update, mM = emit * (tMM*fM + (1-e)*(fX+fY)), evaluated by
   the port from XLA's own previous row: every cell that differs equals
   XLA's value once tMM*fM + ... is taken as one fused multiply-add,
   which XLA's CPU code generator forms and ATen does not;
3. how often XLA's log and exp differ from ATen's on the same float32
   arguments (by one ulp);
4. the posterior gap, in ulps of the largest per-row log-scale sum: the
   posterior is fM*bM*exp(lsF + lsB - logZ), and any one-ulp change in a
   summand can flip the rounding of those running float32 sums;
5. the same gap for the 5-state machine, on the inputs of
   tests/test_torch_pairhmm5.py (these pairs and a 30 bp deletion)
   (cactus_tpu/ops/pairhmm5.py::posterior_banded_batch5 against
   cactus_tpu_torch/ops/pairhmm5.py::forward_banded5/backward_posterior5);
6. the port's 5-state passes with degenerate parameters (no long gaps, no
   switches) against its 3-state passes, in the same ulps.

It imports both packages, as the tests do.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cactus_tpu.ops import banded as jb  # noqa: E402
from cactus_tpu.ops import pairhmm as jp  # noqa: E402
from cactus_tpu.ops import pairhmm5 as j5  # noqa: E402
from cactus_tpu_torch.ops import pairhmm as tp  # noqa: E402
from cactus_tpu_torch.ops import pairhmm5 as t5  # noqa: E402
from test_torch_pairhmm import KEYS, _pairs, log_scale_ulp  # noqa: E402
from test_torch_pairhmm5 import _pairs as _pairs5  # noqa: E402


@partial(jax.jit, static_argnames=("band", "delta", "epsilon"))
def xla_forward_rows(q, t_shift, m_len, n_len, lo, em, band, delta,
                     epsilon):
    """The forward half of cactus_tpu's posterior_banded_batch
    (pairhmm.py:160-188), returning its initial Y row and, per row, the
    unscaled mM and the rescaled state."""
    P, _Mmax = q.shape
    B = band
    d, e = delta, epsilon
    tMM = 1.0 - 2.0 * d
    b_idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    lo_c = lo[:, None].astype(jnp.int32)
    m_c = m_len[:, None].astype(jnp.int32)
    n_c = n_len[:, None].astype(jnp.int32)

    def sl(x):
        return jnp.concatenate([x[:, 1:], jnp.zeros((P, 1), x.dtype)], 1)

    def sr(x):
        return jnp.concatenate([jnp.zeros((P, 1), x.dtype), x[:, :-1]], 1)

    j0 = lo_c + b_idx
    fM0 = jnp.where(j0 == 0, 1.0, 0.0).astype(jnp.float32)
    fY0 = jnp.where((j0 >= 1) & (j0 <= n_c),
                    d * e ** jnp.maximum(j0 - 1, 0), 0.0).astype(jnp.float32)

    def step(carry, i):
        fM, fX, fY, ls = carry
        qc = jax.lax.dynamic_slice_in_dim(q, i - 1, 1, axis=1)
        tc = jax.lax.dynamic_slice_in_dim(t_shift, i - 1, B, axis=1)
        emit = em[qc.astype(jnp.int32), tc.astype(jnp.int32)]
        j = i + lo_c + b_idx
        ok = (j >= 1) & (j <= n_c) & (i <= m_c)
        mM = jnp.where(ok, emit * (tMM * fM + (1 - e) * (fX + fY)), 0.0)
        mX = d * sl(fM) + e * sl(fX)
        mX = jnp.where((j >= 0) & (j <= n_c) & (i <= m_c), mX, 0.0)
        mY = jnp.where(ok, jp._chain_fwd(d * sr(mM), e, P, B), 0.0)
        scale = jnp.maximum(jnp.max(mM + mX + mY, axis=1, keepdims=True),
                            jp.TINY)
        nM, nX, nY = mM / scale, mX / scale, mY / scale
        ls = ls + jnp.log(scale[:, 0])
        return (nM, nX, nY, ls), (mM, nM, nX, nY, scale[:, 0])

    init = (fM0, jnp.zeros((P, B), jnp.float32), fY0,
            jnp.zeros(P, jnp.float32))
    _last, rows = jax.lax.scan(step, init, jnp.arange(1, q.shape[1] + 1))
    return fY0, rows


def _ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def main() -> None:
    band = 256
    p = jp.HmmParams()
    em = p.emissions()
    pairs = _pairs(band, 7, 300)
    packed = jb.pack_band_batch(pairs, band)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fY0_x, rows = xla_forward_rows(*[jnp.asarray(packed[k]) for k in KEYS],
                                   jnp.asarray(em), **kw)
    fY0_x = np.asarray(fY0_x)
    mM_x, nM_x, nX_x, nY_x, scale_x = (np.asarray(r) for r in rows)

    # 1. the initial Y row, d * e**k
    lo_c, n_c, m_c = (packed[k][:, None] for k in ("lo", "n_len", "m_len"))
    j0 = lo_c + np.arange(band)[None, :]
    k = torch.from_numpy(np.maximum(j0 - 1, 0).astype(np.int32))
    fY0_t = torch.where(torch.from_numpy((j0 >= 1) & (j0 <= n_c)),
                        p.delta * tp._epow(p.epsilon, k, "cpu"),
                        0.0).to(torch.float32).numpy()
    n = int((fY0_t != fY0_x).sum())
    print(f"1. initial Y row d*e**k: {n} of {fY0_x.size} values differ "
          f"(max {_ulps(fY0_t, fY0_x)} ulp); XLA pow vs ATen pow")

    # 2. row 2's mM from XLA's own row-1 state
    i = 2
    fM, fX, fY = nM_x[0], nX_x[0], nY_x[0]
    q = packed["q"].astype(np.int64)
    t = packed["t_shift"].astype(np.int64)
    emit = em[q[:, i - 1:i], t[:, i - 1:i - 1 + band]]
    j = i + j0
    ok = (j >= 1) & (j <= n_c) & (i <= m_c)
    tMM, oe = 1.0 - 2.0 * p.delta, 1 - p.epsilon
    ft = [torch.from_numpy(x) for x in (fM, fX, fY, emit)]
    mM_t = torch.where(torch.from_numpy(ok), ft[3] * (
        tMM * ft[0] + oe * (ft[1] + ft[2])), 0.0).numpy()
    addend = (np.float32(oe) * (fX + fY)).astype(np.float32)
    fused = (np.float64(np.float32(tMM)) * fM.astype(np.float64)
             + addend.astype(np.float64)).astype(np.float32)
    mM_fma = np.where(ok, (emit * fused).astype(np.float32), np.float32(0))
    differ = mM_t != mM_x[i - 1]
    print(f"2. row {i} mM from XLA's row {i - 1}: {int(differ.sum())} of "
          f"{differ.size} cells differ (max {_ulps(mM_t, mM_x[i - 1])} ulp); "
          f"with tMM*fM+(1-e)*(fX+fY) as one fused multiply-add, "
          f"{int((mM_fma != mM_x[i - 1]).sum())} differ")

    # 3. log and exp on the same float32 arguments
    sc = scale_x.reshape(-1)
    lx = np.asarray(jax.jit(jnp.log)(jnp.asarray(sc)))
    lt = torch.log(torch.from_numpy(sc)).numpy()
    print(f"3. log of XLA's {sc.size} row scales: {int((lx != lt).sum())} "
          f"differ (max {_ulps(lx, lt)} ulp)")
    x = np.random.default_rng(0).uniform(-60, 60, 1_000_000).astype(
        np.float32)
    ex = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    et = torch.exp(torch.from_numpy(x)).numpy()
    print(f"   exp of 1e6 arguments in [-60, 60]: "
          f"{float((ex != et).mean()):.2%} differ (max {_ulps(ex, et)} ulp)")

    # 4. the posterior gap in ulps of the largest log-scale sum
    emt = torch.from_numpy(em)
    for max_len in (300, 40):
        for band in (128, 256):
            worst, worst_abs = 0.0, 0.0
            for seed in range(12):
                pk = jb.pack_band_batch(_pairs(seed * 7 + band, 7, max_len),
                                        band)
                kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
                ref = np.asarray(jp.posterior_banded_batch(
                    *[pk[k] for k in KEYS], em, **kw))
                targs = [torch.from_numpy(pk[k]) for k in KEYS]
                fM_t, lsF, logZ = tp.forward_banded(*targs, emt, **kw)
                got = tp.backward_posterior(fM_t, lsF, logZ, *targs, emt,
                                            **kw).numpy()
                gap = float(np.abs(got - ref).max())
                worst_abs = max(worst_abs, gap)
                worst = max(worst, gap / log_scale_ulp(lsF, logZ, pk))
            print(f"4. pairs < {max_len} bp, band {band}, 12 seeds: "
                  f"posterior max |diff| {worst_abs:.3g}, at most "
                  f"{worst:.2f} ulp of the largest log-scale sum")

    # 5. the 5-state posterior gap, same measure
    p5 = t5.Hmm5Params()
    em5 = p5.emissions()
    em5t = torch.from_numpy(em5)
    for max_len in (300, 40):
        for band in (128, 256):
            worst, worst_abs = 0.0, 0.0
            for seed in range(12):
                pk = jb.pack_band_batch(_pairs5(seed * 7 + band, 7, max_len),
                                        band)
                ref = np.asarray(j5.posterior_banded_batch5(
                    *[pk[k] for k in KEYS], em5, band=band,
                    params=j5.Hmm5Params()))
                targs = [torch.from_numpy(pk[k]) for k in KEYS]
                fM_t, lsF, logZ = t5.forward_banded5(*targs, em5t, band=band,
                                                     params=p5)
                got = t5.backward_posterior5(fM_t, lsF, logZ, *targs, em5t,
                                             band=band, params=p5).numpy()
                gap = float(np.abs(got - ref).max())
                worst_abs = max(worst_abs, gap)
                worst = max(worst, gap / log_scale_ulp(lsF, logZ, pk))
            print(f"5. 5-state, pairs < {max_len} bp, band {band}, 12 seeds: "
                  f"posterior max |diff| {worst_abs:.3g}, at most "
                  f"{worst:.2f} ulp of the largest log-scale sum")

    # 6. the degenerate 5-state machine against the 3-state one (port)
    p5d = t5.Hmm5Params(match_continue=1.0 - 2.0 * p.delta,
                        open_short=p.delta, open_long=1e-12,
                        extend_short=p.epsilon, extend_long=1e-12,
                        switch_sl=0.0, switch_ls=0.0, p_match=p.p_match)
    band, worst = 128, 0.0
    for seed in range(8):
        pk = jb.pack_band_batch(_pairs5(seed, 5, 120), band)
        targs = [torch.from_numpy(pk[k]) for k in KEYS]
        fM_t, lsF, logZ = t5.forward_banded5(
            *targs, torch.from_numpy(p5d.emissions()), band=band, params=p5d)
        post5 = t5.backward_posterior5(
            fM_t, lsF, logZ, *targs, torch.from_numpy(p5d.emissions()),
            band=band, params=p5d)
        post3 = tp.posterior_banded_batch(*targs, emt, band=band,
                                          delta=p.delta, epsilon=p.epsilon)
        worst = max(worst, float((post5 - post3).abs().max())
                    / log_scale_ulp(lsF, logZ, pk))
    print(f"6. degenerate 5-state vs 3-state (port), pairs < 120 bp, band "
          f"{band}, 8 seeds: at most {worst:.2f} ulp")


if __name__ == "__main__":
    main()
