#!/usr/bin/env python3
"""How float32 conditions the 5-state forward pass on a query inside a
long target.

    JAX_PLATFORMS=cpu python tests/pairhmm5_conditioning_report.py
    python tests/pairhmm5_conditioning_report.py --card    # on a GPU

A 300-base query copied `at` bases into a 70,000-base target (band
131072, p_match 0.8, the default gaps; the card test's pair, seed 70001,
and one on chip_smoke.py phase 8's seed-88 draws): the gap chain carries
the forward mass to the copy decaying as el^d (el = 0.9966), so some
30,000 bases in the copy's path starts from a few subnormal float32
ulps.  Then the card test's 64-base query 10,000 bases into a
140,000-base target (band 262144): at the default gaps its posterior is
0, and under a long gap of 0.99995 and 0.9999 a base (chip_smoke.py's
WIDE_HMM5_GAPS) it reaches 1.

For each case it prints one JSON line with logZ of the plain float32
version and its posterior's maximum, and on the CPU logZ of the numpy
model of the cluster kernels' schedule (tests/test_torch_pairhmm5_live.py,
the cluster shape of the card's launch: 16 CTAs of 18 warps of 8 cells
at 70,001 cells, of 32 warps of 9 at 140,001) in float32 and in
float64, and the cell where the model's float32 forward values stray
furthest from the plain version's (log fM + lsF, on plain fM > 1e-30),
with fM there in all three; with --card, logZ of the cluster kernels on
the card instead of the model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")


def cases():
    """(name, pair, band, Hmm5Params keyword arguments, model shape)."""
    import chip_smoke as smoke
    import test_torch_cuda as card
    out = []
    narrow = (8, 18, 16)
    for at in (30000, 10000):
        rng = np.random.default_rng(70001)
        out.append((f"card test, copy at {at}",
                    card._embedded_pair(rng, 300, 70000, at), 131072, {},
                    narrow))
    rng = np.random.default_rng(88)
    seed60 = rng.integers(0, 4, 60).astype(np.uint8)
    smoke.mutate(rng, seed60, sub=0.15, indel=0.1)
    rng.integers(0, 4, 9000)
    smoke.mutate(rng, seed60)
    rng.integers(0, 4, smoke.WIDE_POA_L)
    smoke.embedded_pair(rng, smoke.WIDE_HMM_QUERY, smoke.WIDE_HMM_TARGET,
                        smoke.WIDE_HMM_TARGET // 2)
    out.append(("seed-88 draws, copy at 35000",
                smoke.embedded_pair(rng, 300, 70000, 35000), 131072, {},
                narrow))
    for name, gaps in (("default gaps", {}),
                       ("long gap 0.99995",
                        dict(smoke.WIDE_HMM5_GAPS, extend_long=0.99995)),
                       ("long gap 0.9999", smoke.WIDE_HMM5_GAPS)):
        rng = np.random.default_rng(70001)
        out.append((f"card test global, {name}",
                    card._embedded_pair(rng, 64, 140000, 10000), 262144,
                    gaps, (9, 32, 16)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card", action="store_true",
                    help="the cluster kernels on the card, not the model")
    args = ap.parse_args()
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    dev = torch.device("cuda" if args.card else "cpu")
    for name, pair, band, gaps, shape in cases():
        params = tp5.Hmm5Params(p_match=0.8, **gaps)
        em = torch.from_numpy(params.emissions()).to(dev)
        packed = tb.pack_band_batch([pair], band, min_batch=1)
        t = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
        fr, lr, zr = tp5.forward_banded5(*t, em, band=band, params=params)
        post = tp5.backward_posterior5(fr, lr, zr, *t, em, band=band,
                                       params=params)
        row = dict(case=name, plain_logZ=float(zr[0]),
                   plain_post_max=float(post.max()))
        del post
        if args.card:
            from cactus_tpu_torch.ops import pairhmm5_cuda
            _f, _l, z = pairhmm5_cuda.launch_pairhmm5_fwd(
                *t, em, band=band, params=params,
                max_live=banded_cuda.live_width(t[3], band))
            row["card_logZ"] = float(z[0])
            print(json.dumps(row), flush=True)
            continue
        import test_torch_pairhmm5_live as model
        a = (packed["q"][0], packed["t_shift"][0], int(packed["m_len"][0]),
             int(packed["n_len"][0]), int(packed["lo"][0]),
             params.emissions().astype(np.float32), band, params, *shape)
        fm32, ls32, z32 = model.fwd_model(*a)
        model.F = np.float64          # the same schedule in float64
        try:
            fm64, ls64, z64 = model.fwd_model(*a)
        finally:
            model.F = np.float32
        plain_f = fr[0].numpy()
        plain_l = lr[0].numpy()
        live = plain_f > 1e-30
        with np.errstate(divide="ignore", invalid="ignore"):
            gap = np.abs((np.log(fm32) + ls32[:, None])
                         - (np.log(plain_f) + plain_l[:, None]))
        gap = np.where(live, gap, 0.0)
        r, b = np.unravel_index(int(gap.argmax()), gap.shape)
        row.update(model32_logZ=float(z32), model64_logZ=float(z64),
                   worst_row=int(r) + 1, worst_band_cell=int(b),
                   log_gap=float(gap[r, b]), plain_fM=float(plain_f[r, b]),
                   model32_fM=float(fm32[r, b]), model64_fM=float(fm64[r, b]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
