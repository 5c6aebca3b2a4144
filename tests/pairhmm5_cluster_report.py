#!/usr/bin/env python3
"""Time the 5-state pair-HMM's wide route (the cluster kernels) on the card.

    python tests/pairhmm5_cluster_report.py [--root DIR] [--reps N]
                                            [--only S]

Times the cactus_tpu_torch package of the checkout at --root (default:
this one) on one pair a launch, made here from fixed seeds: a query
inside a long target, so that every row's live window is the target
plus one cell wide.  Cases (query rows, target bases, band):

- "wide 70001": 300 rows in 70,000 bases at band 131072, chip_smoke.py
  phase 8's largest 5-state call `[1, 512, 131072]` (the state rows in
  the cluster's shared memory);
- "global 140001": 64 rows in 140,000 bases at band 262144, past the
  131,072 cells that shared memory holds (global scratch);
- "narrow 16384", "narrow 32768", "narrow 65536": 300 rows at max_live
  16,384, 32,768 and 65,536, which the one-block kernels take, each timed
  on both routes (a tree whose private launches `_launch_fwd` /
  `_launch_bwd` take a route).

For each case and route it prints one JSON line: the wrapper launch's
time by CUDA events (forward, and backward on the forward's outputs;
mean of --reps launches after a warm-up), the time a row, the launch's
shape (the cluster's CTAs, threads and cells a lane, or the block's
threads and cells a lane) and, where two routes ran, the largest gap
between their posteriors.  chip_smoke.py holds both routes to the plain
versions.  Prints the card's name and power limit first.  Needs a CUDA
device.  To compare two trees on one card, unpack the parent into a
gitignored directory and run parent, change, change, parent in one
command: a parent without those launches times its own wide kernels at
the wide cases.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
# name, seed, query rows, target bases, band
CASES = (("wide 70001", 70001, 300, 70000, 131072),
         ("global 140001", 140001, 64, 140000, 262144),
         ("narrow 16384", 16384, 300, 16383, 16384),
         ("narrow 32768", 32768, 300, 32767, 32768),
         ("narrow 65536", 65536, 300, 65535, 65536))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="time only the cases whose name holds this")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pairhmm5_cluster_report: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, cuda_build, pairhmm5_cuda
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    if not pairhmm5_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {pairhmm5_cuda.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    for line in smoke.ptxas_lines(cuda_build.build(["pairhmm5"])
                                  .get("pairhmm5", "")):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda", 0)
    routed = hasattr(pairhmm5_cuda, "_launch_fwd")
    p = tp5.Hmm5Params(p_match=0.8)
    em = torch.from_numpy(p.emissions()).to(dev)
    rel = os.path.relpath(root, HERE)
    for name, seed, m, n, band in CASES:
        if args.only not in name:
            continue
        rng = np.random.default_rng(seed)
        pair = smoke.embedded_pair(rng, m, n, min((n - m) // 2, 10000))
        packed = tb.pack_band_batch([pair], band, min_batch=1)
        dargs = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
        max_live = banded_cuda.live_width(dargs[3], band)
        rows = int(dargs[2].max())
        routes = [None]
        if name.startswith("narrow"):
            if not routed:
                continue
            routes = ["narrow", "wide"]
        posts = []
        for route in routes:
            kw = dict(band=band, params=p, max_live=max_live)
            if route is None:
                fwd, bwd = pairhmm5_cuda.launch_pairhmm5_fwd, \
                    pairhmm5_cuda.launch_pairhmm5_bwd
            else:
                fwd, bwd = (functools.partial(f, route=route) for f in (
                    pairhmm5_cuda._launch_fwd, pairhmm5_cuda._launch_bwd))
            wide = (route or pairhmm5_cuda.pairhmm5_route(max_live)) == "wide"
            if wide and hasattr(pairhmm5_cuda, "cluster_shape"):
                shape = pairhmm5_cuda.cluster_shape(max_live)
            else:
                shape = dict(threads=pairhmm5_cuda.launch_threads(max_live),
                             cells=pairhmm5_cuda.cells_per_lane(max_live)) \
                    if not wide else dict(kernel="full band")
            fM, lsF, logZ = fwd(*dargs, em, **kw)
            post = bwd(fM, lsF, logZ, *dargs, em, **kw)
            torch.cuda.synchronize()
            f_ms = smoke.time_ms(lambda: fwd(*dargs, em, **kw), args.reps)
            b_ms = smoke.time_ms(lambda: bwd(fM, lsF, logZ, *dargs, em,
                                             **kw), args.reps)
            posts.append(post)
            gap = float((posts[0] - post).abs().max()) if len(posts) > 1 \
                else None
            print(json.dumps(dict(
                root=rel, case=name, route="wide" if wide else "narrow",
                shape=[*dargs[0].shape, band], max_live=max_live,
                launch=shape, fwd_ms=f_ms, bwd_ms=b_ms, rows=rows,
                fwd_us_per_row=f_ms * 1e3 / rows,
                bwd_us_per_row=b_ms * 1e3 / rows, route_post_gap=gap)),
                flush=True)
            del fM, lsF, logZ
        del posts, dargs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
