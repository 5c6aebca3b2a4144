#!/usr/bin/env python3
"""Time pairhmm_fwd and pairhmm_bwd on the card at fixed-seed shapes.

    python tests/pairhmm_sweep_report.py [--root DIR] [--reps N] [--only S]
                                         [--replay FILE] [--model 3|5]

Times the cactus_tpu_torch package of the checkout at --root (default:
this one), on inputs made here from fixed seeds, so a parent commit
unpacked into a gitignored directory is timed by the same script on the
same inputs.  To compare two trees on one card, run parent, change,
change, parent in one command.

Shapes (pairs, rows, band): the default path's nested refinement
launches, `[2, 2048, 512]` and `[2, 2048, 2048]` (two pieces of 1500-2048
bases); 4096-row ragged checks at bands 512 and 2048 (four pieces of
2100-4095 bases); and a many-pair `[32, 1024, 512]` (pieces of 600-1024
bases, as nested refinement batches up to 32 pieces a launch on
a genome-scale input).  For each it prints one JSON line with the
wrapper's time by CUDA events (mean of --reps launches after a warm-up),
the kernel's device time from torch.profiler (`device_ms`, None where the
profiler records no such kernel), the longest pair's rows, the time per
row of that pair (`us_per_row`), and the posterior's largest gap to the
plain PyTorch version on the same inputs (`post_gap`).  With --replay,
also every pairhmm_fwd call of the default path that `python3
chip_smoke.py --dump-pairhmm FILE` saved, one at a time, and pairhmm_bwd
on each call's forward outputs, summed by band.  Prints the card's
name and power limit first.  Needs a CUDA device.

In 3-state mode it also times the wide route (bands past 16384, the
cluster kernels in a tree that has them), case names starting "wide" or
"cluster": phase 8's `[1, 512, 32768]` (a 300-base query in the middle
of a 20,000-base target, max_live 20,001) under chip_smoke's
WIDE_HMM_GAPS, the same at the default gaps, the same in clusters of at
most 8 CTAs (`_launch_fwd(max_ctas=8)`, a tree with it), a 64-row query
in a 100,000-base target at band 131072 (max_live 100,001: global
scratch), and 300-row queries at max_live 4,096, 8,192 and 16,384 on the
narrow kernels and on the cluster kernels forced there.  Each of those
is first held to the plain versions on the card (chip_smoke.check_hmm,
logZ against the plain steps in float64 for the global case; under the
gaps also chip_smoke.long_pair_seen; at the default gaps the posterior
0 wherever the plain one is), so parent and change pass the
same checks in one call, and each line names the route, the cluster
(CTAs, threads, cells a lane, shared memory or not) and us_per_row.

With --model 5 it times pairhmm5_fwd and pairhmm5_bwd instead, with
max_live as posterior_pairs_banded5 passes it where the tree's wrappers
take one: at four ragged checks (bands 1024, 2048, 4096 and 16384;
p_match 0.7; pieces of up to 3000 rows) and at `[512, 256, 1024]`, the
shape of the pecan path's largest call with every piece 150-255 bases
long, and with --replay at every call that `python3 chip_smoke.py --dump-pairhmm5 FILE`
saved.  Each line also carries the live cells of the pairs' windows and
the cells the tree's kernels compute (rows 1..m x the lanes' cover, or x
the band for a tree without max_live).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
# name, seed, pairs, shortest, longest (exclusive), band
SHAPES = (("path-like band 512", 11, 2, 1500, 2049, 512),
          ("path-like band 2048", 12, 2, 1500, 2049, 2048),
          ("chip_smoke band 512", 512 + 7, 4, 2100, 4096, 512),
          ("chip_smoke band 2048", 2048 + 7, 4, 2100, 4096, 2048),
          ("many pairs band 512", 13, 32, 600, 1025, 512))
# the 5-state shapes: chip_smoke.py's ragged checks (same seeds and
# mutation rates) and the pecan path's many short pieces
SHAPES5 = (("chip_smoke band 1024", 1024 + 11, 4, 1500, 3000, 1024),
           ("chip_smoke band 2048", 2048 + 11, 2, 2000, 3000, 2048),
           ("chip_smoke band 4096", 4096 + 11, 2, 2500, 3000, 4096),
           ("chip_smoke band 16384", 16384 + 11, 2, 600, 1000, 16384),
           ("many short pairs band 1024", 17, 512, 150, 256, 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="time only the shapes whose name holds this")
    ap.add_argument("--replay", metavar="FILE",
                    help="also time every call saved by chip_smoke.py "
                    "--dump-pairhmm (--dump-pairhmm5 with --model 5)")
    ap.add_argument("--model", type=int, choices=(3, 5), default=3,
                    help="3: pairhmm_fwd/bwd, 5: pairhmm5_fwd/bwd")
    ap.add_argument("--no-check", action="store_true",
                    help="time the 3-state wide cases without holding them "
                    "to the plain versions (a copy with a part of a kernel "
                    "taken out, whose outputs are wrong by construction)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("pairhmm_sweep_report: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sweep = importlib.util.spec_from_file_location(
        "banded_sweep_report",
        os.path.join(HERE, "tests", "banded_sweep_report.py"))
    banded_sweep = importlib.util.module_from_spec(sweep)
    sweep.loader.exec_module(banded_sweep)
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import cuda_build, pairhmm_cuda
    from cactus_tpu_torch.ops import pairhmm as tp
    if not pairhmm_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {pairhmm_cuda.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    source = "pairhmm5" if args.model == 5 else "pairhmm"
    for line in smoke.ptxas_lines(cuda_build.build([source]).get(source, "")):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda", 0)
    if args.model == 5:
        return model5(args, smoke, banded_sweep, dev, root)
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions()).to(dev)
    rel = os.path.relpath(root, HERE)
    for name, seed, n, lo_len, hi_len, band in SHAPES:
        if args.only not in name:
            continue
        pairs = smoke.ragged_pairs(seed, n, lo_len, hi_len, band)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        dargs = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
        kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
        fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*dargs, em, **kw)
        post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *dargs, em, **kw)
        ref = tp.posterior_banded_batch(*[a.cpu() for a in dargs], em.cpu(),
                                        **kw)
        gap = float((post.cpu() - ref).abs().max())
        rows = int(dargs[2].max())
        P, M = dargs[0].shape
        for kernel, fn in (
                ("pairhmm_fwd",
                 lambda: pairhmm_cuda.pairhmm_fwd(*dargs, em, **kw)),
                ("pairhmm_bwd",
                 lambda: pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *dargs, em,
                                                  **kw))):
            ms = smoke.time_ms(fn, args.reps)
            dev_ms = banded_sweep.kernel_device_ms(fn, args.reps, kernel)
            print(json.dumps(dict(
                root=rel, case=name, kernel=kernel, shape=[P, M, band],
                ms=ms, device_ms=dev_ms, longest_rows=rows,
                us_per_row=(dev_ms if dev_ms is not None else ms) * 1e3
                / rows, post_gap=gap)), flush=True)
        del fM, lsF, logZ, post, ref
    wide3(args, smoke, banded_sweep, dev, rel)
    if args.replay:
        replay(args.replay, pairhmm_cuda, smoke, banded_sweep, dev, rel,
               args.reps)
    return 0


# the 3-state wide cases: name, query rows, target bases, copy position,
# band, gaps ("wide": chip_smoke.WIDE_HMM_GAPS; "default": HmmParams()),
# routes to time ("wide", "narrow"), the cluster's CTA cap (0: none)
WIDE3 = (("wide 20001", 300, 20000, 10000, 32768, "wide", ("wide",), 0),
         ("wide 20001 default gaps", 300, 20000, 10000, 32768, "default",
          ("wide",), 0),
         ("wide 20001 ctas 8", 300, 20000, 10000, 32768, "wide", ("wide",),
          8),
         ("wide 100001 global", 64, 100000, 50000, 131072, "wide",
          ("wide",), 0),
         ("cluster 4096", 300, 4095, 1900, 4096, "wide", ("narrow", "wide"),
          0),
         ("cluster 8192", 300, 8191, 4000, 8192, "wide", ("narrow", "wide"),
          0),
         ("cluster 16384", 300, 16383, 8000, 16384, "wide",
          ("narrow", "wide"), 0))


def wide3(args, smoke, banded_sweep, dev, rel):
    """The 3-state wide cases (WIDE3), each held to the plain versions on
    the card (unless --no-check) and timed on its routes: one JSON line
    per kernel, case and route."""
    import numpy as np
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, pairhmm_cuda
    from cactus_tpu_torch.ops import pairhmm as tp
    has_cluster = hasattr(pairhmm_cuda, "cluster_shape")
    for (name, m, n, at, band, gaps, routes, ctas) in WIDE3:
        if args.only not in name:
            continue
        if not has_cluster and (ctas or name.startswith("cluster")):
            routes = tuple(r for r in routes if r == "narrow")
            if not routes:
                continue
        rng = np.random.default_rng(band + n)
        pairs = [smoke.embedded_pair(rng, m, n, at)]
        packed = tb.pack_band_batch(pairs, band, min_batch=1, min_rows=256)
        dargs = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
        p = tp.HmmParams(**(smoke.WIDE_HMM_GAPS if gaps == "wide" else {}))
        em = torch.from_numpy(p.emissions()).to(dev)
        kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
        max_live = banded_cuda.live_width(dargs[3], band)
        fM_r, lsF_r, logZ_r = tp.forward_banded(*dargs, em, **kw)
        ref = tp.backward_posterior(fM_r, lsF_r, logZ_r, *dargs, em, **kw)
        live = banded_cuda.live_mask(*dargs[2:5], dargs[0].shape[1], band)
        # past float32's conditioning (50,000-base gaps) logZ is held to
        # the plain steps in float64 (chip_smoke.check_hmm)
        z64 = (tp.forward_banded(*dargs, em, **kw, dtype=torch.float64)[2]
               if "global" in name else None)
        rows = int(dargs[2].max())
        P, M = dargs[0].shape
        for route in routes:
            if has_cluster:
                launch = dict(max_live=max_live, route=route, max_ctas=ctas)
                fwd = lambda: pairhmm_cuda._launch_fwd(*dargs, em, **kw,
                                                       **launch)
                bwd = lambda: pairhmm_cuda._launch_bwd(
                    fM, lsF, logZ, *dargs, em, **kw, **launch)
                shape = (pairhmm_cuda.cluster_shape(max_live, ctas)
                         if route == "wide" else None)
            else:
                fwd = lambda: pairhmm_cuda.pairhmm_fwd(*dargs, em, **kw)
                bwd = lambda: pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ,
                                                       *dargs, em, **kw)
                shape = None
            fM, lsF, logZ = fwd()
            post = bwd()
            what = f"{rel}: {name}, {route} route"
            if not args.no_check:
                check_wide3(smoke, tp, what, pairs, packed, gaps, fM, lsF,
                            logZ, post, (fM_r, lsF_r, logZ_r, ref), live,
                            z64)
            gap = float((post - ref).abs().max())
            kernel_names = (("pairhmm_fwd", "pairhmm_bwd") if route ==
                            "narrow" else ("pairhmm_fwd_cluster_kernel",
                                           "pairhmm_bwd_cluster_kernel")
                            if has_cluster else ("pairhmm_fwd_wide_kernel",
                                                 "pairhmm_bwd_wide_kernel"))
            for kernel, prof_name, fn in (
                    ("pairhmm_fwd", kernel_names[0], fwd),
                    ("pairhmm_bwd", kernel_names[1], bwd)):
                ms = smoke.time_ms(fn, args.reps)
                dev_ms = banded_sweep.kernel_device_ms(fn, args.reps,
                                                       prof_name)
                print(json.dumps(dict(
                    root=rel, case=name, kernel=kernel, route=route,
                    shape=[P, M, band], max_live=max_live, cluster=shape,
                    ms=ms, device_ms=dev_ms, longest_rows=rows,
                    us_per_row=(dev_ms if dev_ms is not None else ms) * 1e3
                    / rows, post_gap=gap)), flush=True)
            del fM, lsF, logZ, post
        del fM_r, lsF_r, logZ_r, ref, live


def check_wide3(smoke, tp, what, pairs, packed, gaps, fM, lsF, logZ, post,
                plain, live, z64):
    """A wide case's kernel outputs held to the plain versions `plain`
    (fM, lsF, logZ, posterior), as the module docstring says."""
    smoke.check_hmm(fM, lsF, logZ, post, *plain, what, logZ_64=z64)
    ref = plain[3]
    if gaps == "default":
        if bool(post[ref == 0].any()):
            raise AssertionError(f"{what}: a posterior cell is not 0 where "
                                 "the plain one is")
        return
    hits = tp.banded_hits(post, pairs, packed["lo"], 0.5)
    ref_hits = tp.banded_hits(ref, pairs, packed["lo"], 0.5)
    smoke.long_pair_seen(what, hits[0], ref_hits[0], ref[0], plain[0][0],
                         live[0])


def model5(args, smoke, banded_sweep, dev, root):
    """The 5-state kernels at SHAPES5 and, with --replay, the saved pecan
    calls: one JSON line per kernel and shape."""
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, pairhmm5_cuda
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    if not pairhmm5_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {pairhmm5_cuda.__file__}, not {root}")
    has_live = "max_live" in inspect.signature(
        pairhmm5_cuda.pairhmm5_fwd).parameters
    rel = os.path.relpath(root, HERE)

    def run(case, dargs, band, params, max_live, check):
        """Times both kernels on one call; returns their JSON lines."""
        em = torch.from_numpy(params.emissions()).to(dev)
        kw = dict(band=band, params=params)
        if has_live:
            kw["max_live"] = max_live
        fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*dargs, em, **kw)
        post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *dargs, em, **kw)
        gap = None
        if check:
            pkw = dict(band=band, params=params)
            ref = tp5.forward_banded5(*dargs, em, **pkw)
            gap = float((post - tp5.backward_posterior5(
                *ref, *dargs, em, **pkw)).abs().max())
            del ref
        P, M = dargs[0].shape
        m, n, lo = dargs[2], dargs[3], dargs[4]
        rows = int(m.max())
        used = int(m.sum())
        live = banded_cuda.live_cells(m, n, lo, M, band)
        computed = used * band
        if has_live:
            computed = used * pairhmm5_cuda.launch_threads(max_live) * \
                pairhmm5_cuda.cells_per_lane(max_live)
        # the launches alone where the tree has them (its wrappers' max_live
        # check is a device sync before each launch)
        fwd = getattr(pairhmm5_cuda, "launch_pairhmm5_fwd",
                      pairhmm5_cuda.pairhmm5_fwd)
        bwd = getattr(pairhmm5_cuda, "launch_pairhmm5_bwd",
                      pairhmm5_cuda.pairhmm5_bwd)
        out = []
        for kernel, fn in (
                ("pairhmm5_fwd", lambda: fwd(*dargs, em, **kw)),
                ("pairhmm5_bwd",
                 lambda: bwd(fM, lsF, logZ, *dargs, em, **kw))):
            ms = smoke.time_ms(fn, args.reps)
            dev_ms = banded_sweep.kernel_device_ms(fn, args.reps, kernel)
            out.append(dict(
                root=rel, case=case, kernel=kernel, shape=[P, M, band],
                max_live=max_live if has_live else None, ms=ms,
                device_ms=dev_ms, longest_rows=rows,
                us_per_row=(dev_ms if dev_ms is not None else ms) * 1e3
                / max(1, rows), live_cells=live, computed_cells=computed,
                post_gap=gap))
        return out

    p7 = tp5.Hmm5Params(p_match=0.7)
    for name, seed, n, lo_len, hi_len, band in SHAPES5:
        if args.only not in name:
            continue
        pairs = smoke.ragged_pairs(seed, n, lo_len, hi_len, band, sub=0.2,
                                   indel=0.06)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        dargs = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
        for line in run(name, dargs, band, p7,
                        banded_cuda.live_width(dargs[3], band), True):
            print(json.dumps(line), flush=True)
    if args.replay:
        saved = torch.load(args.replay)
        totals = {}
        for tensors, kw in saved["calls"]:
            dargs = [x.to(dev) for x in tensors[:5]]
            params = tp5.Hmm5Params(**kw["params"])
            lines = run("pecan path replay", dargs, kw["band"], params,
                        kw.get("max_live", kw["band"]), False)
            for line in lines:
                tot = totals.setdefault(line["kernel"], dict(
                    ms=0.0, device_ms=0.0, live_cells=0, computed_cells=0))
                tot["ms"] += line["ms"]
                tot["device_ms"] = (None if line["device_ms"] is None
                                    or tot["device_ms"] is None
                                    else tot["device_ms"] + line["device_ms"])
                tot["live_cells"] += line["live_cells"]
                tot["computed_cells"] += line["computed_cells"]
        for kernel, tot in totals.items():
            print(json.dumps(dict(root=rel, case="pecan path replay",
                                  kernel=kernel, calls=len(saved["calls"]),
                                  **tot)), flush=True)
    return 0


def replay(path, pairhmm_cuda, smoke, banded_sweep, dev, root, reps):
    """Time every saved pairhmm_fwd call of the default path, one at a
    time, and pairhmm_bwd on each call's forward outputs (CUDA events
    around reps calls, and the kernels' device time from the profiler);
    prints one JSON line per kernel with the totals by band."""
    import torch
    saved = torch.load(path)
    totals = {"pairhmm_fwd": {}, "pairhmm_bwd": {}}
    for tensors, kw in saved["calls"]:
        a = [x.to(dev) for x in tensors]
        fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*a, **kw)
        for kernel, fn in (
                ("pairhmm_fwd", lambda: pairhmm_cuda.pairhmm_fwd(*a, **kw)),
                ("pairhmm_bwd",
                 lambda: pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *a, **kw))):
            ms = smoke.time_ms(fn, reps)
            dev_ms = banded_sweep.kernel_device_ms(fn, reps, kernel)
            ms_b, n_b, d_b = totals[kernel].get(kw["band"], (0.0, 0, 0.0))
            totals[kernel][kw["band"]] = (
                ms_b + ms, n_b + 1,
                None if dev_ms is None or d_b is None else d_b + dev_ms)
        del fM, lsF, logZ
    for kernel, by_band in totals.items():
        dev_total = (None if any(v[2] is None for v in by_band.values())
                     else sum(v[2] for v in by_band.values()))
        print(json.dumps(dict(
            root=root, case="main path replay", kernel=kernel,
            calls=len(saved["calls"]),
            ms=sum(v[0] for v in by_band.values()), device_ms=dev_total,
            by_band={str(b): v for b, v in sorted(by_band.items())})),
            flush=True)


if __name__ == "__main__":
    sys.exit(main())
