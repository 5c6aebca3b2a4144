#!/usr/bin/env python3
"""Time banded_dp and banded_traceback on the card at the shapes
chip_smoke.py checks them at.

    python tests/banded_sweep_report.py [--root DIR] [--reps N]
                                        [--replay FILE]

Times the cactus_tpu_torch package of the checkout at --root (default:
this one), on inputs made here from fixed seeds, so a parent commit
unpacked into a gitignored directory is timed by the same script on the
same inputs.  To compare two trees on one card, run parent, change,
change, parent in one command.

Shapes: chip_smoke.py's banded_dp sweep (bands 128, 512, 2048 and 16384,
ragged pairs from chip_smoke.ragged_pairs), and a synthetic batch shaped
like the default path's largest launch, the BAR star engine's short ends
(15171 pairs of 1-32 query bases whose targets are at most 23 bases
longer, band 1024).  Where the tree's banded_dp takes max_live, every
shape runs with the batch's live width, as the path passes it, and the
short ends also with max_live 128, 256, 512 and 1024 (32, 64, 128 and
256 threads a block).  banded_traceback is timed at every shape on
banded_dp's outputs, with the move capacity S the path gives it
(chip_smoke.traceback_cap).  With --replay, also every banded_dp call of
the default path that `python3 chip_smoke.py --dump-banded FILE` saved,
one at a time (--reps launches each after a warm-up), and
banded_traceback on each call's outputs, summed by band, with the steps
walked and the longest walk.  Prints the card's name and power limit and
one JSON line per timing (CUDA events, mean of --reps launches after one
warm-up, through the wrapper, or banded_dp's launch function where the
tree has one); banded_traceback's lines also carry its kernel's device
time from torch.profiler (`device_ms`), which leaves out the wrapper's
host work.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
# chip_smoke.py phase_kernels_vs_plain: band, pairs, shortest, longest
SWEEP = ((128, 64, 20, 1000), (512, 16, 500, 4000), (2048, 4, 2000, 8000),
         (16384, 2, 300, 1200))
SHORT_ENDS = 15171


def short_end_pairs(smoke, seed=5):
    """BAR-like short ends: 1-32 query bases, a target mutated from it
    with up to 12 extra bases (|n - m| <= 23)."""
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < SHORT_ENDS:
        q = rng.integers(0, 4, int(rng.integers(1, 33))).astype(np.uint8)
        t = np.concatenate([smoke.mutate(rng, q, 0.15, 0.1),
                            rng.integers(0, 4, int(rng.integers(0, 13)))
                            ]).astype(np.uint8)
        if abs(len(t) - len(q)) <= 23:
            pairs.append((q, t))
    return pairs


def live_cells(packed, n, B):
    """Band cells (i, b) with 1 <= i <= m and 0 <= i + lo + b <= n."""
    i = np.arange(1, packed["q"].shape[1] + 1)[None, :]
    lo = packed["lo"][:n, None].astype(np.int64)
    b_lo = np.maximum(0, -i - lo)
    b_hi = np.minimum(B - 1, packed["n_len"][:n, None] - i - lo)
    width = np.maximum(0, b_hi - b_lo + 1)
    return int((width * (i <= packed["m_len"][:n, None])).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--replay", metavar="FILE")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("banded_sweep_report: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, cuda_build
    if not banded_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {banded_cuda.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    cuda_build.build(["banded"])
    has_live = "max_live" in inspect.signature(
        banded_cuda.banded_dp).parameters
    dev = torch.device("cuda", 0)
    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)
    cases = [(f"band {band}", smoke.ragged_pairs(band, n, lo_len, hi_len,
                                                   band), band, False)
             for band, n, lo_len, hi_len in SWEEP]
    cases.append(("bar short ends", short_end_pairs(smoke), 1024, True))
    for name, pairs, band, sliced in cases:
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        n = len(pairs) if sliced else len(packed["q"])
        dargs = [torch.from_numpy(np.ascontiguousarray(packed[k][:n]))
                 .to(dev) for k in KEYS]
        P, M = dargs[0].shape
        lives = [None]
        if has_live:
            lives = [banded_cuda.live_width(dargs[3], band)]
            if sliced:
                lives += [128, 256, 512, 1024]
        for max_live in lives:
            kw = dict(band=band, gap_open=400, gap_extend=30)
            if max_live is not None:
                kw["max_live"] = max_live
                threads = banded_cuda.launch_threads(band, max_live, P)
            else:
                threads = 256 if band >= 256 else 32 * ((band + 31) // 32)
            ms = smoke.time_ms(
                lambda: banded_cuda.banded_dp(*dargs, sub, **kw), args.reps)
            print(json.dumps(dict(
                root=os.path.relpath(root, HERE), case=name,
                shape=[P, M, band], max_live=max_live, threads=threads,
                ms=ms, live_cells=live_cells(packed, n, band),
                band_cells=int(packed["m_len"][:n].sum()) * band)),
                flush=True)
        dirs, _scores, end_mat = banded_cuda.banded_dp(*dargs, sub, **kw)
        S = smoke.traceback_cap(dargs[2], dargs[3])
        tb_args = (dirs, dargs[2], dargs[3], dargs[4], end_mat, S)
        counts = banded_cuda.banded_traceback(*tb_args)[1]
        ms = smoke.time_ms(lambda: banded_cuda.banded_traceback(*tb_args),
                           args.reps)
        dev_ms = kernel_device_ms(
            lambda: banded_cuda.banded_traceback(*tb_args), args.reps,
            "banded_traceback_kernel")
        print(json.dumps(dict(
            root=os.path.relpath(root, HERE), case=name,
            kernel="banded_traceback", shape=[P, M, band, S], ms=ms,
            device_ms=dev_ms,
            steps=int(counts.clamp_min(0).sum()),
            longest_walk=int(counts.max()))), flush=True)
        del dirs, tb_args
    if args.replay:
        replay(args.replay, banded_cuda, smoke, dev,
               os.path.relpath(root, HERE), args.reps)
    return 0


def kernel_device_ms(fn, reps, kernel):
    """Device time a call of fn spends in the CUDA kernel named `kernel`,
    from torch.profiler's CUDA activity over reps calls after a warm-up
    (None where the profiler records no such kernel or cannot trace).
    Unlike CUDA events around the calls, it leaves out the wrapper's host
    work, which paces a launch whose kernel is shorter than it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as err:   # no CUPTI tracing
        print(f"banded_sweep_report: profiler: {err}", file=sys.stderr)
        return None
    us = sum(getattr(e, "self_device_time_total", 0) or
             getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps if us else None


def replay(path, banded_cuda, smoke, dev, root, reps):
    """Time every saved banded_dp call, one at a time, and
    banded_traceback on each call's outputs (CUDA events around reps
    calls, and the kernel's device time from the profiler)."""
    import torch
    saved = torch.load(path)
    sub = saved["submat"].to(dev)
    launch = getattr(banded_cuda, "launch_banded_dp", None)
    by_band: dict = {}
    tb_by_band: dict = {}
    steps = longest = 0
    for tensors, kw in saved["calls"]:
        dargs = [x.to(dev) for x in tensors]
        fn = launch
        if launch is None:          # a tree without max_live
            fn = banded_cuda.banded_dp
            kw = {k: v for k, v in kw.items() if k != "max_live"}
        ms = smoke.time_ms(lambda: fn(*dargs, sub, **kw), reps)
        ms_b, n_b = by_band.get(kw["band"], (0.0, 0))
        by_band[kw["band"]] = (ms_b + ms, n_b + 1)
        dirs, _scores, end_mat = fn(*dargs, sub, **kw)
        tb_args = (dirs, dargs[2], dargs[3], dargs[4], end_mat,
                   smoke.traceback_cap(dargs[2], dargs[3]))
        counts = banded_cuda.banded_traceback(*tb_args)[1]
        steps += int(counts.clamp_min(0).sum())
        longest = max(longest, int(counts.max()))
        ms = smoke.time_ms(lambda: banded_cuda.banded_traceback(*tb_args),
                           reps)
        dev_ms = kernel_device_ms(
            lambda: banded_cuda.banded_traceback(*tb_args), reps,
            "banded_traceback_kernel")
        ms_b, n_b, d_b = tb_by_band.get(kw["band"], (0.0, 0, 0.0))
        tb_by_band[kw["band"]] = (ms_b + ms, n_b + 1,
                                  None if dev_ms is None or d_b is None
                                  else d_b + dev_ms)
        del dirs, tb_args
    print(json.dumps(dict(
        root=root, case="main path replay", calls=len(saved["calls"]),
        ms=sum(v[0] for v in by_band.values()),
        by_band={str(b): v for b, v in sorted(by_band.items())})),
        flush=True)
    print(json.dumps(dict(
        root=root, case="main path replay", kernel="banded_traceback",
        calls=len(saved["calls"]), ms=sum(v[0] for v in tb_by_band.values()),
        device_ms=(None if any(v[2] is None for v in tb_by_band.values())
                   else sum(v[2] for v in tb_by_band.values())),
        by_band={str(b): v for b, v in sorted(tb_by_band.items())},
        steps=steps, longest_walk=longest)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
