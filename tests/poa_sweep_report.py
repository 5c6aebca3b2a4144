#!/usr/bin/env python3
"""Time poa_chain, poa_affine and poa_linear on the card at fixed-seed
shapes.

    python tests/poa_sweep_report.py [--root DIR] [--reps N] [--only S]
                                     [--replay FILE] [--paths]
                                     [--dump FILE]

Times the cactus_tpu_torch package of the checkout at --root (default:
this one), on inputs made here from fixed seeds, so a parent commit
unpacked into a gitignored directory is timed by the same script on the
same inputs.  To compare two trees on one card, run parent, change,
change, parent in one command.

Shapes: chip_smoke.py's POA checks (phase_poa_kernels_vs_plain: chains
with source pad nodes and bubbled DAGs, ragged queries, bands 64 to
16384, the dominant bin P 16,000 x N 64 x B 64) and poa_linear on bubbled
DAGs padded as poa_align pads them (POA_LINEAR_CASES).  For each it prints one
JSON line with the launch's time by CUDA events (mean of --reps launches
after a warm-up), the kernel's device time from torch.profiler
(`device_ms`, None where the profiler records no such kernel), and the
live cells (`live_cells`, ops/poa_cuda.py::live_mask) beside the band
cells.  Every tree is timed through its public wrappers: where they take
n_nodes and max_live (the live contract), they get them as align_bin
passes them (max_live from check_live on the host arrays; poa_linear's
n_nodes and l_len as poa_align passes them); an older tree's wrappers
compute every node and column.

With --replay, also every poa_chain and poa_affine call of the poa paths
and every poa_linear call of poa_msa without params that `python3
chip_smoke.py --dump-poa FILE` (or --dump here) saved, one at a time,
summed by bin (N, B; poa_linear: N, L + 1), with the longest call.  With
--paths it first runs both poa paths (chip_smoke.phase_poa: the
evolverMammals tree at 600 kb and the 4-leaf star at 200 kb) and
poa_msa without params (chip_smoke.phase_poa_linear) on the tree and
prints their accuracies and leaf-pair digests; --dump FILE then saves
their calls.  Prints the card's
name and power limit first.  Needs a CUDA device.
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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="time only the shapes whose name holds this")
    ap.add_argument("--replay", metavar="FILE",
                    help="also time every call saved by chip_smoke.py "
                    "--dump-poa")
    ap.add_argument("--paths", action="store_true",
                    help="first run both poa paths and print their "
                    "accuracies and leaf-pair digests")
    ap.add_argument("--dump", metavar="FILE",
                    help="with --paths: save the paths' calls there")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("poa_sweep_report: no CUDA device", file=sys.stderr)
        return 1
    smoke = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    banded_sweep = _load("banded_sweep_report",
                         os.path.join(HERE, "tests", "banded_sweep_report.py"))
    from cactus_tpu_torch.ops import cuda_build, poa_cuda
    if not poa_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {poa_cuda.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    for line in smoke.ptxas_lines(cuda_build.build(["poa"]).get("poa", "")):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda", 0)
    rel = os.path.relpath(root, HERE)
    if args.paths:
        _launches, recorders = smoke.phase_poa(dev)
        _launches, lin_recorders = smoke.phase_poa_linear(dev)
        if args.dump:
            smoke.dump_poa({**recorders, **lin_recorders}, args.dump)
    run = Runner(poa_cuda, smoke, banded_sweep, dev, rel, args.reps)
    sweep(run, smoke, dev, args.only)
    if args.replay:
        replay(run, args.replay, dev)
    return 0


class Runner:
    """Times one call of a kernel of the tree at --root through its
    wrapper, with n_nodes and max_live where the tree has the live
    contract."""

    def __init__(self, poa_cuda, smoke, banded_sweep, dev, root, reps):
        self.poa_cuda, self.smoke, self.sweep = poa_cuda, smoke, banded_sweep
        self.dev, self.root, self.reps = dev, root, reps
        self.live = "n_nodes" in inspect.signature(
            poa_cuda.poa_chain).parameters
        self.linear_live = "l_len" in inspect.signature(
            poa_cuda.poa_linear).parameters

    def fn(self, kernel, args, kw, n_nodes, max_live):
        wrapper = getattr(self.poa_cuda, kernel)
        if self.live:
            return lambda: wrapper(*args, **kw, n_nodes=n_nodes,
                                   max_live=max_live)
        return lambda: wrapper(*args, **kw)

    def time(self, case, kernel, args, kw, n_nodes, max_live):
        fn = self.fn(kernel, args, kw, n_nodes, max_live)
        ms = self.smoke.time_ms(fn, self.reps)
        dev_ms = self.sweep.kernel_device_ms(fn, self.reps, kernel)
        P, N = args[0].shape
        B = kw["band"]
        return dict(root=self.root, case=case, kernel=kernel,
                    shape=[P, N, B], max_live=max_live, ms=ms,
                    device_ms=dev_ms,
                    live_cells=live_cells(args[2], args[4], n_nodes, B),
                    band_cells=P * N * B)


    def time_linear(self, case, args, kw):
        """One poa_linear call, with its live extents (n_nodes, l_len in
        kw) where the tree takes them."""
        if not self.linear_live:
            kw = {k: v for k, v in kw.items() if k not in ("n_nodes",
                                                           "l_len")}
        wrapper = self.poa_cuda.poa_linear
        fn = lambda: wrapper(*args, **kw)   # noqa: E731
        ms = self.smoke.time_ms(fn, self.reps)
        dev_ms = self.sweep.kernel_device_ms(fn, self.reps, "poa_linear")
        return dict(root=self.root, case=case, kernel="poa_linear",
                    shape=[int(args[0].shape[0]), int(args[2].shape[0]) + 1],
                    ms=ms, device_ms=dev_ms)


# poa_linear's sweep: (real nodes, bin, query length, its bin), bubbled
# DAGs with forward predecessors, padded as poa_align pads them; the
# middle one is the shape of the largest call of chip_smoke's poa_msa
# groups
POA_LINEAR_CASES = ((60, 64, 100, 128), (427, 512, 381, 512),
                    (1000, 1024, 2000, 2048))


def live_cells(off, l_len, n_nodes, band) -> int:
    """The live cells of a launch (ops/poa_cuda.py::live_mask, restated
    here so that a tree without it is counted the same way): real nodes
    v < n, band cells b with off[v] + b <= L."""
    import torch
    v = torch.arange(off.shape[1], device=off.device)[None, :]
    width = (l_len.long()[:, None] + 1 - off.long()).clamp(0, band)
    return int(torch.where(v < n_nodes.long()[:, None], width, 0).sum())


def sweep(run, smoke, dev, only):
    """chip_smoke.py's POA checks (phase_poa_kernels_vs_plain's cases)."""
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)
    for k, (name, P, n, l, band) in enumerate(smoke.POA_SWEEP_CASES):
        case = f"{name} P {P} N {n} L {l} B {band}"
        if only not in case:
            continue
        inputs = smoke.poa_batch(k, P, n, l, band, chain=name == "poa_chain")
        args = [torch.from_numpy(x).to(dev) for x in inputs] + [sub]
        n_nodes = smoke.poa_used(args, band)[0].int()
        # what align_bin passes (an older tree takes none)
        max_live = (run.poa_cuda.check_live(
            inputs[1], inputs[2], inputs[4], n_nodes.cpu().numpy(), band)
            if run.live else None)
        kw = dict(band=band, **smoke.POA_GAPS)
        print(json.dumps(run.time(case, name, args, kw, n_nodes, max_live)),
              flush=True)
        del args
        torch.cuda.empty_cache()
    import numpy as np
    for k, (n, nb, l, lb) in enumerate(POA_LINEAR_CASES):
        case = f"poa_linear N {n} of {nb}, L {l} of {lb}"
        if only not in case:
            continue
        rng = np.random.default_rng(100 + k)
        bases = np.zeros(nb, np.uint8)
        preds = np.full((nb, 4), -1, np.int32)
        bases[:n], preds[:n] = smoke.poa_dag(rng, n, forward=4)
        q = np.full(lb, 5, np.uint8)
        q[:l] = rng.integers(0, 4, l)
        args = [torch.from_numpy(x).to(dev) for x in (bases, preds, q)]
        kw = dict(gap=30, match=10, mismatch=-15, n_nodes=n, l_len=l)
        print(json.dumps(run.time_linear(case, args, kw)), flush=True)


def replay(run, path, dev):
    """Every saved call one at a time, summed by bin (N, B)."""
    import torch
    saved = torch.load(path)
    for kernel, calls in saved.items():
        by_bin, total, dev_total = {}, 0.0, 0.0
        longest = (-1.0, None)
        for a, kw in calls:
            a = [x.to(dev) for x in a]
            if kernel == "poa_linear":
                line = run.time_linear("poa_msa replay", a, kw)
                key = f"{line['shape'][0]},{line['shape'][1]}"
            else:
                k = {x: v for x, v in kw.items() if x not in ("n_nodes",
                                                              "max_live")}
                line = run.time("poa path replay", kernel, a, k,
                                kw["n_nodes"].to(dev), kw["max_live"])
                key = f"{line['shape'][1]},{line['shape'][2]}"
            if line["ms"] > longest[0]:
                longest = (line["ms"], line["shape"])
            ms_b, n_b = by_bin.get(key, (0.0, 0))
            by_bin[key] = (ms_b + line["ms"], n_b + 1)
            total += line["ms"]
            dev_total = (None if dev_total is None or line["device_ms"] is None
                         else dev_total + line["device_ms"])
        print(json.dumps(dict(root=run.root, case="poa path replay",
                              kernel=kernel, calls=len(calls), ms=total,
                              device_ms=dev_total, by_bin=by_bin,
                              longest_ms=longest[0],
                              longest_shape=longest[1])), flush=True)


if __name__ == "__main__":
    sys.exit(main())
