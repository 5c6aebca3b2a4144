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

With --only wide, the wide route (rows past the widest team cover, the
cluster kernels of csrc/poa_cluster.cu): phase 8's calls
(poa_align_affine of its 20,000-base query against the chain and the
bubbled graph, poa_align against both, and the direct poa_affine call on
moving band offsets), the widths past the cluster's register instance
(max_live 72,001 for poa_chain / poa_affine, 70,001 for poa_linear), and,
in a tree that can force the route (`poa_cuda._launch`), the team kernels
against the forced cluster at max_live 4,096, 8,192 and 16,384.  Each
wide line gives us_per_node (the longest problem's real nodes) and, in a
tree with the clusters, the cluster and a latency line (the nodes x
chip_smoke.poa_cluster_node_steps x one shuffle step); each call is first
held to the plain version on its live cells (--no-check skips that, to
time a copy with a part of a kernel taken out).

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
    ap.add_argument("--no-check", action="store_true",
                    help="time the wide cases without holding them to the "
                    "plain version")
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
    if "wide" in args.only:
        wide(run, smoke, dev, not args.no_check, args.only)
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
        # the route to force (wide()'s team-vs-cluster cases), None for
        # the wrappers' own
        self.route = None

    def fn(self, kernel, args, kw, n_nodes, max_live):
        wrapper = getattr(self.poa_cuda, kernel)
        if self.route is not None:
            # the named route of a tree that can force it
            gaps = tuple(kw[k] for k in ("o1", "e1", "o2", "e2"))
            return lambda: self.poa_cuda._launch(
                kernel, *args, kw["band"], gaps, n_nodes, max_live,
                self.route)
        if self.live:
            return lambda: wrapper(*args, **kw, n_nodes=n_nodes,
                                   max_live=max_live)
        return lambda: wrapper(*args, **kw)

    def time(self, case, kernel, args, kw, n_nodes, max_live, key=None):
        """One call's time; key: the device kernel's name to read from the
        profiler (default: the wrapper's)."""
        fn = self.fn(kernel, args, kw, n_nodes, max_live)
        ms = self.smoke.time_ms(fn, self.reps)
        dev_ms = self.sweep.kernel_device_ms(fn, self.reps, key or kernel)
        P, N = args[0].shape
        B = kw["band"]
        return dict(root=self.root, case=case, kernel=kernel,
                    shape=[P, N, B], max_live=max_live, ms=ms,
                    device_ms=dev_ms,
                    live_cells=live_cells(args[2], args[4], n_nodes, B),
                    band_cells=P * N * B)


    def linear_fn(self, args, kw):
        """One poa_linear call, with its live extents (n_nodes, l_len in
        kw) where the tree takes them, on the forced route where one is
        set."""
        if self.route is not None:
            return lambda: self.poa_cuda._launch_linear(
                *args, kw["gap"], kw["match"], kw["mismatch"], kw["n_nodes"],
                kw["l_len"], self.route)
        if not self.linear_live:
            kw = {k: v for k, v in kw.items() if k not in ("n_nodes",
                                                           "l_len")}
        wrapper = self.poa_cuda.poa_linear
        return lambda: wrapper(*args, **kw)

    def time_linear(self, case, args, kw):
        """Times linear_fn's call."""
        fn = self.linear_fn(args, kw)
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


def wide_calls(smoke, dev):
    """Phase 8's POA calls, captured at the wrappers (poa_chain,
    poa_affine, poa_linear) while poa_align_affine and poa_align run its
    query against the chain and the bubbled graph on the CPU: [(case,
    kernel, args, kw)] on `dev`."""
    import numpy as np
    import torch
    from cactus_tpu_torch.ops import poa as tpoa
    from cactus_tpu_torch.ops import poa_cuda
    chain_g, bub_g, query = smoke.wide_poa_inputs(
        np.random.default_rng(smoke.WIDE_SEED))
    saved = {k: getattr(poa_cuda, k)
             for k in ("poa_chain", "poa_affine", "poa_linear")}
    calls = []

    def on(x):
        return x.to(dev) if torch.is_tensor(x) else x

    def recorder(kernel):
        def record(*a, **k):
            calls.append([kernel, [on(x) for x in a],
                          {x: on(v) for x, v in k.items()}])
            return saved[kernel](*a, **k)
        return record

    try:
        for kernel in saved:
            setattr(poa_cuda, kernel, recorder(kernel))
        for graph, g in (("chain", chain_g), ("bubbled", bub_g)):
            tpoa.poa_align_affine(g, query, device="cpu")
            calls[-1].insert(0, f"wide phase 8 {graph} graph")
            tpoa.poa_align(g, query, device="cpu")
            calls[-1].insert(0, f"wide phase 8 linear {graph} graph")
    finally:
        for kernel, fn in saved.items():
            setattr(poa_cuda, kernel, fn)
    return [tuple(c) for c in calls]


def _held(what, got, ref, live):
    import torch
    if not all(torch.equal(g[m], r[m]) for g, r, m in zip(got[:2], ref[:2],
                                                         live)):
        raise AssertionError(f"{what}: differs from the plain version on "
                             "the live cells")


def wide(run, smoke, dev, check, only="wide"):
    """The wide route's cases (module docstring) whose name holds `only`,
    each held to the plain version first unless check is False."""
    import numpy as np
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import poa as tpoa
    pc = run.poa_cuda
    clusters = hasattr(pc, "cluster_shape")
    step_ns, step_what = smoke.smem_step_ns()
    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)

    def latency(line, max_live, nodes, linear):
        line["us_per_node"] = line["ms"] * 1e3 / nodes
        if clusters and run.route in (None, "wide"):
            steps = smoke.poa_cluster_node_steps(max_live, linear)
            line["cluster"] = smoke.poa_cluster_line(max_live, linear)
            line["latency_ms"] = nodes * steps * step_ns / 1e6
            line["latency_line"] = (f"{nodes} x {steps} steps x "
                                    f"{step_ns:.2f} ns ({step_what})")
        return line

    def affine(case, kernel, args, kw, n_nodes, max_live):
        if only not in case:
            return
        if check:
            got = run.fn(kernel, args, kw, n_nodes, max_live)()
            ref = tpoa.poa_align_scan_affine(*args, **kw)
            live = pc.live_mask(args[2], args[4], n_nodes, kw["band"])
            _held(case, got, ref, (live, live))
            del got, ref
        # the call launches one kernel: the team kernel's, the cluster
        # kernel or an older tree's wide kernel
        line = run.time(case, kernel, args, kw, n_nodes, max_live, "poa_")
        print(json.dumps(latency(line, max_live, int(n_nodes.max()), False)),
              flush=True)

    def linear(case, args, kw):
        if only not in case:
            return
        if check:
            got = run.linear_fn(args, kw)()
            ref = tpoa.poa_align_scan(*args, **{k: kw[k] for k in (
                "gap", "match", "mismatch")})
            live = pc.linear_live_mask(args[0].shape[0], args[2].shape[0],
                                       kw["n_nodes"], kw["l_len"], dev)
            _held(case, got, ref, (live, live))
            del got, ref
        line = run.time_linear(case, args, kw)
        print(json.dumps(latency(line, kw["l_len"] + 1, kw["n_nodes"], True)),
              flush=True)

    for case, kernel, a, k in wide_calls(smoke, dev):
        if kernel == "poa_linear":
            linear(case, a, k)
        else:
            kw = {x: v for x, v in k.items() if x not in ("n_nodes",
                                                         "max_live")}
            affine(case, kernel, a, kw, k["n_nodes"], k["max_live"])
    gaps = dict(band=smoke.WIDE_POA_BAND, **smoke.POA_GAPS)
    # the direct call on moving band offsets, and the widths past the
    # register instance
    cases = [("wide phase 8 offsets", "poa_affine", smoke.poa_offset_batch(
        smoke.WIDE_POA_OFFSET_SEED, 3, 64, smoke.WIDE_POA_OFFSET_L,
        smoke.WIDE_POA_BAND, chain=False, n_lo=40), gaps)]
    for kernel in ("poa_chain", "poa_affine"):
        cases.append((f"wide global scratch {kernel}", kernel,
                      smoke.poa_offset_batch(72000 + 131072, 1, 16, 72000,
                                             131072, chain=kernel ==
                                             "poa_chain", n_lo=16, far=12),
                      dict(gaps, band=131072)))
    for case, kernel, inputs, kw in cases:
        t = [torch.from_numpy(x).to(dev) for x in inputs]
        max_live = pc.check_live(inputs[1], inputs[2], inputs[4], inputs[5],
                                 kw["band"])
        affine(case, kernel, t[:5] + [sub], kw, t[5], max_live)
        del t
        torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    bases, preds = smoke.poa_dag(rng, 16, forward=3)
    q = rng.integers(0, 4, 70000).astype(np.uint8)
    linear("wide global scratch poa_linear",
           [torch.from_numpy(x).to(dev) for x in (bases, preds, q)],
           dict(gap=30, match=10, mismatch=-15, n_nodes=16, l_len=70000))
    if not hasattr(pc, "_launch"):
        return
    # team against the forced cluster, one 64-node problem whose query
    # fills the band (offsets 0, max_live = W)
    for W in (4096, 8192, 16384):
        for kernel in ("poa_chain", "poa_affine"):
            inputs = smoke.poa_offset_batch(W, 1, 64, W - 1, W,
                                            chain=kernel == "poa_chain")
            t = [torch.from_numpy(x).to(dev) for x in inputs]
            kw = dict(gaps, band=W)
            for run.route in ("team", "wide"):
                label = "cluster" if run.route == "wide" else "team"
                affine(f"wide {label} {kernel} max_live {W}", kernel,
                       t[:5] + [sub], kw, t[5], W)
        rng = np.random.default_rng(W)
        bases, preds = smoke.poa_dag(rng, 64, forward=3)
        q = rng.integers(0, 4, W - 1).astype(np.uint8)
        args = [torch.from_numpy(x).to(dev) for x in (bases, preds, q)]
        for run.route in ("team", "wide"):
            label = "cluster" if run.route == "wide" else "team"
            linear(f"wide {label} poa_linear max_live {W}", args,
                   dict(gap=30, match=10, mismatch=-15, n_nodes=64,
                        l_len=W - 1))
    run.route = None


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
