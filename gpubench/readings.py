"""The two readings each limit of `correct` is set from.

For a cell and a list of seeds, in one process on the card: the
program's numbers (one pass over every variant, through the entry at
the cell's own calls and sizes, every sampled answer compared as a run
compares it) and the control's (the reference at the precision below the
configuration's, int16 for the banded DP, bfloat16 for the pair-HMMs, in
the program's place on the same sampled pairs).  One JSON line a seed
and side, then the largest program reading and the smallest control
reading of each number.

    python3 gpubench/readings.py --workload pecan-posterior \\
        --seeds 11,12,... [--control-seeds 11,12,13]

The benchmark's runs never run this file; gpubench/tests runs it at a
small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name, seeds, control_seeds, device, root=None, log=print):
    """{"program": {number: [reading a seed]}, "control": {...}}."""
    from gpubench import harness, manifest, traffic
    root = root or manifest.ROOT
    entry, config, workload = manifest.cell(name, manifest.load(root), root)
    drv = manifest.driver(workload).Driver(config, workload, device)
    calls = workload["calls"]
    out = {"program": {}, "control": {}}
    for who, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            variants = traffic.make_variants(workload, seed)
            sample = harness.choose_sample(workload, variants, seed)
            kept = {}
            t0 = time.perf_counter()
            for (v, c), idxs in sample.items():
                pairs = variants[v][c]
                if who == "program":
                    answers = drv.call(calls[c], pairs)
                    kept[(v, c)] = {i: [answers[i]] for i in idxs}
                else:
                    answers = drv.control(calls[c], [pairs[i] for i in idxs])
                    kept[(v, c)] = {i: [a] for i, a in zip(idxs, answers)}
            t1 = time.perf_counter()
            numbers, compared = harness.check(drv, calls, variants, sample,
                                              kept, dict.fromkeys(kept, 1))
            t2 = time.perf_counter()
            for k in drv.checks:
                out[who].setdefault(k, []).append(numbers[k])
            log(json.dumps({"who": who, "seed": seed, **numbers,
                            "compared": compared,
                            "answers_s": round(t1 - t0, 3),
                            "reference_s": round(t2 - t1, 3)}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gpubench import harness, manifest
    entry = [w for w in manifest.load()["workloads"]
             if w["name"] == a.workload][0]
    device = harness.check_device(entry["chips"])

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    out = readings(a.workload, seeds(a.seeds), seeds(a.control_seeds),
                   device, log=lambda s: print(s, flush=True))
    summary = {"workload": a.workload,
               "card": torch.cuda.get_device_name(device),
               "program_max": {k: max(v) for k, v in out["program"].items()},
               "control_min": {k: min(v) for k, v in out["control"].items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
