"""A small copy of the benchmark's data for the CPU tests: the real
BENCHMARK.json and configurations, each traffic file cut to a few short
pairs a call."""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import manifest  # noqa: E402


def small_root(tmp, max_pairs: int = 4, max_len: int = 48,
               calls: int = 2, min_len: int = 1) -> str:
    """A root under tmp holding BENCHMARK.json, gpubench/configs and
    gpubench/workloads with every call cut to max_pairs pairs of at most
    max_len bases (the length difference kept inside the band)."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(os.path.join(root, "gpubench", "workloads"), exist_ok=True)
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(manifest.HERE, "configs"),
                    os.path.join(root, "gpubench", "configs"))
    for w in manifest.load()["workloads"]:
        src = os.path.join(manifest.HERE, "workloads",
                           f"{w['traffic']}.json")
        with open(src) as fh:
            traffic = json.load(fh)
        cut = []
        for call in traffic["calls"][:calls]:
            call = dict(call)
            call["pairs"] = [[max(min_len, min(m, max_len)),
                              max(min_len, min(n, max_len))]
                             for m, n in call["pairs"][:max_pairs]]
            cut.append(call)
        traffic["calls"] = cut
        traffic["variants"] = 2
        with open(os.path.join(root, "gpubench", "workloads",
                               f"{w['traffic']}.json"), "w") as fh:
            json.dump(traffic, fh)
    return root
