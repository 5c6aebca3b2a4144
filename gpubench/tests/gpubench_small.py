"""A small copy of the benchmark's data for the CPU tests: the real
BENCHMARK.json and configurations, each traffic file cut to a few short
pairs a call, and the retired cells put back."""

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


def retired() -> list:
    """The cells left out of BENCHMARK.json, each as gpubench/retired/
    <name>.json keeps it: its workload entry, its own metrics and the
    shared metrics that named it."""
    here = os.path.join(manifest.HERE, "retired")
    out = []
    for f in sorted(os.listdir(here)):
        if f.endswith(".json"):
            with open(os.path.join(here, f)) as fh:
                out.append(json.load(fh))
    return out


def with_retired(bench: dict) -> dict:
    """A copy of the manifest with the retired cells put back."""
    bench = json.loads(json.dumps(bench))
    have = {w["name"] for w in bench["workloads"]}
    for cell in retired():
        name = cell["workload"]["name"]
        if name in have:
            continue
        bench["workloads"].append(cell["workload"])
        for kind in ("end_to_end", "per_layer"):
            bench[kind] += cell[kind]
            for m in bench[kind]:
                if m["name"] in cell["shared"]:
                    m["workloads"].append(name)
    return bench


def small_root(tmp, max_pairs: int = 4, max_len: int = 48,
               calls: int = 2, min_len: int = 1) -> str:
    """A root under tmp holding BENCHMARK.json, gpubench/configs and
    gpubench/workloads with every call cut to max_pairs pairs of at most
    max_len bases (the length difference kept inside the band), and the
    retired cells put back (`with_retired`)."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(os.path.join(root, "gpubench", "workloads"), exist_ok=True)
    shutil.copytree(os.path.join(manifest.HERE, "configs"),
                    os.path.join(root, "gpubench", "configs"))
    bench = with_retired(manifest.load())
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    for w in bench["workloads"]:
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
