"""BENCHMARK.json and the files it names, found by name.

- a cell: BENCHMARK.json `workloads` entry <name>;
- its traffic: gpubench/workloads/<traffic>.json (the call mix);
- its configuration: the `file` of the `configs` entry it names;
- its driver: gpubench/drivers/<driver>.py, named by the traffic file;
- a per-layer metric: gpubench/metrics/<name>.py, whose `read(ctx)`
  returns the value or None.

`problems` checks the manifest against the benchmark contract's schema.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
TRAFFIC_KEYS = {"name", "config", "driver", "calls", "checks", "variants",
                "sample_pairs"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, bench: dict | None = None, root: str = ROOT):
    """(the BENCHMARK.json entry, its configuration, its traffic) of a
    cell."""
    bench = bench or load(root)
    entry = _by_name(bench["workloads"], name, "workload")
    conf_entry = _by_name(bench["configs"], entry["config"], "config")
    with open(os.path.join(root, conf_entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "gpubench", "workloads",
                           f"{entry['traffic']}.json")) as fh:
        traffic = json.load(fh)
    return entry, config, traffic


def driver(traffic: dict):
    return importlib.import_module(f"gpubench.drivers.{traffic['driver']}")


def metrics_of(bench: dict, name: str, trace: bool):
    """The metrics a cell reports: end_to_end without the trace,
    per_layer with it; each only where its `workloads` holds the cell
    (or has no such key)."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(name: str):
    """The `read` of gpubench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gpubench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s \
        and "\t" not in s


def traffic_problems(root: str, name: str) -> list[str]:
    """Where a traffic file lacks a key the harness needs ([] if
    nowhere): the harness assumes no value for any of them."""
    path = os.path.join(root, "gpubench", "workloads", f"{name}.json")
    if not os.path.exists(path):
        return [f"traffic {name} file missing"]
    with open(path) as fh:
        traffic = json.load(fh)
    out = [f"traffic {name} lacks {k}"
           for k in sorted(TRAFFIC_KEYS - set(traffic))]
    for k in ("variants", "sample_pairs"):
        v = traffic.get(k)
        if k in traffic and not (isinstance(v, int) and v >= 1):
            out.append(f"traffic {name} {k} {v!r}")
    return out


def problems(bench: dict, root: str = ROOT) -> list[str]:
    """Where the manifest leaves the contract's schema ([] if nowhere)."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
        return out
    paths = bench["paths"]
    if not (1 <= len(paths) <= 16 and all(PATH.match(p) for p in paths)):
        out.append("paths")
    cmd = bench["command"]
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    if not (isinstance(bench["run_seconds"], int)
            and 1 <= bench["run_seconds"] <= 51):
        out.append("run_seconds")
    names = set()

    def name_ok(n, what):
        if not (isinstance(n, str) and NAME.match(n)):
            out.append(f"{what} name {n!r}")
        if n in names:
            out.append(f"duplicate name {n!r}")
        names.add(n)

    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
        name_ok(c["name"], "config")
        if not _line(c["source"]) or not _line(c["why"]):
            out.append(f"config {c['name']} source/why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config file {c['file']} outside paths")
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']} missing")
        if len(c["reduced"]) > 16 or not all(NAME.match(k)
                                             for k in c["reduced"]):
            out.append(f"config {c['name']} reduced")
    conf_names = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
        name_ok(w["name"], "workload")
        if w["config"] not in conf_names:
            out.append(f"workload {w['name']} config {w['config']}")
        if not NAME.match(w["traffic"]):
            out.append(f"workload {w['name']} traffic name")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']} repeats its config and traffic")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4) or not _line(w["why"]):
            out.append(f"workload {w['name']} chips/why")
        out.extend(traffic_problems(root, w["traffic"]))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for m in bench[kind]:
            if set(m) - {"workloads"} != keys:
                out.append(f"{kind} {m.get('name')} keys {sorted(m)}")
                continue
            name_ok(m["name"], kind)
            if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                                 "higher"):
                out.append(f"{m['name']} unit/better")
            if not set(m.get("workloads", cells)) <= cells:
                out.append(f"{m['name']} names an unknown cell")
            if kind == "end_to_end":
                if m["source"] not in E2E_SOURCES:
                    out.append(f"{m['name']} source")
                if not 0.01 <= m["bound"] <= 0.25:
                    out.append(f"{m['name']} bound")
            else:
                if m["source"] not in SOURCES or m["moves"] not in e2e \
                        or not _line(m["layer"]):
                    out.append(f"{m['name']} source/moves/layer")
                if not os.path.exists(os.path.join(
                        root, "gpubench", "metrics", f"{m['name']}.py")):
                    out.append(f"{m['name']} has no reader")
    for w in cells:
        e = {m["name"] for m in bench["end_to_end"]
             if w in m.get("workloads", cells)}
        p = [m for m in bench["per_layer"] if w in m.get("workloads", cells)]
        if "setup_s" not in e or len(e) < 2 or not p:
            out.append(f"cell {w} lacks a metric")
        for m in p:
            if m["moves"] not in e:
                out.append(f"{m['name']} moves a metric {w} lacks")
    return out
