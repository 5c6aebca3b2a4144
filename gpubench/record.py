"""Record the call mixes that the port's own paths send to its engines.

Runs deployments (by default the two of gpubench/configs: the
evolverMammals tree on the default path, the human-dog pair on the pecan
path; `--config-file` names others) through cactus_tpu_torch's
ProgressiveAligner at the configuration's root length and seed, with
the four engine entries wrapped:

- ops.banded.align_pairs_banded (and the names phases/blast.py and
  phases/bar.py import it under),
- ops.pairhmm.posterior_pairs_banded,
- ops.pairhmm5.posterior_pairs_banded5,
- ops.poa.poa_msa_batch (BAR's partial-order engine, which phases/bar.py
  imports at call time).

For every pair call it keeps the caller, the band, the keyword arguments
and each pair's (query, target) lengths, and reads the divergence of the
call's pairs from the engine's own answers: substitutions per aligned
column and gap opens per aligned column with their mean length (from the
CIGAR ops of a banded call; from consecutive hits of a pair-HMM call).
For every poa_msa_batch call it keeps each group's member lengths and
the PoaParams fields, and reads the same divergence from the engine's
graphs: member 0 (the longest, which seeds the graph) against every
other member, on the columns `match_runs_between_walks` gives; its
workload file holds the 2-member groups as pairs (`group_pairs`).  No
sequence is kept.  `--out DIR` gets every call (calls.json) and one
workload file per cell (`WORKLOADS` below) of the deployments run,
which are copied under gpubench/workloads/ by hand.

    python3 gpubench/record.py --out chiprun_out/record [--device cuda]
        [--config-file FILE ...]

A configuration's `bar_partial_order_alignment` 0 selects the pecan BAR
engine and `bar_msa_engine` sets Config.bar.msa_engine ("poa": the
partial-order engine).  The recording is made once; the benchmark's
runs never run this file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIGS = ("evolverMammals-default", "humanDog-pecan")

# cell -> (configuration, entry, the calls of that entry it keeps)
WORKLOADS = {
    "mammals-gapfill": ("evolverMammals-default", "align_pairs_banded",
                        lambda c: c["caller"] == "_fill_gaps_banded"
                        and c["band"] == 128),
    "mammals-nested": ("evolverMammals-default", "posterior_pairs_banded",
                       lambda c: True),
    "pecan-posterior": ("humanDog-pecan", "posterior_pairs_banded5",
                        lambda c: True),
    "mammals-poa": ("evolverMammals-abpoa", "poa_msa_batch",
                    lambda c: True),
}
DRIVERS = {"align_pairs_banded": "banded",
           "posterior_pairs_banded": "pairhmm",
           "posterior_pairs_banded5": "pairhmm5",
           "poa_msa_batch": "poa"}


def cigar_divergence(pairs, out):
    """(aligned columns, substitutions, gap opens, gap bases) of a banded
    call's answers: (score, ops) per pair."""
    import numpy as np
    cols = subs = opens = gap_bases = 0
    for (q, t), (_score, ops) in zip(pairs, out):
        i = j = 0
        q = np.asarray(q)
        t = np.asarray(t)
        for op, ln in ops:
            if op == "M":
                subs += int((q[i:i + ln] != t[j:j + ln]).sum())
                cols += ln
                i += ln
                j += ln
            else:
                opens += 1
                gap_bases += ln
                if op == "I":
                    i += ln
                else:
                    j += ln
    return cols, subs, opens, gap_bases


def hits_divergence(pairs, out):
    """The same four counts from a pair-HMM call's hits: each hit is an
    aligned column; a change of diagonal between consecutive hits is a
    gap open of that many bases."""
    import numpy as np
    cols = subs = opens = gap_bases = 0
    for (q, t), hits in zip(pairs, out):
        if not hits:
            continue
        q = np.asarray(q)
        t = np.asarray(t)
        h = np.asarray([(i, j) for i, j, _p in hits], dtype=np.int64)
        cols += len(h)
        subs += int((q[h[:, 0]] != t[h[:, 1]]).sum())
        shift = np.diff(h[:, 1] - h[:, 0])
        opens += int((shift != 0).sum())
        gap_bases += int(np.abs(shift).sum())
    return cols, subs, opens, gap_bases


def graph_divergence(groups, graphs):
    """The four counts from a poa_msa_batch call's graphs: for member 0
    of each group against every other member i, each column of the
    graph that holds a position of both is an aligned column (a
    substitution where their bases differ), and a change of diagonal
    between consecutive such columns a gap open of that many bases."""
    import numpy as np
    cols = subs = opens = gap_bases = 0
    for members, graph in zip(groups, graphs):
        by_member = {}
        for wi, pi, wj, pj in graph.match_runs_between_walks():
            if wi == 0 or wj == 0:
                i, p0, pm = (wj, pi, pj) if wi == 0 else (wi, pj, pi)
                by_member.setdefault(i, []).append((p0, pm))
        for i, cells in by_member.items():
            h = np.asarray(sorted(cells), dtype=np.int64)
            cols += len(h)
            subs += int((np.asarray(members[0])[h[:, 0]]
                         != np.asarray(members[i])[h[:, 1]]).sum())
            shift = np.diff(h[:, 1] - h[:, 0])
            opens += int((shift != 0).sum())
            gap_bases += int(np.abs(shift).sum())
    return cols, subs, opens, gap_bases


class Recorder:
    """Wraps one pair entry; thread-safe (the default path runs two
    ancestor steps at once)."""

    def __init__(self, name, fn, divergence):
        self.name, self.fn, self.divergence = name, fn, divergence
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, pairs, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(pairs, *args, **kw)
        wall = time.perf_counter() - t0
        caller = sys._getframe(1).f_code.co_name
        cols, subs, opens, gap_bases = self.divergence(pairs, out)
        band = kw.get("band", args[2] if len(args) > 2 else None)
        params = args[0] if args else kw.get("params")
        extra = {k: v for k, v in kw.items()
                 if k not in ("band", "device", "params")
                 and isinstance(v, (int, float, str, bool))}
        if self.name == "align_pairs_banded":
            submat, gap = args[0], args[1]
            extra["submat"] = [[int(x) for x in row] for row in submat]
            extra["gap_open"] = int(gap.gap_open)
            extra["gap_extend"] = int(gap.gap_extend)
        else:
            extra["params"] = {k: float(v) for k, v in
                               vars(params).items()}
        rec = {"entry": self.name, "caller": caller, "band": int(band),
               "pairs": [[len(q), len(t)] for q, t in pairs],
               "kw": extra, "wall_ms": wall * 1e3,
               "aligned_columns": cols, "substitutions": subs,
               "gap_opens": opens, "gap_bases": gap_bases}
        with self.lock:
            self.calls.append(rec)
        return out


class PoaRecorder:
    """Wraps ops.poa.poa_msa_batch (BAR's partial-order engine): each
    call's groups of member lengths, its PoaParams and its divergence
    from the engine's graphs; thread-safe."""

    name = "poa_msa_batch"

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, groups, params, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(groups, params, *args, **kw)
        wall = time.perf_counter() - t0
        caller = sys._getframe(1).f_code.co_name
        cols, subs, opens, gap_bases = graph_divergence(groups, out)
        rec = {"entry": self.name, "caller": caller,
               "groups": [[len(m) for m in g] for g in groups],
               "kw": {"params": {k: (list(v) if isinstance(v, tuple) else v)
                                 for k, v in vars(params).items()}},
               "wall_ms": wall * 1e3,
               "aligned_columns": cols, "substitutions": subs,
               "gap_opens": opens, "gap_bases": gap_bases}
        with self.lock:
            self.calls.append(rec)
        return out


def install(recorders):
    """Patch each entry where callers look it up; returns the undo list."""
    from cactus_tpu_torch.ops import banded, pairhmm, pairhmm5, poa
    from cactus_tpu_torch.phases import bar, blast
    sites = {"align_pairs_banded": (banded, blast, bar),
             "posterior_pairs_banded": (pairhmm,),
             "posterior_pairs_banded5": (pairhmm5,),
             "poa_msa_batch": (poa,)}
    undo = []
    for name, rec in recorders.items():
        for mod in sites[name]:
            undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, rec)
    return undo


def run_config(cfg_file, device, log, root_len=None):
    """One deployment through ProgressiveAligner.run(); returns its name
    and wall.  root_len overrides the configuration's (a rehearsal at a
    small size)."""
    from cactus_tpu_torch import progressive
    from cactus_tpu_torch.config import Config
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick

    with open(cfg_file) as fh:
        conf = json.load(fh)
    tree = parse_newick(conf["tree"])
    sim = evolver.simulate(tree, root_len=root_len or conf["root_len"],
                           seed=conf["path_seed"])
    leaves = tree.leaf_names()
    genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in leaves}
    cfg = Config.default()
    if conf.get("bar_partial_order_alignment") == 0:
        cfg.bar.partial_order_alignment = False
    if "bar_msa_engine" in conf:
        cfg.bar.msa_engine = conf["bar_msa_engine"]
    t0 = time.time()
    progressive.ProgressiveAligner(
        tree, genomes, config=cfg, tree_workers=conf["tree_workers"],
        device=device, log=lambda m: log(f"  [{conf['name']}] {m}")).run()
    return conf["name"], time.time() - t0


def summarize_poa(calls):
    """Per poa_msa_batch call: its groups, their members and lengths, its
    wall and substitution rate."""
    rows = []
    for c in calls:
        if c["entry"] != "poa_msa_batch":
            continue
        members = [len(g) for g in c["groups"]]
        lengths = [x for g in c["groups"] for x in g]
        rows.append({
            "entry": c["entry"], "caller": c["caller"],
            "groups": len(members), "members": sum(members),
            "members_a_group": [min(members, default=0),
                                max(members, default=0)],
            "member_len": [min(lengths, default=0), max(lengths, default=0)],
            "bases": sum(lengths), "wall_ms": round(c["wall_ms"], 3),
            "substitution_rate": round(
                c["substitutions"] / max(1, c["aligned_columns"]), 6)})
    return rows


def summarize(calls):
    """Per entry and band: calls, pairs, the widest shapes (pair entries;
    summarize_poa gives poa_msa_batch's)."""
    rows = {}
    for c in calls:
        if c["entry"] == "poa_msa_batch":
            continue
        key = (c["entry"], c["caller"], c["band"])
        r = rows.setdefault(key, [0, 0, 0, 0, 0.0])
        r[0] += 1
        r[1] += len(c["pairs"])
        r[2] = max(r[2], max(m for m, _n in c["pairs"]))
        r[3] += sum(m + n for m, n in c["pairs"])
        r[4] += c["wall_ms"]
    return [{"entry": k[0], "caller": k[1], "band": k[2], "calls": v[0],
             "pairs": v[1], "longest_query": v[2], "bases": v[3],
             "wall_ms": round(v[4], 3)} for k, v in sorted(rows.items())]


def group_pairs(groups):
    """A poa_msa_batch call's groups as pairs of lengths: gpubench/traffic
    makes pairs, which a partial-order driver passes on as groups of two
    members.  A group of another size has no traffic yet."""
    if any(len(g) != 2 for g in groups):
        sizes = sorted({len(g) for g in groups})
        raise ValueError(f"groups of {sizes} members: gpubench/traffic.py "
                         "makes only pairs (groups of two)")
    return [list(g) for g in groups]


def workload(cell, calls, commit, device_name):
    config, entry, keep = WORKLOADS[cell]
    kept = [c for c in calls if c["entry"] == entry and keep(c)]
    mix = []
    for c in kept:
        cols = max(1, c["aligned_columns"])
        opens = c["gap_opens"]
        shape = ({"pairs": group_pairs(c["groups"])} if "groups" in c
                 else {"band": c["band"], "pairs": c["pairs"]})
        mix.append({**shape,
                    "kw": {k: v for k, v in c["kw"].items()
                           if k not in ("submat", "gap_open", "gap_extend")},
                    "substitution_rate": round(c["substitutions"] / cols, 6),
                    "gap_open_rate": round(opens / cols, 6),
                    "gap_mean_length": round(
                        c["gap_bases"] / opens if opens else 1.0, 3)})
    return {"name": cell, "config": config, "driver": DRIVERS[entry],
            "recorded": {
                "how": ("gpubench/record.py: the configuration's path through "
                        "cactus_tpu_torch ProgressiveAligner.run() with the "
                        f"entry {entry} wrapped; each call's "
                        + ("2-member groups as pairs of lengths"
                           if entry == "poa_msa_batch"
                           else "pair lengths, band")
                        + " and keyword arguments, and its divergence read "
                        "from the engine's own answers"),
                "commit": commit, "device": device_name},
            "calls": mix}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--commit", default="unknown")
    ap.add_argument("--configs", default="",
                    help="names of gpubench/configs, comma-separated "
                    "(default: both, unless --config-file is given)")
    ap.add_argument("--config-file", action="append", default=[],
                    help="a configuration file to run, by path")
    ap.add_argument("--root-len", type=int, default=None,
                    help="override the root length (a rehearsal)")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from cactus_tpu_torch.ops import banded, pairhmm, pairhmm5, poa

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    dev = torch.device(a.device)
    on_card = dev.type == "cuda"
    recs = {"align_pairs_banded": Recorder(
                "align_pairs_banded", banded.align_pairs_banded,
                cigar_divergence),
            "posterior_pairs_banded": Recorder(
                "posterior_pairs_banded", pairhmm.posterior_pairs_banded,
                hits_divergence),
            "posterior_pairs_banded5": Recorder(
                "posterior_pairs_banded5", pairhmm5.posterior_pairs_banded5,
                hits_divergence),
            "poa_msa_batch": PoaRecorder(poa.poa_msa_batch)}
    names = [n for n in a.configs.split(",") if n]
    files = [os.path.join(ROOT, "gpubench", "configs", f"{n}.json")
             for n in (names or ([] if a.config_file else DEFAULT_CONFIGS))]
    undo = install(recs)
    walls, peaks = {}, {}
    try:
        for cfg_file in files + a.config_file:
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            name, walls[name] = run_config(cfg_file, dev, log, a.root_len)
            if on_card:
                peaks[name] = torch.cuda.max_memory_allocated(dev)
            log(f"{name}: ProgressiveAligner.run {walls[name]:.1f} s, "
                f"device peak {peaks.get(name)} bytes")
    finally:
        for mod, name, fn in reversed(undo):
            setattr(mod, name, fn)
    calls = [c for r in recs.values() for c in r.calls]
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "calls.json"), "w") as fh:
        json.dump({"walls_s": walls, "peak_bytes": peaks, "calls": calls},
                  fh)
    summary = summarize(calls) + summarize_poa(calls)
    for row in summary:
        log(json.dumps(row))
    device_name = (torch.cuda.get_device_name(dev) if on_card else "cpu")
    for cell, (config, _entry, _keep) in WORKLOADS.items():
        if config in walls:
            with open(os.path.join(a.out, f"{cell}.json"), "w") as fh:
                json.dump(workload(cell, calls, a.commit, device_name), fh)
    print(json.dumps({"walls_s": walls, "peak_bytes": peaks,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
