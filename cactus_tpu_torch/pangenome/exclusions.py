"""Pangenome exclusions accounting: the standalone report.

Reference: graphmap-join writes per-tier exclusion beds
(<out>.clip.bed, filter.bed) and the HPRC QC pipeline sums them into a
per-sample "what was left out of the graph" table.  This module turns
the tier beds + graphs into that report and ENFORCES the closure
invariant: for every input sequence, retained bp in the tier graph +
excluded bp in all beds up to that tier == input length.
"""

from __future__ import annotations

import json

from ..io.fasta import Sequence
from .graph import PanGraph, _frag_name


def _retained_bp(graph: PanGraph) -> dict[str, int]:
    """Original sequence name → bp present in the graph's walks."""
    out: dict[str, int] = {}
    for name, walk in graph.walks.items():
        orig, _, _ = _frag_name(name, 0, 0)
        out[orig] = out.get(orig, 0) + sum(
            graph.node_len(v) for v, _o in walk)
    return out


def exclusions_report(seqs: dict[str, Sequence],
                      tiers: dict[str, tuple[PanGraph,
                                             dict[str, list[tuple[int,
                                                                  int]]]]],
                      ) -> dict:
    """Build the report.

    `tiers` maps tier name → (graph, bed) in pipeline order (e.g.
    {"clip": (clip_graph, clip_bed), "filter": (filt, filt_bed)}); each
    bed holds that tier's newly removed absolute intervals.  Returns
    {sample: {seq: {...}}, "totals": {...}} and raises AssertionError
    if any tier breaks the closure invariant.
    """
    cumulative: dict[str, int] = {n: 0 for n in seqs}
    report: dict = {"samples": {}, "totals": {}}
    tier_tot: dict[str, int] = {}
    for tname, (graph, bed) in tiers.items():
        retained = _retained_bp(graph)
        removed_now: dict[str, int] = {}
        for name, ivs in bed.items():
            removed_now[name] = sum(b - a for a, b in ivs)
        tot_removed = 0
        for name, seq in seqs.items():
            cumulative[name] += removed_now.get(name, 0)
            got = retained.get(name, 0) + cumulative[name]
            assert got == len(seq), (
                f"closure broken at tier {tname} for {name}: "
                f"{retained.get(name, 0)} retained + {cumulative[name]} "
                f"excluded != {len(seq)} input")
            sample = name.split(".", 1)[0]
            srec = report["samples"].setdefault(sample, {})
            rec = srec.setdefault(name, {"input_bp": len(seq)})
            rec[f"{tname}_excluded_bp"] = removed_now.get(name, 0)
            rec[f"{tname}_intervals"] = len(bed.get(name, []))
            rec[f"{tname}_retained_bp"] = retained.get(name, 0)
            tot_removed += removed_now.get(name, 0)
        tier_tot[tname] = tot_removed
    report["totals"] = {
        "input_bp": int(sum(len(s) for s in seqs.values())),
        **{f"{t}_excluded_bp": v for t, v in tier_tot.items()},
    }
    return report


def write_exclusions(path: str, report: dict) -> None:
    """TSV (one row per input sequence) + .json sidecar."""
    tiers = sorted({k.rsplit("_", 2)[0]
                    for srec in report["samples"].values()
                    for rec in srec.values() for k in rec
                    if k.endswith("_excluded_bp")})
    with open(path, "w") as fh:
        cols = ["sample", "sequence", "input_bp"]
        for t in tiers:
            cols += [f"{t}_excluded_bp", f"{t}_intervals",
                     f"{t}_retained_bp"]
        fh.write("#" + "\t".join(cols) + "\n")
        for sample in sorted(report["samples"]):
            for name in sorted(report["samples"][sample]):
                rec = report["samples"][sample][name]
                row = [sample, name, str(rec["input_bp"])]
                for t in tiers:
                    row += [str(rec.get(f"{t}_excluded_bp", 0)),
                            str(rec.get(f"{t}_intervals", 0)),
                            str(rec.get(f"{t}_retained_bp",
                                        rec["input_bp"]))]
                fh.write("\t".join(row) + "\n")
    with open(path + ".json", "w") as fh:
        json.dump(report, fh, indent=1)
