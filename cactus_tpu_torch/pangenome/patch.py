"""Assembly patching through the pangenome graph (panpatch analog).

Reference: cactus-panpatch (refmap/cactus_panpatch.py:1-18) chains
cactus-pangenome with glennhickey/panpatch, which uses the per-
chromosome graphs to patch a fragmented assembly into T2T
chromosomes: scaffold disconnected contigs, fill the gaps with donor
sequence, and optionally complete missing terminal telomeres from a
donor.

Native version: the target's contig walks are located on a donor
haplotype's walk by their terminal shared (anchor) nodes; contigs that
place colinearly on one donor are spliced together with the donor's
node path between their anchors, and `require_telomeres` extends the
ends with the donor's terminal path.  Everything is node-exact: the
patched sequence is spelled from graph nodes, so target bases are
preserved verbatim and filler bases come verbatim from the donor.
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import Sequence, revcomp
from .graph import PanGraph


def _spell(graph: PanGraph, walk) -> np.ndarray:
    parts = [graph.node_seq[v] if o == 1 else revcomp(graph.node_seq[v])
             for v, o in walk]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def _unique_steps(walk) -> dict[int, int]:
    """node → step index, for nodes visited exactly once."""
    count: dict[int, int] = {}
    for v, _o in walk:
        count[v] = count.get(v, 0) + 1
    return {v: i for i, (v, _o) in enumerate(walk) if count[v] == 1}


def _anchor(walk, donor_steps, from_end: bool):
    """(step in walk, donor step) of the outermost shared unique node."""
    rng = range(len(walk) - 1, -1, -1) if from_end else range(len(walk))
    for i in rng:
        v, _o = walk[i]
        if v in donor_steps:
            return i, donor_steps[v]
    return None


def patch_assembly(graph: PanGraph, target_event: str,
                   donor_priority: list[str],
                   require_telomeres: bool = False
                   ) -> tuple[dict[str, Sequence], dict]:
    """Scaffold + gap-fill the target event's contigs along donors.

    Returns (patched sequences, report).  Contigs placing colinearly on
    the highest-priority donor that anchors ≥1 contig are spliced in
    donor order; unplaced contigs pass through unchanged.
    """
    targets = {n: w for n, w in graph.walks.items()
               if n.split(".", 1)[0] == target_event}
    report: dict = {"placed": [], "unplaced": [], "donor_bp": 0,
                    "donor": None}
    patched: dict[str, Sequence] = {}
    placed_names: set[str] = set()

    for donor_name in donor_priority:
        donor_walks = {n: w for n, w in graph.walks.items()
                       if n.split(".", 1)[0] == donor_name}
        for dw_name, dw in donor_walks.items():
            donor_steps = _unique_steps(dw)
            placements = []
            for name, w in targets.items():
                if name in placed_names:
                    continue
                a0 = _anchor(w, donor_steps, from_end=False)
                a1 = _anchor(w, donor_steps, from_end=True)
                if a0 is None or a1 is None:
                    continue
                (s0, d0), (s1, d1) = a0, a1
                fwd = d0 <= d1
                placements.append((min(d0, d1), name, fwd, s0, s1))
            if len(placements) < 2 and not (placements
                                            and require_telomeres):
                continue
            placements.sort()
            # check colinearity: donor intervals must not interleave
            steps_out: list = []
            prev_donor_end = None
            used = []
            for dpos, name, fwd, s0, s1 in placements:
                w = targets[name]
                walk = w if fwd else [(v, -o) for v, o in reversed(w)]
                # anchors in oriented walk coords
                ds = _unique_steps(walk)
                a0 = _anchor(walk, donor_steps, from_end=False)
                a1 = _anchor(walk, donor_steps, from_end=True)
                w0, dd0 = a0
                w1, dd1 = a1
                if prev_donor_end is not None:
                    if dd0 <= prev_donor_end:
                        continue        # overlaps previous: skip
                    # donor filler strictly between anchors
                    filler = dw[prev_donor_end + 1:dd0]
                    steps_out.extend(filler)
                    report["donor_bp"] += int(sum(
                        graph.node_len(v) for v, _o in filler))
                elif require_telomeres and dd0 > 0:
                    lead = dw[:dd0]
                    steps_out.extend(lead)
                    report["donor_bp"] += int(sum(
                        graph.node_len(v) for v, _o in lead))
                steps_out.extend(walk)
                prev_donor_end = dd1
                used.append(name)
            if len(used) < 2 and not (used and require_telomeres):
                continue
            if require_telomeres and prev_donor_end is not None \
                    and prev_donor_end + 1 < len(dw):
                tail = dw[prev_donor_end + 1:]
                steps_out.extend(tail)
                report["donor_bp"] += int(sum(
                    graph.node_len(v) for v, _o in tail))
            out_name = f"{target_event}.patched_{dw_name.split('.')[-1]}"
            patched[out_name] = Sequence(out_name,
                                         _spell(graph, steps_out))
            placed_names.update(used)
            report["placed"].extend(used)
            report["donor"] = donor_name
        if report["placed"]:
            break
    for name, w in targets.items():
        if name not in placed_names:
            patched[name] = Sequence(name, _spell(graph, w))
            report["unplaced"].append(name)
    return patched, report
