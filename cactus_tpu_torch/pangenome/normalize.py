"""Walk-preserving shared-affix normalization (GFAffix analog).

The reference's graphmap-join runs GFAffix to collapse "shared affixes":
parallel bubble arms that begin (or end) with the same bases get that
shared run split into one common node, shrinking the graph and making
bubbles minimal (refmap/cactus_graphmap_join.py:652+, downloaded GFAffix
binary).  Here the same normalization operates on PanGraph directly:

 - for every attachment context (a node side, or a walk start), gather
   the distinct successor steps across all walks;
 - successors whose EVERY occurrence uses that same context are eligible
   (rewriting them cannot disturb any other path — the conservative
   subset of GFAffix, which duplicates nodes in the general case);
 - eligible successors sharing an oriented prefix have it factored into
   a new node, inserted into every affected walk;
 - the suffix direction is handled by reversing all walks and re-running
   the prefix pass.

Walk spelling is invariant by construction; PanGraph.validate() is the
oracle.
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import revcomp
from .graph import PanGraph

_START = ("start",)


def _oriented(pg: PanGraph, v: int, o: int) -> np.ndarray:
    c = pg.node_seq[v]
    return c if o == 1 else revcomp(c)


def _common_prefix_len(seqs: list[np.ndarray]) -> int:
    n = min(len(s) for s in seqs)
    if n == 0:
        return 0
    stack = np.stack([s[:n] for s in seqs])
    same = (stack == stack[0]).all(axis=0)
    bad = np.flatnonzero(~same)
    return int(bad[0]) if len(bad) else n


def _collapse_prefixes_once(pg: PanGraph) -> bool:
    """One forward pass: factor shared prefixes out of eligible
    successors.  Returns True if anything changed."""
    # context of every occurrence of every node
    ctx: dict[int, set] = {}
    succ: dict[tuple, set] = {}           # side -> {(v, ov)}
    occs: dict[int, list[tuple[str, int, int]]] = {}
    for name, walk in pg.walks.items():
        prev = None
        for i, (v, ov) in enumerate(walk):
            side = _START if prev is None else prev
            ctx.setdefault(v, set()).add((side, ov))
            succ.setdefault(side, set()).add((v, ov))
            occs.setdefault(v, []).append((name, i, ov))
            prev = (v, ov)

    rewrites: dict[str, dict[int, list[tuple[int, int]]]] = {}
    changed = False
    claimed: set[int] = set()
    for side, steps in succ.items():
        eligible = [(v, ov) for (v, ov) in steps
                    if v not in claimed and ctx.get(v) == {(side, ov)}
                    and pg.node_len(v) > 0]
        if len(eligible) < 2:
            continue
        by_first: dict[int, list[tuple[int, int]]] = {}
        for v, ov in eligible:
            first = int(_oriented(pg, v, ov)[0])
            by_first.setdefault(first, []).append((v, ov))
        for group in by_first.values():
            if len(group) < 2:
                continue
            seqs = [_oriented(pg, v, ov) for v, ov in group]
            L = _common_prefix_len(seqs)
            if L == 0:
                continue
            p = len(pg.node_seq)
            pg.node_seq.append(seqs[0][:L].copy())
            pg.node_block.append(-1)
            for (v, ov), s in zip(group, seqs):
                claimed.add(v)
                rest = s[L:]
                if len(rest):
                    pg.node_seq[v] = rest if ov == 1 else revcomp(rest)
                    repl = [(p, 1), (v, ov)]
                else:
                    pg.node_seq[v] = rest  # orphaned; compact() drops it
                    repl = [(p, 1)]
                for name, i, _o in occs[v]:
                    rewrites.setdefault(name, {})[i] = repl
            changed = True
    for name, plan in rewrites.items():
        walk = pg.walks[name]
        out: list[tuple[int, int]] = []
        for i, step in enumerate(walk):
            out.extend(plan.get(i, [step]))
        pg.walks[name] = out
    return changed


def _reverse_walks(pg: PanGraph) -> None:
    for name, walk in pg.walks.items():
        pg.walks[name] = [(v, -o) for v, o in reversed(walk)]


def compact(pg: PanGraph) -> None:
    """Drop unreferenced nodes and renumber."""
    used: set[int] = set()
    for walk in pg.walks.values():
        used.update(v for v, _o in walk)
    remap = {}
    node_seq, node_block = [], []
    for v in sorted(used):
        remap[v] = len(node_seq)
        node_seq.append(pg.node_seq[v])
        node_block.append(pg.node_block[v])
    pg.node_seq = node_seq
    pg.node_block = node_block
    for name, walk in pg.walks.items():
        pg.walks[name] = [(remap[v], o) for v, o in walk]


def collapse_shared_affixes(pg: PanGraph, max_rounds: int = 50) -> int:
    """Normalize until fixpoint (or max_rounds).  Returns rounds run."""
    rounds = 0
    while rounds < max_rounds:
        changed = _collapse_prefixes_once(pg)
        _reverse_walks(pg)
        changed |= _collapse_prefixes_once(pg)
        _reverse_walks(pg)
        rounds += 1
        if not changed:
            break
    compact(pg)
    return rounds
