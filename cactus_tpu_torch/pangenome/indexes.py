"""Pangenome index family — the GBZ/GBWT, snarls, xg and odgi-stats
equivalents of graphmap-join's index factory.

The reference's join stage (refmap/cactus_graphmap_join.py:652+) emits,
besides GFA/VCF: GBZ (graph + GBWT haplotype index), snarl index,
xg (path position index), and odgi stats/viz artifacts.  Native
equivalents here:

 - `save_gbz` / `load_gbz`: one-file binary serialization of a PanGraph
   (2-bit packed node DNA, edge table, delta-coded walks) — the durable
   graph container;
 - `HaplotypeIndex`: which haplotypes extend oriented node u with
   oriented node v, with counts — the GBWT's core extension query;
 - `PathPositionIndex`: walk offset prefix arrays for O(log n)
   position→node and node→position lookups (the xg role);
 - `snarls`: nested bubble decomposition anchored on nodes every walk
   traverses exactly once in a consistent order (separator anchors),
   with containment nesting levels (the vg snarls role);
 - `node_depths` / `degree_stats`: odgi stats-style depth and degree
   tables.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from ..io.fasta import pack_2bit, unpack_2bit
from .graph import PanGraph

_MAGIC = b"CTGBZ001"


# --------------------------------------------------------------------------
# GBZ-lite serialization
# --------------------------------------------------------------------------

def save_gbz(path: str, graph: PanGraph) -> None:
    node_lens = np.array([len(c) for c in graph.node_seq], np.int64)
    dna = (np.concatenate(graph.node_seq) if graph.node_seq
           else np.zeros(0, np.uint8))
    packed, n_mask = pack_2bit(dna)
    edges = np.array(sorted(graph.edges()), np.int64).reshape(-1, 4)
    walk_names = list(graph.walks)
    steps = []
    walk_bounds = [0]
    for name in walk_names:
        for v, o in graph.walks[name]:
            steps.append(v * 2 + (0 if o == 1 else 1))
        walk_bounds.append(len(steps))
    steps = np.array(steps, np.int64)
    blobs = {}
    payload = b""

    def add(key, arr):
        nonlocal payload
        arr = np.ascontiguousarray(arr)
        blobs[key] = {"off": len(payload), "dtype": arr.dtype.str,
                      "shape": list(arr.shape)}
        payload += arr.tobytes()

    add("node_lens", node_lens)
    add("dna", packed)
    add("n_mask", np.packbits(n_mask))
    add("edges", edges)
    add("steps", steps)
    add("walk_bounds", np.array(walk_bounds, np.int64))
    add("node_block", np.array(graph.node_block, np.int64))
    toc = json.dumps({"blobs": blobs, "walks": walk_names,
                      "n_dna": int(len(dna))}).encode()
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<Q", len(toc)))
        fh.write(toc)
        fh.write(payload)


def load_gbz(path: str) -> PanGraph:
    with open(path, "rb") as fh:
        if fh.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a CTGBZ file")
        toc_len, = struct.unpack("<Q", fh.read(8))
        toc = json.loads(fh.read(toc_len).decode())
        payload = fh.read()

    def get(key):
        b = toc["blobs"][key]
        a = np.frombuffer(payload, dtype=np.dtype(b["dtype"]),
                          count=int(np.prod(b["shape"])) if b["shape"]
                          else -1, offset=b["off"])
        return a.reshape(b["shape"])

    node_lens = get("node_lens")
    n_dna = toc["n_dna"]
    n_mask = np.unpackbits(get("n_mask"))[:n_dna].astype(bool)
    dna = unpack_2bit(np.array(get("dna")), n_dna, n_mask)
    node_seq = []
    pos = 0
    for ln in node_lens:
        node_seq.append(dna[pos:pos + int(ln)].copy())
        pos += int(ln)
    steps = get("steps")
    bounds = get("walk_bounds")
    walks = {}
    for i, name in enumerate(toc["walks"]):
        seg = steps[int(bounds[i]):int(bounds[i + 1])]
        walks[name] = [(int(s) // 2, 1 if s % 2 == 0 else -1)
                       for s in seg]
    return PanGraph(node_seq=node_seq, walks=walks,
                    node_block=[int(x) for x in get("node_block")])


# --------------------------------------------------------------------------
# GBWT-style haplotype extension index
# --------------------------------------------------------------------------

class HaplotypeIndex:
    """For every oriented node, the multiset of oriented successors with
    the haplotypes taking each — the GBWT extension query."""

    def __init__(self, graph: PanGraph):
        self._ext: dict[tuple[int, int], dict[tuple[int, int],
                                              list[str]]] = {}
        for name, walk in graph.walks.items():
            for (u, ou), (v, ov) in zip(walk, walk[1:]):
                self._ext.setdefault((u, ou), {}).setdefault(
                    (v, ov), []).append(name)
                # bidirected symmetry: reverse traversal
                self._ext.setdefault((v, -ov), {}).setdefault(
                    (u, -ou), []).append(name)

    def extensions(self, v: int, o: int = 1
                   ) -> list[tuple[int, int, int]]:
        """[(next node, next orient, haplotype count)] sorted by count."""
        out = [(w, ow, len(hs))
               for (w, ow), hs in self._ext.get((v, o), {}).items()]
        return sorted(out, key=lambda t: (-t[2], t[0], t[1]))

    def haplotypes(self, u: int, ou: int, v: int, ov: int) -> list[str]:
        return sorted(self._ext.get((u, ou), {}).get((v, ov), []))

    def count(self, u: int, ou: int, v: int, ov: int) -> int:
        return len(self._ext.get((u, ou), {}).get((v, ov), ()))


# --------------------------------------------------------------------------
# xg-style path position index
# --------------------------------------------------------------------------

class PathPositionIndex:
    """Per-walk prefix offsets: position → step and step → position."""

    def __init__(self, graph: PanGraph):
        self.graph = graph
        self.offsets: dict[str, np.ndarray] = {}
        for name, walk in graph.walks.items():
            lens = np.array([graph.node_len(v) for v, _o in walk],
                            np.int64)
            self.offsets[name] = np.concatenate(
                [[0], np.cumsum(lens)])

    def node_at(self, name: str, pos: int) -> tuple[int, int, int]:
        """(node, orient, offset inside node) at path position pos."""
        offs = self.offsets[name]
        if pos < 0 or pos >= offs[-1]:
            raise IndexError(f"{name}: {pos} out of range {offs[-1]}")
        k = int(np.searchsorted(offs, pos, side="right")) - 1
        v, o = self.graph.walks[name][k]
        return v, o, pos - int(offs[k])

    def step_position(self, name: str, step: int) -> int:
        return int(self.offsets[name][step])

    def path_length(self, name: str) -> int:
        return int(self.offsets[name][-1])


# --------------------------------------------------------------------------
# snarl decomposition
# --------------------------------------------------------------------------

@dataclass
class Snarl:
    start: tuple[int, int]       # oriented boundary nodes
    end: tuple[int, int]
    level: int                   # nesting depth (0 = top)
    span: tuple[int, int]        # positions on the anchor walk
    n_nodes: int                 # interior nodes (any walk)


def snarls(graph: PanGraph, ref_name: str) -> list[Snarl]:
    """Nested snarl list anchored on separator nodes (nodes every walk
    traverses exactly once, in one consistent relative order).

    Between two adjacent separators either every walk agrees (no
    snarl) or the region is a bubble; nesting comes from re-running the
    decomposition inside each bubble on the walks' sub-paths with
    level+1 anchors = nodes shared by the subset of walks through the
    bubble.  This is the containment structure vg's snarl index stores.
    """
    names = list(graph.walks)

    def decompose(walk_slices: dict[str, list[tuple[int, int]]],
                  level: int, out: list[Snarl]):
        ref_slice = walk_slices[ref_name]
        # one pass per walk: per-walk multiplicity and position maps
        # (anchor test and interval extraction are O(1) lookups after)
        counts: dict[int, int] = {}
        walk_seen: list[dict[int, int]] = []
        pos_maps: dict[str, dict[int, int]] = {}
        for name, w in walk_slices.items():
            seen: dict[int, int] = {}
            pos: dict[int, int] = {}
            for i, (v, _o) in enumerate(w):
                seen[v] = seen.get(v, 0) + 1
                pos[v] = i
            walk_seen.append(seen)
            pos_maps[name] = pos
            for v, c in seen.items():
                counts[v] = max(counts.get(v, 0), c)
        anchors = [k for k, (v, _o) in enumerate(ref_slice)
                   if counts.get(v) == 1
                   and all(v in seen for seen in walk_seen)]
        # positions on the ref walk for spans
        lens = np.array([graph.node_len(v) for v, _o in ref_slice],
                        np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)])
        for ka, kb in zip(anchors, anchors[1:]):
            if kb == ka + 1:
                # check every other walk is also adjacent here
                va = ref_slice[ka][0]
                vb = ref_slice[kb][0]
                adjacent = True
                for name in walk_slices:
                    pos = pos_maps[name]
                    if abs(pos[vb] - pos[va]) != 1:
                        adjacent = False
                        break
                if adjacent:
                    continue
            va, oa = ref_slice[ka]
            vb, ob = ref_slice[kb]
            interior: set[int] = set()
            sub: dict[str, list[tuple[int, int]]] = {}
            for name, w in walk_slices.items():
                pos = pos_maps[name]
                i0, i1 = pos[va], pos[vb]
                if i0 > i1:
                    i0, i1 = i1, i0
                seg = w[i0:i1 + 1]
                sub[name] = seg
                interior.update(v for v, _o in seg[1:-1])
            out.append(Snarl(start=(va, oa), end=(vb, ob), level=level,
                             span=(int(offs[ka + 1]), int(offs[kb])),
                             n_nodes=len(interior)))
            if interior and level < 16:
                decompose(sub, level + 1, out)

    out: list[Snarl] = []
    decompose({n: list(w) for n, w in graph.walks.items()}, 0, out)
    return out


# --------------------------------------------------------------------------
# odgi-style stats
# --------------------------------------------------------------------------

def node_depths(graph: PanGraph) -> np.ndarray:
    d = np.zeros(graph.n_nodes, np.int64)
    for walk in graph.walks.values():
        for v, _o in walk:
            d[v] += 1
    return d


def degree_stats(graph: PanGraph) -> dict:
    deg = np.zeros(graph.n_nodes, np.int64)
    for u, _ou, v, _ov in graph.edges():
        deg[u] += 1
        deg[v] += 1
    depths = node_depths(graph)
    lens = np.array([graph.node_len(v) for v in range(graph.n_nodes)],
                    np.int64)
    return dict(
        n_nodes=graph.n_nodes,
        n_edges=len(graph.edges()),
        mean_degree=float(deg.mean()) if len(deg) else 0.0,
        max_degree=int(deg.max()) if len(deg) else 0,
        mean_depth=float((depths * lens).sum() / max(1, lens.sum())),
        max_depth=int(depths.max()) if len(depths) else 0,
    )
