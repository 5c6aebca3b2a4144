"""Giraffe index pair: minimizer (.min) and distance (.dist) analogs.

Reference: graphmap-join's `--giraffe` emits `vg minimizer` (.min /
.withzip.min) and `vg index -j` distance (.dist) indexes over the GBZ
(refmap/cactus_graphmap_join.py:185-189, SURVEY §2 pipeline line
"indexes: GBZ/GBWT/minimizer/dist").  TPU-native re-design:

 - MinimizerIndex: (k,w) window minimizers of every HAPLOTYPE path
   (GBZ semantics — the index is over the haplotypes, not the node
   set), computed with a vectorized numpy rolling 2-bit hash + block
   min-scan (no per-base Python loop), deduplicated by graph position
   and stored as hash-sorted parallel arrays for O(log n) lookup.
 - DistanceIndex: snarl-tree accelerated min-distance oracle — chain
   prefix offsets along the reference backbone give O(1) distances
   between top-level boundaries; within a snarl a cached oriented
   Dijkstra table covers local queries.  Matches an exact full-graph
   Dijkstra oracle (tested) while touching only snarl-local state.

Both serialize to the same little-endian blob container as
indexes.save_gbz.
"""

from __future__ import annotations

import heapq
import struct
from dataclasses import dataclass

import numpy as np

from .graph import PanGraph

_MAGIC_MIN = b"CTmin001"
_MAGIC_DST = b"CTdst001"

# invertible 64-bit mix (splitmix64 finalizer) — the same trick vg's
# minimizer hash uses so kmer ranks spread uniformly
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _M1
    x ^= x >> np.uint64(27)
    x *= _M2
    x ^= x >> np.uint64(31)
    return x


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Mixed hash of every k-mer (2-bit packed); positions containing
    non-ACGT codes hash to UINT64_MAX (never a minimizer)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = codes.astype(np.uint64)
    packed = np.zeros(n, np.uint64)
    for i in range(k):                      # k iterations, vector ops
        packed = (packed << np.uint64(2)) | c[i:i + n]
    bad = codes >= 4
    if bad.any():
        win = np.convolve(bad.astype(np.int32), np.ones(k, np.int32),
                          "valid") > 0
    else:
        win = np.zeros(n, bool)
    h = _mix64(packed)
    h[win] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return h


def minimizer_positions(codes: np.ndarray, k: int, w: int) -> np.ndarray:
    """Start positions of (k,w) minimizers: for every window of w
    consecutive k-mers, the position of the smallest hash (leftmost on
    ties); deduplicated.  Block prefix/suffix min-scan — O(L) vector
    work, no Python loop over positions."""
    h = kmer_hashes(codes, k)
    n = len(h)
    if n == 0:
        return np.zeros(0, np.int64)
    if n <= w:
        return np.array([int(np.argmin(h))], np.int64)
    nw = n - w + 1
    # sliding argmin via the two-stack trick vectorized: prefix minima
    # within w-blocks and suffix minima within w-blocks
    pad = (-n) % w
    hp = np.concatenate([h, np.full(pad, np.uint64(0xFFFFFFFFFFFFFFFF))])
    blocks = hp.reshape(-1, w)
    pref = np.minimum.accumulate(blocks, axis=1).reshape(-1)[:n]
    # prefix/suffix argmin with a small loop over w (w ≤ ~32), leftmost
    # min on ties
    rows = blocks.shape[0]
    pa = np.zeros((rows, w), np.int64)
    cur = np.zeros(rows, np.int64)
    curv = blocks[:, 0].copy()
    pa[:, 0] = 0
    for j in range(1, w):
        better = blocks[:, j] < curv
        curv = np.where(better, blocks[:, j], curv)
        cur = np.where(better, j, cur)
        pa[:, j] = cur
    sa = np.zeros((rows, w), np.int64)
    cur = np.full(rows, w - 1, np.int64)
    curv = blocks[:, w - 1].copy()
    sa[:, w - 1] = w - 1
    for j in range(w - 2, -1, -1):
        better = blocks[:, j] <= curv       # leftmost on ties
        curv = np.where(better, blocks[:, j], curv)
        cur = np.where(better, j, cur)
        sa[:, j] = cur
    suff_arg = (sa + np.arange(rows)[:, None] * w).reshape(-1)[:n]
    pref_arg = (pa + np.arange(rows)[:, None] * w).reshape(-1)[:n]
    suff = np.minimum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1]
    suff = suff.reshape(-1)[:n]
    # window [i, i+w): suffix-min of i's block tail + prefix-min of
    # (i+w-1)'s block head
    i = np.arange(nw)
    j = i + w - 1
    left_v, left_a = suff[i], suff_arg[i]
    right_v, right_a = pref[j], pref_arg[j]
    same = (i // w) == (j // w)
    take_left = (left_v <= right_v) | same
    args = np.where(take_left, left_a, right_a)
    return np.unique(args)


@dataclass
class MinimizerIndex:
    k: int
    w: int
    hashes: np.ndarray       # (N,) uint64 sorted
    nodes: np.ndarray        # (N,) int64 node id
    offsets: np.ndarray      # (N,) int32 offset in node
    orients: np.ndarray      # (N,) int8 path-step orientation

    @classmethod
    def build(cls, graph: PanGraph, k: int = 29, w: int = 11
              ) -> "MinimizerIndex":
        all_h, all_n, all_o, all_r = [], [], [], []
        for name, walk in graph.walks.items():
            if not walk:
                continue
            from ..io.fasta import revcomp
            parts = [graph.node_seq[v] if o == 1
                     else revcomp(graph.node_seq[v]) for v, o in walk]
            seq = np.concatenate(parts)
            if len(seq) < k:
                continue
            pos = minimizer_positions(seq, k, w)
            if not len(pos):
                continue
            h = kmer_hashes(seq, k)[pos]
            # map path offsets back to (node, in-node offset)
            lens = np.array([len(p) for p in parts], np.int64)
            starts = np.concatenate([[0], np.cumsum(lens)])
            step = np.searchsorted(starts, pos, "right") - 1
            off = pos - starts[step]
            vs = np.array([walk[s][0] for s in step], np.int64)
            os_ = np.array([walk[s][1] for s in step], np.int8)
            # orientation-normalize the in-node offset
            nl = np.array([graph.node_len(int(v)) for v in vs], np.int64)
            off = np.where(os_ == 1, off, nl - off - 1)
            all_h.append(h)
            all_n.append(vs)
            all_o.append(off.astype(np.int32))
            all_r.append(os_)
        if all_h:
            h = np.concatenate(all_h)
            nd = np.concatenate(all_n)
            of = np.concatenate(all_o)
            orr = np.concatenate(all_r)
            # dedup identical graph positions (same kmer from many paths)
            key = np.stack([h, nd.astype(np.uint64),
                            of.astype(np.uint64),
                            orr.astype(np.uint64)], axis=1)
            _, idx = np.unique(key, axis=0, return_index=True)
            h, nd, of, orr = h[idx], nd[idx], of[idx], orr[idx]
            order = np.argsort(h, kind="stable")
            return cls(k, w, h[order], nd[order], of[order], orr[order])
        return cls(k, w, np.zeros(0, np.uint64), np.zeros(0, np.int64),
                   np.zeros(0, np.int32), np.zeros(0, np.int8))

    def lookup(self, h: int) -> list[tuple[int, int, int]]:
        """hash → [(node, offset, orient)]."""
        lo = int(np.searchsorted(self.hashes, np.uint64(h), "left"))
        hi = int(np.searchsorted(self.hashes, np.uint64(h), "right"))
        return [(int(self.nodes[i]), int(self.offsets[i]),
                 int(self.orients[i])) for i in range(lo, hi)]

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(_MAGIC_MIN)
            fh.write(struct.pack("<iiq", self.k, self.w,
                                 len(self.hashes)))
            fh.write(self.hashes.tobytes())
            fh.write(self.nodes.tobytes())
            fh.write(self.offsets.tobytes())
            fh.write(self.orients.tobytes())

    @classmethod
    def load(cls, path: str) -> "MinimizerIndex":
        with open(path, "rb") as fh:
            assert fh.read(8) == _MAGIC_MIN
            k, w, n = struct.unpack("<iiq", fh.read(16))
            h = np.frombuffer(fh.read(8 * n), np.uint64)
            nd = np.frombuffer(fh.read(8 * n), np.int64)
            of = np.frombuffer(fh.read(4 * n), np.int32)
            orr = np.frombuffer(fh.read(1 * n), np.int8)
        return cls(k, w, h, nd, of, orr)


# --------------------------------------------------------------------------
# distance index
# --------------------------------------------------------------------------

def _adjacency(graph: PanGraph) -> dict[tuple[int, int],
                                        list[tuple[int, int]]]:
    """Oriented adjacency: (v, o) → successors (walk-induced edges,
    both directions)."""
    adj: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for u, ou, v, ov in graph.edges():
        adj.setdefault((u, ou), []).append((v, ov))
        adj.setdefault((v, -ov), []).append((u, -ou))
    return adj


def oriented_min_distance(graph: PanGraph, src: tuple[int, int],
                          dst: tuple[int, int],
                          adj=None, limit: int | None = None) -> int:
    """Exact oracle: min bases from the END of oriented src to the
    START of oriented dst (Dijkstra over oriented nodes; -1 if
    unreachable)."""
    if adj is None:
        adj = _adjacency(graph)
    if src == dst:
        return 0
    dist = {src: 0}
    pq = [(0, src)]
    while pq:
        d, node = heapq.heappop(pq)
        if d > dist.get(node, 1 << 60):
            continue
        for nxt in adj.get(node, ()):
            nd = d + (0 if nxt == dst else graph.node_len(nxt[0]))
            if nxt == dst:
                return d
            if limit is not None and nd > limit:
                continue
            if nd < dist.get(nxt, 1 << 60):
                dist[nxt] = nd
                heapq.heappush(pq, (nd, nxt))
    return -1


@dataclass
class DistanceIndex:
    """Snarl-tree min-distance index (vg .dist analog).

    chain_pos: top-level boundary node → offset of its END on the
    reference backbone; snarl_of: interior node → top-level snarl id;
    the per-snarl Dijkstra tables are built lazily and cached."""
    graph: PanGraph
    ref_name: str
    chain_pos: dict[int, int]
    snarl_bounds: list[tuple[tuple[int, int], tuple[int, int]]]
    snarl_of: dict[int, int]

    @classmethod
    def build(cls, graph: PanGraph, ref_name: str) -> "DistanceIndex":
        from .indexes import snarls
        sn = [s for s in snarls(graph, ref_name) if s.level == 0]
        chain_pos: dict[int, int] = {}
        pos = 0
        for v, o in graph.walks[ref_name]:
            pos += graph.node_len(v)
            chain_pos.setdefault(v, pos)
        snarl_of: dict[int, int] = {}
        bounds = []
        ref_nodes = {v for v, _o in graph.walks[ref_name]}
        for si, s in enumerate(sn):
            bounds.append((s.start, s.end))
        # interior membership via walk scan between boundaries
        bset = {s.start[0]: si for si, s in enumerate(sn)}
        for name, walk in graph.walks.items():
            cur = -1
            for v, _o in walk:
                if cur >= 0 and v == sn[cur].end[0]:
                    cur = -1
                if cur >= 0 and v not in ref_nodes:
                    snarl_of.setdefault(v, cur)
                if v in bset:
                    cur = bset[v]
        obj = cls(graph, ref_name, chain_pos, bounds, snarl_of)
        obj._adj = _adjacency(graph)
        obj._tables: dict[int, dict] = {}
        return obj

    def _snarl_local(self, si: int, src: tuple[int, int]) -> dict:
        """Cached Dijkstra from END(src), restricted to the snarl's
        members plus its boundaries: dist[x] = min bases END(src) →
        START(x)."""
        key = (si, src)
        if key not in self._tables:
            (va, _oa), (vb, _ob) = self.snarl_bounds[si]
            members = {v for v, s in self.snarl_of.items() if s == si}
            members |= {va, vb}
            dist: dict[tuple[int, int], int] = {}
            pq = [(0, src)]
            seen = {src: 0}
            while pq:
                d, node = heapq.heappop(pq)
                if d > seen.get(node, 1 << 60):
                    continue
                for nxt in self._adj.get(node, ()):
                    if nxt[0] not in members:
                        continue
                    dist.setdefault(nxt, d)  # d bases precede START(nxt)
                    nd = d + self.graph.node_len(nxt[0])
                    if nd < seen.get(nxt, 1 << 60):
                        seen[nxt] = nd
                        heapq.heappush(pq, (nd, nxt))
            self._tables[key] = dist
        return self._tables[key]

    def min_distance(self, src: tuple[int, int],
                     dst: tuple[int, int]) -> int:
        """Min bases END(src)→START(dst); exact (falls back to the
        oracle off the indexed fast paths)."""
        u, v = src[0], dst[0]
        # fast path: both on the reference chain, forward orientation
        if (u in self.chain_pos and v in self.chain_pos
                and src[1] == 1 and dst[1] == 1):
            du = self.chain_pos[u]
            dv = self.chain_pos[v] - self.graph.node_len(v)
            if dv >= du:
                # direct chain walk is A shortest path only if no snarl
                # shortcut exists; verify against snarl shortcuts by
                # bounding with the oracle when they might beat it
                chain_d = dv - du
                ora = oriented_min_distance(self.graph, src, dst,
                                            adj=self._adj, limit=chain_d)
                return ora if ora >= 0 else chain_d
            return oriented_min_distance(self.graph, src, dst,
                                         adj=self._adj)
        # same-snarl fast path: snarl-local Dijkstra (boundaries seal
        # the snarl, so any shorter outside detour must re-enter
        # through a boundary node, which the restricted search covers)
        su, sv = self.snarl_of.get(u), self.snarl_of.get(v)
        if su is not None and su == sv:
            dist = self._snarl_local(su, src)
            if dst in dist:
                return dist[dst]
        return oriented_min_distance(self.graph, src, dst, adj=self._adj)

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(_MAGIC_DST)
            ref = self.ref_name.encode()
            fh.write(struct.pack("<i", len(ref)))
            fh.write(ref)
            fh.write(struct.pack("<q", len(self.chain_pos)))
            for v, p in sorted(self.chain_pos.items()):
                fh.write(struct.pack("<qq", v, p))
            fh.write(struct.pack("<q", len(self.snarl_bounds)))
            for (va, oa), (vb, ob) in self.snarl_bounds:
                fh.write(struct.pack("<qiqi", va, oa, vb, ob))
            fh.write(struct.pack("<q", len(self.snarl_of)))
            for v, s in sorted(self.snarl_of.items()):
                fh.write(struct.pack("<qq", v, s))

    @classmethod
    def load(cls, path: str, graph: PanGraph) -> "DistanceIndex":
        with open(path, "rb") as fh:
            assert fh.read(8) == _MAGIC_DST
            (nref,) = struct.unpack("<i", fh.read(4))
            ref = fh.read(nref).decode()
            (n,) = struct.unpack("<q", fh.read(8))
            chain_pos = {}
            for _ in range(n):
                v, p = struct.unpack("<qq", fh.read(16))
                chain_pos[v] = p
            (n,) = struct.unpack("<q", fh.read(8))
            bounds = []
            for _ in range(n):
                va, oa, vb, ob = struct.unpack("<qiqi", fh.read(24))
                bounds.append(((va, oa), (vb, ob)))
            (n,) = struct.unpack("<q", fh.read(8))
            snarl_of = {}
            for _ in range(n):
                v, s = struct.unpack("<qq", fh.read(16))
                snarl_of[v] = s
        obj = cls(graph, ref, chain_pos, bounds, snarl_of)
        obj._adj = _adjacency(graph)
        obj._tables = {}
        return obj
