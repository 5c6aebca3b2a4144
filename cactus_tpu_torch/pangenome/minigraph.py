"""Minigraph-equivalent SV graph construction + graph mapping.

Reference pipeline (refmap/cactus_minigraph.py:311-555): sort the input
assemblies by mash distance to the reference, then build the SV graph
iteratively — `minigraph -cxggs` maps each assembly to the current
graph and inserts structural variants (≥ ~50 bp) as new nodes; the
result is an rGFA whose nodes carry stable-coordinate tags
(SN:Z:source-sequence, SO:i:offset, SR:i:rank).  cactus-graphmap
(refmap/cactus_graphmap.py:447-546) then maps EVERY assembly back to
the final graph, converts GAF→PAF against the graph's node sequences
(published as the `_MINIGRAPH_` event), and filters (minMAPQ,
minGAFBlockLength, delFilter; config XML :422-448).  That PAF drives
the base-level cactus alignment.

Here the mapper is this package's own anchoring stack (seed join →
chain scans → gap fill on the banded DP kernels, on the caller's device)
instead of minigraph; the graph is a node table with stable tags;
mapping targets are the node sequences packed into super-contigs so one
batched alignment covers the whole graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import BlastParams, Config
from ..io.fasta import Sequence, _BASE_OF
from ..io.paf import PafRecord
from ..phases.blast import mark_primaries
from ..phases.chunking import (align_genomes_chunked, pack_small_contigs,
                               split_packed_records)

MIN_SV = 50                 # minigraph -L: minimum SV / unitig length


# --------------------------------------------------------------------------
# mash ordering (cactus_minigraph.py:311-449 mash-sorts inputs)
# --------------------------------------------------------------------------

def _kmer_hashes(codes: np.ndarray, k: int = 16) -> np.ndarray:
    """Scrambled 2k-bit k-mer keys of every position (Ns excluded)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros(n, np.uint64)
    ok = np.ones(n, bool)
    for j in range(k):
        c = codes[j:n + j]
        v = (v << np.uint64(2)) | (c & 3).astype(np.uint64)
        ok &= c < 4
    v = v[ok]
    # splitmix64 scramble
    v = (v + np.uint64(0x9E3779B97F4A7C15))
    v ^= v >> np.uint64(30)
    v *= np.uint64(0xBF58476D1CE4E5B9)
    v ^= v >> np.uint64(27)
    v *= np.uint64(0x94D049BB133111EB)
    v ^= v >> np.uint64(31)
    return v


def mash_sketch(genome: dict[str, Sequence], k: int = 16,
                size: int = 2000) -> np.ndarray:
    """Bottom-s MinHash sketch over all contigs."""
    hs = [np.unique(_kmer_hashes(s.codes, k)) for s in genome.values()]
    allh = np.unique(np.concatenate(hs)) if hs else np.zeros(0, np.uint64)
    return allh[:size]


def mash_distance(sa: np.ndarray, sb: np.ndarray, k: int = 16) -> float:
    """Mash distance from two bottom sketches (Ondov et al. 2016)."""
    s = min(len(sa), len(sb))
    if s == 0:
        return 1.0
    merged = np.unique(np.concatenate([sa, sb]))[:s]
    inter = int((np.isin(merged, sa, assume_unique=True)
                 & np.isin(merged, sb, assume_unique=True)).sum())
    j = inter / s
    if j <= 0:
        return 1.0
    return float(min(1.0, -np.log(2 * j / (1 + j)) / k))


def mash_order(genomes: dict[str, dict[str, Sequence]],
               ref_event: str) -> list[str]:
    """Reference first, then ascending mash distance to it."""
    sk = {ev: mash_sketch(g) for ev, g in genomes.items()}
    others = [ev for ev in genomes if ev != ref_event]
    others.sort(key=lambda ev: mash_distance(sk[ref_event], sk[ev]))
    return [ref_event] + others


# --------------------------------------------------------------------------
# the SV graph
# --------------------------------------------------------------------------

@dataclass
class SVGraph:
    node_seq: list[np.ndarray] = field(default_factory=list)
    node_stable: list[tuple[str, int, int]] = field(default_factory=list)
    #   node id → (stable source sequence, offset, rank)
    edges: set = field(default_factory=set)

    @property
    def n_nodes(self) -> int:
        return len(self.node_seq)

    def node_name(self, v: int) -> str:
        return f"s{v + 1}"

    def add_node(self, codes: np.ndarray, source: str, offset: int,
                 rank: int) -> int:
        self.node_seq.append(np.ascontiguousarray(codes, np.uint8))
        self.node_stable.append((source, offset, rank))
        return len(self.node_seq) - 1

    def add_edge(self, u: int, ou: int, v: int, ov: int) -> None:
        e = (u, ou, v, ov)
        rc = (v, -ov, u, -ou)
        self.edges.add(min(e, rc))

    def node_fasta(self, event: str = "_MINIGRAPH_"
                   ) -> dict[str, Sequence]:
        """Graph node sequences as the `_MINIGRAPH_` pseudo-event
        (cactus_graphmap.py:427-445)."""
        return {f"{event}.{self.node_name(v)}":
                Sequence(f"{event}.{self.node_name(v)}", c)
                for v, c in enumerate(self.node_seq)}

    def write_rgfa(self, path_or_file) -> None:
        """rGFA: S-lines with SN/SO/SR stable tags + L-lines."""
        own = not hasattr(path_or_file, "write")
        fh = open(path_or_file, "w") if own else path_or_file
        try:
            fh.write("H\tVN:Z:1.0\n")
            for v, codes in enumerate(self.node_seq):
                s = _BASE_OF[codes].tobytes().decode("ascii")
                sn, so, sr = self.node_stable[v]
                fh.write(f"S\t{self.node_name(v)}\t{s}\tSN:Z:{sn}\t"
                         f"SO:i:{so}\tSR:i:{sr}\n")
            for u, ou, v, ov in sorted(self.edges):
                fh.write(f"L\t{self.node_name(u)}\t{'+' if ou == 1 else '-'}"
                         f"\t{self.node_name(v)}\t"
                         f"{'+' if ov == 1 else '-'}\t0M\n")
        finally:
            if own:
                fh.close()


def read_rgfa(path) -> SVGraph:
    """Load an rGFA written by SVGraph.write_rgfa (node ids s1..sN with
    SN/SO/SR stable tags) — the artifact boundary between the
    cactus-minigraph and cactus-graphmap stages."""
    from ..io.fasta import _CODE_OF
    g = SVGraph()
    names: dict[str, int] = {}
    edges = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                tags = {t.split(":", 1)[0]: t.split(":", 2)[2]
                        for t in f[3:]}
                codes = _CODE_OF[np.frombuffer(
                    f[2].encode(), np.uint8)].astype(np.uint8)
                v = g.add_node(codes, tags.get("SN", f[1]),
                               int(tags.get("SO", 0)),
                               int(tags.get("SR", 0)))
                names[f[1]] = v
            elif f[0] == "L":
                edges.append((f[1], 1 if f[2] == "+" else -1,
                              f[3], 1 if f[4] == "+" else -1))
    for un, ou, vn, ov in edges:
        g.add_edge(names[un], ou, names[vn], ov)
    return g


def _map_contig(qname: str, qseq: Sequence, graph: SVGraph,
                cfg: BlastParams, preset: str = "one", device=None
                ) -> list[PafRecord]:
    """Map one contig onto the graph's node sequences → primary-marked
    PAF records with tname = `_MINIGRAPH_.s<i>`; the gap fill runs on
    `device` (None = the current CUDA device)."""
    tgenome = graph.node_fasta()
    packed, mapping = pack_small_contigs(tgenome, small_threshold=50_000)
    records = align_genomes_chunked({qname: qseq}, packed, cfg,
                                    preset=preset, device=device)
    records = split_packed_records(records, mapping)
    lens = {n: len(s) for n, s in tgenome.items()}
    for r in records:
        r.tlen = lens.get(r.tname, r.tlen)
    return mark_primaries(records)


def _primary_cover(records: list[PafRecord], min_sv: int = MIN_SV,
                   min_score: int = 0
                   ) -> list[tuple[int, int, PafRecord]]:
    """Query intervals covered by primary records, split at query
    insertions ≥ min_sv — the gap-fill DP happily bridges an SV-sized
    insertion inside one record, but minigraph treats ≥`-L` novel
    sequence as a variant, so coverage must break there.

    Returns sorted (qstart, qend, record) segments.
    """
    segs: list[tuple[int, int, PafRecord]] = []
    for r in records:
        if not r.is_primary or r.score < min_score:
            continue
        q = r.qstart
        cur0 = q
        for op, n in r.cigar:
            if op in ("M", "=", "X"):
                q += n
            elif op == "I":
                if n >= min_sv:
                    if q > cur0:
                        segs.append((cur0, q, r))
                    cur0 = q + n
                q += n
            # 'D' consumes target only
        if q > cur0:
            segs.append((cur0, q, r))
    segs.sort(key=lambda s: (s[0], s[1]))
    return segs


def _node_id(tname: str) -> int:
    return int(tname.rsplit(".s", 1)[1]) - 1


def build_sv_graph(genomes: dict[str, dict[str, Sequence]],
                   ref_event: str, config: Config | None = None,
                   min_sv: int = MIN_SV, preset: str = "one",
                   log=lambda m: None, device=None
                   ) -> tuple[SVGraph, list[str]]:
    """Iterative SV-graph construction (cactus_minigraph.py:451-555).

    Returns (graph, event order).  Rank r nodes come from the r-th
    assembly in mash order; rank 0 is the reference backbone.
    """
    cfg = (config or Config.default()).blast
    order = mash_order(genomes, ref_event)
    graph = SVGraph()
    # backbone: one node per reference contig
    for name, seq in genomes[ref_event].items():
        graph.add_node(seq.codes, name, 0, 0)
    log(f"minigraph: backbone {graph.n_nodes} nodes from {ref_event}")
    for rank, ev in enumerate(order[1:], start=1):
        added_bp = 0
        for name, seq in genomes[ev].items():
            records = _map_contig(name, seq, graph, cfg, preset,
                                  device=device)
            cover = _primary_cover(records, min_sv=min_sv)
            # edges between consecutive aligned nodes
            for (_a0, _a1, r1), (_b0, _b1, r2) in zip(cover, cover[1:]):
                u, v = _node_id(r1.tname), _node_id(r2.tname)
                ou = 1 if r1.strand == "+" else -1
                ov = 1 if r2.strand == "+" else -1
                if u != v:
                    graph.add_edge(u, ou, v, ov)
            # uncovered query gaps ≥ min_sv become new nodes
            gaps = []
            pos = 0
            for q0, q1, _r in cover:
                if q0 - pos >= min_sv:
                    gaps.append((pos, q0))
                pos = max(pos, q1)
            if len(seq) - pos >= min_sv:
                gaps.append((pos, len(seq)))
            for g0, g1 in gaps:
                nv = graph.add_node(seq.codes[g0:g1], name, g0, rank)
                added_bp += g1 - g0
                # attach to flanking aligned nodes
                before = [s for s in cover if s[1] <= g0]
                after = [s for s in cover if s[0] >= g1]
                if before:
                    r = before[-1][2]
                    graph.add_edge(_node_id(r.tname),
                                   1 if r.strand == "+" else -1, nv, 1)
                if after:
                    r = after[0][2]
                    graph.add_edge(nv, 1, _node_id(r.tname),
                                   1 if r.strand == "+" else -1)
        log(f"minigraph: rank {rank} {ev}: graph now {graph.n_nodes} "
            f"nodes (+{added_bp} bp)")
    return graph, order


def graphmap(graph: SVGraph, genomes: dict[str, dict[str, Sequence]],
             config: Config | None = None, preset: str = "one",
             min_block: int = 0, min_score: int = 0,
             del_filter: int | None = None,
             log=lambda m: None, device=None) -> list[PafRecord]:
    """Map every assembly to the final graph → PAF on node space
    (cactus_graphmap.py:447-546; GAF→PAF with mzgaf2paf/gaffilter
    filters minMAPQ / minGAFBlockLength / delFilter, config :422-448).

    The returned records (query = `event.contig`, target =
    `_MINIGRAPH_.s<i>`) drive the base-level star alignment.
    """
    cfg = (config or Config.default()).blast
    out: list[PafRecord] = []
    for ev, genome in genomes.items():
        n0 = len(out)
        for name, seq in genome.items():
            records = _map_contig(f"{ev}.{name}"
                                  if not name.startswith(ev + ".")
                                  else name, seq, graph, cfg, preset,
                                  device=device)
            records = [r for r in records
                       if r.qend - r.qstart >= min_block
                       and (not r.is_primary or r.score >= min_score)]
            if del_filter is not None:
                records = _apply_del_filter(records, del_filter)
            out.extend(records)
        log(f"graphmap: {ev}: {len(out) - n0} records")
    return out


def _apply_del_filter(records: list[PafRecord],
                      del_filter: int) -> list[PafRecord]:
    """Drop the smaller of two consecutive primary records whose
    implied target deletion exceeds del_filter
    (filter-paf-deletions; config XML delFilter=10M)."""
    prim = sorted((r for r in records if r.is_primary),
                  key=lambda r: (r.qname, r.tname, r.qstart))
    drop = set()
    for r1, r2 in zip(prim, prim[1:]):
        if r1.qname != r2.qname or r1.tname != r2.tname \
                or r1.strand != r2.strand:
            continue
        tgap = abs(r2.tstart - r1.tend)
        qgap = abs(r2.qstart - r1.qend)
        if tgap - qgap > del_filter:
            drop.add(id(min(r1, r2, key=lambda r: r.score)))
    return [r for r in records if id(r) not in drop]
