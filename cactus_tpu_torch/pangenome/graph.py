"""Pangenome sequence graph from the block structure.

Replaces the minigraph-cactus graph products (reference:
refmap/cactus_graphmap_join.py — vg/GFAffix normalize → GFA/GBZ; graph
semantics per the HPRC pipeline): nodes are allele strings, haplotypes
are walks, and every walk spells its input sequence EXACTLY (the `vg
validate` invariant, enforced by validate()).

Construction from one CAF/BAR result (the star-tree alignment of all
haplotypes, reference: cactus-align --pangenome star mode):
 - each live block contributes one node per DISTINCT member string
   (segments grouped by their rendered bases in block orientation —
   SNP/MNP alleles become parallel nodes, the bubble structure);
 - every unaligned gap contributes a private insertion node;
 - each haplotype's walk visits its segments' nodes in thread order
   with orientations; edges are induced by consecutive walk steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import Sequence, revcomp, _BASE_OF
from ..phases.bar import global_codes
from ..phases.caf import CafResult


@dataclass
class PanGraph:
    node_seq: list[np.ndarray]                  # node id → codes
    walks: dict[str, list[tuple[int, int]]]     # seq name → [(node, orient)]
    node_block: list[int]                       # node id → block (-1 insert)

    @property
    def n_nodes(self) -> int:
        return len(self.node_seq)

    def node_len(self, v: int) -> int:
        return len(self.node_seq[v])

    def edges(self) -> set[tuple[int, int, int, int]]:
        """Distinct oriented edges (u, ou, v, ov), canonicalized."""
        out = set()
        for walk in self.walks.values():
            for (u, ou), (v, ov) in zip(walk, walk[1:]):
                e = (u, ou, v, ov)
                rc = (v, -ov, u, -ou)
                out.add(min(e, rc))
        return out

    def validate(self, seqs: dict[str, Sequence]) -> None:
        """Every walk must spell its sequence exactly (vg validate)."""
        for name, walk in self.walks.items():
            parts = []
            for v, o in walk:
                c = self.node_seq[v]
                parts.append(c if o == 1 else revcomp(c))
            got = (np.concatenate(parts) if parts
                   else np.zeros(0, np.uint8))
            want = seqs[name].codes
            if len(got) != len(want) or not np.array_equal(got, want):
                raise AssertionError(
                    f"walk for {name} spells {len(got)} bp, "
                    f"expected {len(want)}")


def build_graph(caf: CafResult, seqs: dict[str, Sequence],
                chop: bool = False) -> PanGraph:
    """Block structure → sequence graph.

    chop=False: one node per DISTINCT member string per block (coarse
    allele nodes — bubbles at block granularity).  chop=True: blocks
    split at columns where members disagree, so runs of agreeing
    columns become ONE node shared by all haplotypes and disagreeing
    runs become per-allele nodes — the vg/minigraph-cactus node
    granularity (haplotypes share reference nodes between variants),
    required by consumers that anchor on shared nodes (panpatch,
    haplotype indexes).
    """
    gcodes = global_codes(caf.table, seqs)
    table = caf.table
    blocks = caf.blocks

    node_seq: list[np.ndarray] = []
    node_block: list[int] = []
    allele_of: dict[tuple, int] = {}

    def allele_node(key, codes_oriented: np.ndarray, b: int) -> int:
        v = allele_of.get(key)
        if v is None:
            v = len(node_seq)
            node_seq.append(np.ascontiguousarray(codes_oriented))
            node_block.append(b)
            allele_of[key] = v
        return v

    def insert_node(codes: np.ndarray) -> int:
        v = len(node_seq)
        node_seq.append(codes.copy())
        node_block.append(-1)
        return v

    # order segments per sequence
    order = np.lexsort((blocks.seg_start, blocks.seg_seq))
    walks: dict[str, list[tuple[int, int]]] = {n: [] for n in table.names}
    seg_by_seq: dict[int, list[int]] = {}
    segs_of_block: dict[int, list[int]] = {}
    for i in order:
        b = int(blocks.seg_block[i])
        if caf.alive[b]:
            seg_by_seq.setdefault(int(blocks.seg_seq[i]), []).append(int(i))
            segs_of_block.setdefault(b, []).append(int(i))

    # chop plan per block: list of (col_start, col_end) runs, split at
    # columns where member strings disagree
    chops: dict[int, list[tuple[int, int]]] = {}
    if chop:
        for b, idxs in segs_of_block.items():
            rows = []
            for i in idxs:
                st = int(blocks.seg_start[i])
                ln = int(blocks.seg_len[i])
                strand = int(blocks.seg_strand[i])
                off = int(table.offsets[int(blocks.seg_seq[i])])
                seg = gcodes[off + st:off + st + ln]
                rows.append(seg if strand == 1 else revcomp(seg))
            mat = np.stack(rows)
            agree = (mat == mat[0]).all(axis=0)
            brk = np.flatnonzero(np.diff(agree.astype(np.int8))) + 1
            bounds = np.concatenate([[0], brk, [mat.shape[1]]])
            chops[b] = [(int(a), int(c))
                        for a, c in zip(bounds, bounds[1:])]

    def block_steps(b: int, seg: np.ndarray, strand: int):
        """Sub-node steps for one segment traversal."""
        oriented = seg if strand == 1 else revcomp(seg)
        pieces = chops.get(b) if chop else None
        if not pieces or len(pieces) == 1:
            v = allele_node((b, oriented.tobytes()), oriented, b)
            return [(v, strand)]
        steps = []
        for c0, c1 in pieces:
            sub = oriented[c0:c1]
            v = allele_node((b, c0, sub.tobytes()), sub, b)
            steps.append((v, strand))
        if strand == -1:
            steps.reverse()
        return steps

    for si, name in enumerate(table.names):
        off = int(table.offsets[si])
        total = int(table.lengths[si])
        pos = 0
        walk = walks[name]
        for i in seg_by_seq.get(si, []):
            st = int(blocks.seg_start[i])
            ln = int(blocks.seg_len[i])
            strand = int(blocks.seg_strand[i])
            b = int(blocks.seg_block[i])
            if st > pos:
                walk.append((insert_node(gcodes[off + pos:off + st]), 1))
            seg = gcodes[off + st:off + st + ln]
            walk.extend(block_steps(b, seg, strand))
            pos = st + ln
        if pos < total:
            walk.append((insert_node(gcodes[off + pos:off + total]), 1))
    return PanGraph(node_seq=node_seq, walks=walks, node_block=node_block)


# --------------------------------------------------------------------------
# GFA v1.1
# --------------------------------------------------------------------------

def write_gfa(path_or_file, graph: PanGraph, ref_name: str | None = None,
              with_walks: bool = True) -> None:
    """GFA: S-lines (nodes), L-lines (edges), P-line per haplotype
    (+ W-lines when with_walks, as graphmap-join emits for GBZ)."""
    own = not hasattr(path_or_file, "write")
    fh = open(path_or_file, "w") if own else path_or_file
    try:
        fh.write("H\tVN:Z:1.1\n")
        for v, codes in enumerate(graph.node_seq):
            s = _BASE_OF[codes].tobytes().decode("ascii")
            fh.write(f"S\t{v + 1}\t{s}\n")
        for u, ou, v, ov in sorted(graph.edges()):
            fh.write(f"L\t{u + 1}\t{'+' if ou == 1 else '-'}"
                     f"\t{v + 1}\t{'+' if ov == 1 else '-'}\t0M\n")
        for name, walk in graph.walks.items():
            p = ",".join(f"{v + 1}{'+' if o == 1 else '-'}"
                         for v, o in walk)
            fh.write(f"P\t{name}\t{p}\t*\n")
            if with_walks:
                sample = name.split(".", 1)[0]
                w = "".join(f"{'>' if o == 1 else '<'}{v + 1}"
                            for v, o in walk)
                total = sum(graph.node_len(v) for v, _o in walk)
                fh.write(f"W\t{sample}\t0\t{name}\t0\t{total}\t{w}\n")
    finally:
        if own:
            fh.close()


def read_gfa(path) -> PanGraph:
    """Load a GFA v1.x file into a PanGraph (vg-consumption analog):
    S-lines become nodes, P-lines (or W-lines when no P) become walks.
    Node ids may be arbitrary strings; they are densely renumbered.
    Edges are implied by the walks (as everywhere in this module)."""
    from ..io.fasta import _CODE_OF

    node_seq: list[np.ndarray] = []
    id_of: dict[str, int] = {}
    p_walks: dict[str, list[tuple[int, int]]] = {}
    w_walks: dict[str, list[tuple[int, int]]] = {}

    def nid(name: str) -> int:
        if name not in id_of:
            raise ValueError(f"GFA path references unknown segment "
                             f"{name!r}")
        return id_of[name]

    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                if len(f) < 3 or f[2] == "*":
                    raise ValueError(f"S-line without sequence: {f[:2]}")
                id_of[f[1]] = len(node_seq)
                node_seq.append(np.frombuffer(
                    f[2].upper().encode(), np.uint8))
            elif f[0] == "P":
                steps = []
                for tok in f[2].split(","):
                    steps.append((nid(tok[:-1]),
                                  1 if tok[-1] == "+" else -1))
                p_walks[f[1]] = steps
            elif f[0] == "W" and len(f) >= 7:
                steps = []
                tok = ""
                cur = 0
                for ch in f[6]:
                    if ch in "><":
                        if tok:
                            steps.append((nid(tok), cur))
                        cur = 1 if ch == ">" else -1
                        tok = ""
                    else:
                        tok += ch
                if tok:
                    steps.append((nid(tok), cur))
                w_walks[f[3] if f[3] != "*" else f[1]] = steps
    node_seq = [_CODE_OF[s] for s in node_seq]
    walks = p_walks or w_walks
    if not walks:
        raise ValueError("GFA has no P- or W-lines (no paths)")
    return PanGraph(node_seq=node_seq, walks=walks,
                    node_block=[-1] * len(node_seq))


def read_gfa_nodes(path) -> dict[int, str]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("S\t"):
                _s, vid, seq = line.rstrip("\n").split("\t")[:3]
                out[int(vid)] = seq
    return out


def graph_stats(graph: PanGraph) -> dict:
    lens = [graph.node_len(v) for v in range(graph.n_nodes)]
    return dict(
        n_nodes=graph.n_nodes,
        n_edges=len(graph.edges()),
        n_paths=len(graph.walks),
        total_node_length=int(sum(lens)),
        max_node_length=int(max(lens)) if lens else 0,
    )


_FRAG_RE = None


def _frag_name(name: str, a: int, b: int) -> tuple[str, int, int]:
    """Compose a subrange fragment name.  If `name` is already a
    fragment `orig:x-y` (from an earlier clip tier), the new offsets
    are made absolute in the ORIGINAL sequence so exclusion beds from
    successive tiers share one coordinate system (the reference keeps
    PanSN subrange offsets absolute the same way, vg clip / clip-vg)."""
    global _FRAG_RE
    if _FRAG_RE is None:
        import re
        _FRAG_RE = re.compile(r"^(.*):(\d+)-(\d+)$")
    m = _FRAG_RE.match(name)
    if m:
        base = int(m.group(2))
        return m.group(1), base + a, base + b
    return name, a, b


def _split_walks(graph: PanGraph, drop: set[int]):
    """Split every walk at dropped nodes.  Returns (new_walks, bed)
    where bed maps ORIGINAL sequence names to removed absolute
    intervals (shared machinery for the clip and filter tiers)."""
    new_walks: dict[str, list[tuple[int, int]]] = {}
    bed: dict[str, list[tuple[int, int]]] = {}
    for name, walk in graph.walks.items():
        pos = 0
        frags: list[tuple[int, int, list[tuple[int, int]]]] = []
        cur: list[tuple[int, int]] = []
        cur_start = 0
        removed: list[tuple[int, int]] = []
        for v, o in walk:
            ln = graph.node_len(v)
            if v in drop:
                if cur:
                    frags.append((cur_start, pos, cur))
                removed.append((pos, pos + ln))
                cur = []
                cur_start = pos + ln
            else:
                cur.append((v, o))
            pos += ln
        if cur:
            frags.append((cur_start, pos, cur))
        if removed:
            orig, _, _ = _frag_name(name, 0, 0)
            lst = bed.setdefault(orig, [])
            for a, b in removed:
                _, aa, bb = _frag_name(name, a, b)
                lst.append((aa, bb))
            for a, b, steps in frags:
                orig, aa, bb = _frag_name(name, a, b)
                new_walks[f"{orig}:{aa}-{bb}"] = steps
        else:
            new_walks[name] = walk
    return new_walks, bed


def filter_graph(graph: PanGraph, min_depth: int = 2,
                 ref_sample: str | None = None):
    """The graphmap-join "filter" tier (`vg clip -d`,
    cactus_graphmap_join.py:157 `--filter 2`): starting from the clip
    graph, drop every node traversed by fewer than `min_depth` DISTINCT
    samples, except nodes on the reference sample's paths (Giraffe
    needs the reference backbone intact).  Walks split into subrange
    fragments exactly like clip_graph.

    Returns (filtered PanGraph, bed of removed absolute intervals)."""
    from .normalize import compact
    samples_of: list[set[str]] = [set() for _ in range(graph.n_nodes)]
    for name, walk in graph.walks.items():
        sample = name.split(".", 1)[0]
        for v, _o in walk:
            samples_of[v].add(sample)
    keep_ref: set[int] = set()
    if ref_sample is not None:
        for name, walk in graph.walks.items():
            if name.split(".", 1)[0] == ref_sample:
                keep_ref.update(v for v, _o in walk)
    drop = {v for v in range(graph.n_nodes)
            if len(samples_of[v]) < min_depth and v not in keep_ref}
    new_walks, bed = _split_walks(graph, drop)
    out = PanGraph(node_seq=list(graph.node_seq), walks=new_walks,
                   node_block=list(graph.node_block))
    compact(out)
    return out, bed


def clip_graph(graph: PanGraph, max_unaligned: int = 10_000):
    """The graphmap-join "clip" tier: drop unaligned (haplotype-private)
    stretches longer than max_unaligned from the graph, splitting the
    affected walks into subrange fragments named `name:start-end`
    (reference clip-vg / `vg clip -u`, cactus_graphmap_join.py:652+,
    config XML :495-519).

    Returns (clipped PanGraph, bed) where bed maps each original walk
    name to the list of removed (start, end) intervals — together the
    fragments and the bed tile every input base (the exclusion-report
    closure invariant, pangenome_exclusions.py).
    """
    from .normalize import compact
    drop = {v for v in range(graph.n_nodes)
            if graph.node_block[v] < 0
            and graph.node_len(v) > max_unaligned}
    new_walks, bed = _split_walks(graph, drop)
    out = PanGraph(node_seq=list(graph.node_seq), walks=new_walks,
                   node_block=list(graph.node_block))
    compact(out)
    return out, bed
