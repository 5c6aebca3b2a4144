"""VCF export from the pangenome graph (vg deconstruct analog).

Reference flow: graphmap-join deconstructs the graph against the
reference path into VCF (+vcfbub/vcfwave cleanup; cactus_graphmap_join.py
:652+, config XML :493).  vcf_records covers simple bubbles —
 - block-allele sites (SNP/MNV): a block with >=2 allele nodes on the
   reference path;
 - insertions: a haplotype-private node between two blocks that are
   adjacent on the reference path;
 - deletions: a haplotype adjacency that skips reference-path nodes.
vcf_records_nested walks the full snarl tree and emits nested variants
with LV (level) tags; vcfbub/merge_duplicates post-process them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import revcomp, _BASE_OF
from .graph import PanGraph


def _s(codes: np.ndarray) -> str:
    return _BASE_OF[codes].tobytes().decode("ascii")


@dataclass
class VcfRecord:
    chrom: str
    pos: int          # 1-based
    ref: str
    alts: list[str]
    genotypes: dict[str, int]   # path name → allele index (0 = ref)
    lv: int = 0                 # snarl nesting level (vg deconstruct LV)

    def to_line(self, sample_order: list[str]) -> str:
        gts = []
        for s in sample_order:
            g = self.genotypes.get(s)
            gts.append("." if g is None else str(g))
        return "\t".join([
            self.chrom, str(self.pos), ".", self.ref,
            ",".join(self.alts), "60", "PASS", f"LV={self.lv}",
            "GT", *gts])


def merge_micro_anchors(records: list[VcfRecord], ref_seq: str,
                        min_anchor: int = 8) -> list[VcfRecord]:
    """Fuse same-sample records separated by < min_anchor ref bases.

    A chance k-mer match inside a long indel splits one event into
    fragments anchored on a tiny block; the reference pipeline repairs
    these by realignment in vcfwave (cactus_graphmap_join.py:652+,
    config XML :493).  Here adjacent single-alt records with identical
    genotype calls are spliced across the short intervening reference
    run: REF1+spacer+REF2 / ALT1+spacer+ALT2.
    """
    out: list[VcfRecord] = []
    for rec in sorted(records, key=lambda r: r.pos):
        if (out and len(rec.alts) == 1 and len(out[-1].alts) == 1
                and rec.genotypes == out[-1].genotypes):
            prev = out[-1]
            gap0 = prev.pos + len(prev.ref) - 1   # 0-based spacer start
            gap1 = rec.pos - 1                    # 0-based spacer end
            if 0 <= gap1 - gap0 < min_anchor:
                spacer = ref_seq[gap0:gap1]
                out[-1] = VcfRecord(
                    chrom=prev.chrom, pos=prev.pos,
                    ref=prev.ref + spacer + rec.ref,
                    alts=[prev.alts[0] + spacer + rec.alts[0]],
                    genotypes=prev.genotypes)
                continue
        out.append(rec)
    return out


def vcf_records(graph: PanGraph, ref_name: str,
                min_anchor: int = 8) -> list[VcfRecord]:
    ref_walk = graph.walks[ref_name]
    # reference coordinates per step
    ref_pos = []
    pos = 0
    for v, o in ref_walk:
        ref_pos.append(pos)
        pos += graph.node_len(v)
    ref_step_of_node = {v: k for k, (v, _o) in enumerate(ref_walk)}
    ref_block_step = {}
    for k, (v, _o) in enumerate(ref_walk):
        b = graph.node_block[v]
        if b >= 0:
            ref_block_step[b] = k

    # allele nodes per block
    alleles: dict[int, list[int]] = {}
    for v in range(graph.n_nodes):
        b = graph.node_block[v]
        if b >= 0:
            alleles.setdefault(b, []).append(v)

    other = [n for n in graph.walks if n != ref_name]
    records: list[VcfRecord] = []

    # ---- SNP / MNV sites ----
    for b, nodes in alleles.items():
        if len(nodes) < 2 or b not in ref_block_step:
            continue
        k = ref_block_step[b]
        v_ref, o_ref = ref_walk[k]

        def render(v):
            c = graph.node_seq[v]
            return _s(c if o_ref == 1 else revcomp(c))

        alts = [v for v in nodes if v != v_ref]
        allele_idx = {v_ref: 0}
        for j, v in enumerate(alts):
            allele_idx[v] = j + 1
        gts = {}
        for name in other:
            gt = None
            for v, _o in graph.walks[name]:
                if graph.node_block[v] == b:
                    gt = allele_idx[v]
                    break
            gts[name] = gt
        records.append(VcfRecord(
            chrom=ref_name, pos=ref_pos[k] + 1, ref=render(v_ref),
            alts=[render(v) for v in alts], genotypes=gts))

    # ---- simple insertions / deletions ----
    for name in other:
        walk = graph.walks[name]
        for idx in range(len(walk)):
            v, o = walk[idx]
            if graph.node_block[v] >= 0:
                continue
            # haplotype-private node: check flanks map to ref-adjacent steps
            if idx == 0 or idx == len(walk) - 1:
                continue
            u = walk[idx - 1][0]
            w = walk[idx + 1][0]
            ku = ref_step_of_node.get(u)
            kw = ref_step_of_node.get(w)
            if ku is None or kw is None:
                continue
            lo, hi = min(ku, kw), max(ku, kw)
            if hi - lo != 1:
                continue
            # anchor: last ref base before the insertion point
            anchor_pos = ref_pos[hi]  # 0-based start of the later ref node
            if anchor_pos == 0:
                continue
            anchor_step = hi - 1
            av, ao = ref_walk[anchor_step]
            anchor = _s(graph.node_seq[av][-1:] if ao == 1
                        else revcomp(graph.node_seq[av])[-1:])
            ins = _s(graph.node_seq[v] if o == 1
                     else revcomp(graph.node_seq[v]))
            records.append(VcfRecord(
                chrom=ref_name, pos=anchor_pos, ref=anchor,
                alts=[anchor + ins], genotypes={name: 1}))
        # deletions: consecutive walk steps whose ref steps skip nodes
        for (u, _ou), (w, _ow) in zip(walk, walk[1:]):
            ku = ref_step_of_node.get(u)
            kw = ref_step_of_node.get(w)
            if ku is None or kw is None:
                continue
            lo, hi = min(ku, kw), max(ku, kw)
            if hi - lo <= 1:
                continue
            start = ref_pos[lo + 1]
            end = ref_pos[hi]
            if start == 0:
                continue
            av, ao = ref_walk[lo]
            anchor = _s(graph.node_seq[av][-1:] if ao == 1
                        else revcomp(graph.node_seq[av])[-1:])
            deleted = "".join(
                _s(graph.node_seq[ref_walk[k][0]] if ref_walk[k][1] == 1
                   else revcomp(graph.node_seq[ref_walk[k][0]]))
                for k in range(lo + 1, hi))
            records.append(VcfRecord(
                chrom=ref_name, pos=start, ref=anchor + deleted,
                alts=[anchor], genotypes={name: 1}))
    records.sort(key=lambda r: r.pos)
    ref_seq = "".join(
        _s(graph.node_seq[v] if o == 1 else revcomp(graph.node_seq[v]))
        for v, o in ref_walk)
    return merge_micro_anchors(records, ref_seq, min_anchor=min_anchor)


def write_vcf(path_or_file, graph: PanGraph, ref_name: str,
              nested: bool = True, max_level: int | None = None,
              bub_max_ref_length: int | None = None,
              merge_dups: bool = False, wave: bool = False,
              device=None) -> None:
    """nested=True uses the anchor-chained snarl deconstruction with LV
    nesting tags; max_level drops deeper sites (vcfbub --max-level);
    bub_max_ref_length pops oversized top-level sites (vcfbub
    --max-ref-length); merge_dups fuses same-CHROM/POS/REF sites
    (collapse-bubble merge_duplicates); wave realigns complex sites
    into primitives (vcfwave) with the banded DP on `device` (None = the
    current CUDA device; only the wave tier touches a device)."""
    own = not hasattr(path_or_file, "write")
    fh = open(path_or_file, "w") if own else path_or_file
    try:
        samples = [n for n in graph.walks if n != ref_name]
        ref_len = sum(graph.node_len(v) for v, _o in graph.walks[ref_name])
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={ref_name},length={ref_len}>\n")
        fh.write('##INFO=<ID=LV,Number=1,Type=Integer,'
                 'Description="Snarl nesting level">\n')
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples) + "\n")
        recs = (vcf_records_nested(graph, ref_name) if nested
                else vcf_records(graph, ref_name))
        if merge_dups:
            recs = merge_duplicates(recs)
        if bub_max_ref_length is not None:
            recs = vcfbub(recs, max_level=max_level or 0,
                          max_ref_length=bub_max_ref_length)
        if wave:
            recs = merge_duplicates(vcfwave(recs, device=device))
        for rec in recs:
            if max_level is not None and rec.lv > max_level:
                continue
            fh.write(rec.to_line(samples) + "\n")
    finally:
        if own:
            fh.close()


# --------------------------------------------------------------------------
# nested deconstruction (vg deconstruct + snarl-tree analog)
# --------------------------------------------------------------------------

def _walk_string_offsets(graph: PanGraph, walk):
    """(spelled string, per-step base offset array)."""
    parts = []
    offs = []
    pos = 0
    for v, o in walk:
        offs.append(pos)
        c = graph.node_seq[v]
        parts.append(_s(c if o == 1 else revcomp(c)))
        pos += len(c)
    offs.append(pos)
    return "".join(parts), offs


def _lis_indices(seq: list[int]) -> list[int]:
    """Longest strictly-increasing subsequence → indices into seq."""
    import bisect
    tails: list[int] = []          # values
    tails_idx: list[int] = []      # index in seq of tail
    prev = [-1] * len(seq)
    for i, x in enumerate(seq):
        j = bisect.bisect_left(tails, x)
        if j == len(tails):
            tails.append(x)
            tails_idx.append(i)
        else:
            tails[j] = x
            tails_idx[j] = i
        prev[i] = tails_idx[j - 1] if j > 0 else -1
    out = []
    k = tails_idx[-1] if tails_idx else -1
    while k >= 0:
        out.append(k)
        k = prev[k]
    return out[::-1]


def vcf_records_nested(graph: PanGraph, ref_name: str) -> list[VcfRecord]:
    """Anchor-chained deconstruction of every haplotype against the
    reference path, with nesting levels.

    Anchors are nodes unique to both walks; the longest colinear anchor
    chain splits each haplotype into matched blocks, and every mismatched
    stretch between consecutive anchors becomes one (padded) VCF site —
    SNP, indel, MNV, or complex replacement alike.  Sites whose reference
    span lies strictly inside another site's span get LV = depth (the
    vg deconstruct snarl-nesting annotation; vcfbub keeps LV=0 by
    default — reference cactus_graphmap_join.py:652+, config XML :493).
    """
    ref_walk = graph.walks[ref_name]
    ref_seq, ref_offs = _walk_string_offsets(graph, ref_walk)
    ref_count: dict[int, int] = {}
    for v, _o in ref_walk:
        ref_count[v] = ref_count.get(v, 0) + 1
    ref_step_of = {v: k for k, (v, _o) in enumerate(ref_walk)
                   if ref_count[v] == 1}

    sites: dict[tuple[int, str], dict] = {}
    for name, walk in graph.walks.items():
        if name == ref_name:
            continue
        alt_seq, alt_offs = _walk_string_offsets(graph, walk)
        count: dict[int, int] = {}
        for v, _o in walk:
            count[v] = count.get(v, 0) + 1
        cand = [(i, ref_step_of[v]) for i, (v, _o) in enumerate(walk)
                if count[v] == 1 and v in ref_step_of]
        if not cand:
            continue
        keep = _lis_indices([k for _i, k in cand])
        chain = [cand[i] for i in keep]     # [(alt step, ref step)]
        for (ia, ka), (ib, kb) in zip(chain, chain[1:]):
            r0, r1 = ref_offs[ka + 1], ref_offs[kb]     # between anchors
            a0, a1 = alt_offs[ia + 1], alt_offs[ib]
            R, A = ref_seq[r0:r1], alt_seq[a0:a1]
            if R == A:
                continue
            # pad with the last base of the left anchor (VCF convention)
            pos0 = r0 - 1                                # 0-based anchor
            ref_str = ref_seq[pos0:r1]
            alt_str = ref_seq[pos0] + A
            key = (pos0 + 1, ref_str)
            site = sites.setdefault(key, {"alts": [], "gts": {}})
            if alt_str not in site["alts"]:
                site["alts"].append(alt_str)
            site["gts"][name] = site["alts"].index(alt_str) + 1
    records = []
    for (pos, ref_str), site in sorted(sites.items()):
        records.append(VcfRecord(chrom=ref_name, pos=pos, ref=ref_str,
                                 alts=site["alts"],
                                 genotypes=site["gts"]))
    # nesting levels by strict containment of reference spans
    spans = [(r.pos, r.pos + len(r.ref)) for r in records]
    for i, r in enumerate(records):
        lv = 0
        for j, (a, b) in enumerate(spans):
            if j != i and a <= spans[i][0] and spans[i][1] <= b \
                    and (a, b) != spans[i]:
                lv += 1
        r.lv = lv
    return records


# --------------------------------------------------------------------------
# vcfwave: realignment decomposition of complex sites
# --------------------------------------------------------------------------

def _codes(s: str) -> np.ndarray:
    from ..io.fasta import _CODE_OF
    return _CODE_OF[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]


def _left_shift(pos: int, ref: str, alt: str, rec_ref: str,
                rec_pos: int) -> tuple[int, str, str]:
    """Normalize an anchored indel by shifting left within the record's
    own reference allele (vt-normalize semantics, record-local)."""
    while len(ref) != len(alt) and pos > rec_pos:
        long, short = (ref, alt) if len(ref) > len(alt) else (alt, ref)
        if len(short) != 1 or long[-1] != short[0]:
            break
        prev = rec_ref[pos - 1 - rec_pos]
        pos -= 1
        if len(ref) > len(alt):
            ref, alt = prev + long[:-1], prev
        else:
            ref, alt = prev, prev + long[:-1]
    return pos, ref, alt


def _decompose_cigar(rec: VcfRecord, alt: str, ops) -> list[tuple]:
    """Walk one REF/ALT affine alignment into primitive (pos, ref, alt)
    triples.  ops consume q=alt ('I' inserts alt bases), t=ref."""
    prims: list[tuple[int, str, str]] = []
    rp = ap = 0
    R, A = rec.ref, alt
    for op, ln in ops:
        if op == "M":
            for k in range(ln):
                if R[rp + k] != A[ap + k]:
                    prims.append((rec.pos + rp + k, R[rp + k], A[ap + k]))
            rp += ln
            ap += ln
        elif op == "I":                      # insertion relative to ref
            if rp > 0:
                p, r, a = (rec.pos + rp - 1, R[rp - 1],
                           R[rp - 1] + A[ap:ap + ln])
            else:                            # left edge: right-anchor
                p, r, a = rec.pos, R[0], A[ap:ap + ln] + R[0]
            prims.append(_left_shift(p, r, a, R, rec.pos))
            ap += ln
        else:                                # 'D': deletion from ref
            if rp > 0:
                p, r, a = (rec.pos + rp - 1, R[rp - 1:rp + ln], R[rp - 1])
            else:
                p, r, a = rec.pos, R[:ln + 1], R[ln]
            prims.append(_left_shift(p, r, a, R, rec.pos))
            rp += ln
    return prims


def vcfwave(records: list[VcfRecord], band: int | None = None,
            max_allele: int = 100_000, device=None) -> list[VcfRecord]:
    """Realignment decomposition of complex VCF sites (vcfwave analog).

    The reference pipeline post-processes graph VCFs with `vcfwave`,
    which realigns every ALT allele against REF (bi-WFA) and re-emits
    the site as primitive SNP/ins/del records with genotypes carried
    over (cactus_graphmap_join.py:652+, config XML :493 `vcfwave`).

    Device shape: ALL (alt, ref) allele pairs across every record are
    packed into ONE batched banded-DP call (`align_pairs_banded` runs
    the banded_dp and banded_traceback kernels on a CUDA `device`, None
    = the current one); cigar decomposition and genotype remapping stay
    on host.  Primitive records are re-anchored
    per VCF convention and indels are left-shift normalized within the
    record.  Sites longer than max_allele pass through unchanged.
    """
    from ..config import PoaParams
    from ..ops.banded import GapParams, align_pairs_banded, score_matrix_6

    # gather the complex alleles
    jobs: list[tuple[int, int]] = []      # (record idx, alt idx)
    pairs = []
    for ri, rec in enumerate(records):
        if len(rec.ref) == 1 and all(len(a) == 1 for a in rec.alts):
            continue                      # pure SNP/MNV of width 1
        if len(rec.ref) > max_allele or any(len(a) > max_allele
                                            for a in rec.alts):
            continue
        for ai, alt in enumerate(rec.alts):
            simple = (len(rec.ref) == 1 and alt[:1] == rec.ref) or \
                     (len(alt) == 1 and rec.ref[:1] == alt)
            if alt == rec.ref or simple:
                continue                  # already a primitive indel
            jobs.append((ri, ai))
            pairs.append((_codes(alt), _codes(rec.ref)))
    if not jobs:
        return sorted(records, key=lambda r: (r.chrom, r.pos))

    if band is None:
        spread = max(abs(len(q) - len(t)) for q, t in pairs)
        band = max(64, 1 << int(spread + 33 - 1).bit_length())
    submat = score_matrix_6(PoaParams().sub_matrix)
    aligned = align_pairs_banded(pairs, submat, GapParams(), band=band,
                                 device=device)

    prim_of: dict[int, dict[int, list[tuple]]] = {}
    for (ri, ai), (_score, ops) in zip(jobs, aligned):
        prim_of.setdefault(ri, {})[ai] = _decompose_cigar(
            records[ri], records[ri].alts[ai], ops)

    out: list[VcfRecord] = []
    for ri, rec in enumerate(records):
        by_alt = prim_of.get(ri)
        if by_alt is None:
            out.append(rec)
            continue
        # sites keyed by (pos, ref); allele lists merged across ALTs
        sites: dict[tuple[int, str], dict] = {}
        alt_site_allele: dict[int, dict[tuple[int, str], int]] = {}
        for ai in range(len(rec.alts)):
            prims = by_alt.get(ai)
            if prims is None:             # this ALT was already primitive
                prims = [(rec.pos, rec.ref, rec.alts[ai])]
            amap: dict[tuple[int, str], int] = {}
            for pos, ref, alt in prims:
                site = sites.setdefault((pos, ref), {"alts": []})
                if alt not in site["alts"]:
                    site["alts"].append(alt)
                amap[(pos, ref)] = site["alts"].index(alt) + 1
            alt_site_allele[ai] = amap
        for (pos, ref), site in sorted(sites.items()):
            gts = {}
            for sample, g in rec.genotypes.items():
                if g is None:
                    gts[sample] = None
                elif g == 0:
                    gts[sample] = 0
                else:
                    gts[sample] = alt_site_allele[g - 1].get((pos, ref), 0)
            out.append(VcfRecord(chrom=rec.chrom, pos=pos, ref=ref,
                                 alts=site["alts"], genotypes=gts,
                                 lv=rec.lv))
    return sorted(out, key=lambda r: (r.chrom, r.pos))


# --------------------------------------------------------------------------
# VCF post-processing: vcfbub + collapse-bubble merge_duplicates
# --------------------------------------------------------------------------

def vcfbub(records: list[VcfRecord], max_level: int = 0,
           max_ref_length: int | None = None) -> list[VcfRecord]:
    """vcfbub semantics (graphmap-join runs `vcfbub --max-level 0
    --max-ref-length 100000`, cactus_graphmap_join.py:652+): keep
    top-level sites (LV ≤ max_level); when a kept site's reference
    allele exceeds max_ref_length, "pop" it — drop the giant record and
    keep the nested records inside its span instead."""
    spans = {id(r): (r.pos, r.pos + len(r.ref)) for r in records}
    popped_spans: list[tuple[int, int]] = []
    out: list[VcfRecord] = []
    for r in sorted(records, key=lambda r: (r.pos, -len(r.ref))):
        if r.lv <= max_level:
            if max_ref_length is not None and len(r.ref) > max_ref_length:
                popped_spans.append(spans[id(r)])
                continue
            out.append(r)
        else:
            a, b = spans[id(r)]
            if any(pa <= a and b <= pb for pa, pb in popped_spans):
                out.append(r)
    return sorted(out, key=lambda r: r.pos)


def merge_duplicates(records: list[VcfRecord]) -> list[VcfRecord]:
    """collapse-bubble merge_duplicates (config XML :493): records at
    the same CHROM/POS/REF fuse into one site — ALT lists union (stable
    order), genotypes remapped; conflicting genotype calls for one
    sample keep the first (deterministic input order)."""
    merged: dict[tuple[str, int, str], VcfRecord] = {}
    order: list[tuple[str, int, str]] = []
    for r in records:
        key = (r.chrom, r.pos, r.ref)
        m = merged.get(key)
        if m is None:
            merged[key] = VcfRecord(chrom=r.chrom, pos=r.pos, ref=r.ref,
                                    alts=list(r.alts),
                                    genotypes=dict(r.genotypes), lv=r.lv)
            order.append(key)
            continue
        remap = {}
        for ai, alt in enumerate(r.alts, start=1):
            if alt not in m.alts:
                m.alts.append(alt)
            remap[ai] = m.alts.index(alt) + 1
        for sample, g in r.genotypes.items():
            if sample not in m.genotypes:
                m.genotypes[sample] = remap.get(g, g) if g else g
        m.lv = min(m.lv, r.lv)
    return [merged[k] for k in order]
