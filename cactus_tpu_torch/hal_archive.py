"""Durable single-file HAL archive (the HDF5 HAL equivalent).

The reference stores the finished alignment in an HDF5 "HAL" archive —
per-genome DNA plus top/bottom segment arrays parented on the ancestor
— built by appending one ancestor subtree at a time
(halAppendCactusSubtree; progressive/cactus_progressive.py:249-292) and
consumed by halStats / hal2fasta / hal2maf / halValidate /
halRemoveDupes (hal submodule CLI tools).

TPU-native equivalent: a custom append-only container instead of HDF5.

File layout::

    magic "CTHAL001"
    blob 0 | blob 1 | ...            raw little-endian array bytes
    toc json (utf-8)
    uint64 toc_len | magic "CTHALEND"

Appending a subtree re-reads the TOC, truncates it, appends only the
new blobs, and rewrites the TOC — O(new data), like HDF5 extents.
Reads go through ``np.memmap`` per blob, so opening a multi-GB archive
costs only the TOC parse, and segment arrays can be handed to JAX
zero-copy from the page cache.

Per-genome contents (the HAL data model, hal/impl/hal.c:14-77 grammar):

 - sequences: ordered (name, length) list;
 - DNA: 2-bit packed codes + packed N-mask (io/fasta.pack_2bit);
 - bottom segments (ancestors): seq idx / start / length / block name
   (-1 = unaligned filler between blocks);
 - top segments (non-roots): seq idx / start / length / parent block
   name in the parent's bottom list (-1 = insertion) / orientation.

Top and bottom segments of one block are equal length (ungapped), as in
HAL — a pinch block's member segments all share the block length.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from .io.fasta import Sequence, pack_2bit, unpack_2bit, revcomp, _BASE_OF
from .io.maf import MafBlock, MafRow

MAGIC = b"CTHAL001"
END = b"CTHALEND"


class _BlobWriter:
    def __init__(self, fh):
        self.fh = fh

    def write(self, arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        off = self.fh.tell()
        self.fh.write(arr.tobytes())
        return {"off": off, "nbytes": arr.nbytes,
                "dtype": arr.dtype.str, "shape": list(arr.shape)}


def _genome_entry():
    return {"parent": None, "sequences": [], "arrays": {}}


class HalArchive:
    """Open/append/read a .hal archive file."""

    def __init__(self, path: str, toc: dict):
        self.path = path
        self.toc = toc

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, path: str, newick: str = "",
               metadata: dict | None = None) -> "HalArchive":
        toc = {"newick": newick, "metadata": metadata or {}, "genomes": {}}
        with open(path, "wb") as fh:
            fh.write(MAGIC)
        arc = cls(path, toc)
        arc._write_toc()
        return arc

    @classmethod
    def open(cls, path: str) -> "HalArchive":
        with open(path, "rb") as fh:
            if fh.read(8) != MAGIC:
                raise ValueError(f"{path}: not a CTHAL archive")
            fh.seek(-16, os.SEEK_END)
            toc_len, = struct.unpack("<Q", fh.read(8))
            if fh.read(8) != END:
                raise ValueError(f"{path}: truncated archive (no end magic)")
            fh.seek(-16 - toc_len, os.SEEK_END)
            toc = json.loads(fh.read(toc_len).decode("utf-8"))
        return cls(path, toc)

    def _write_toc(self) -> None:
        data = json.dumps(self.toc).encode("utf-8")
        with open(self.path, "r+b") as fh:
            fh.seek(self._data_end())
            fh.write(data)
            fh.write(struct.pack("<Q", len(data)))
            fh.write(END)
            fh.truncate()

    def _data_end(self) -> int:
        end = len(MAGIC)
        for g in self.toc["genomes"].values():
            for a in g["arrays"].values():
                end = max(end, a["off"] + a["nbytes"])
        return end

    def _append_blobs(self, fn) -> None:
        """fn(writer) appends blobs; then the TOC is rewritten."""
        with open(self.path, "r+b") as fh:
            fh.seek(self._data_end())
            fn(_BlobWriter(fh))
            pos = fh.tell()
            fh.truncate(pos)
        self._write_toc()

    def _load(self, event: str, key: str) -> np.ndarray:
        a = self.toc["genomes"][event]["arrays"][key]
        if a["nbytes"] == 0:
            return np.zeros(tuple(a["shape"]) or (0,),
                            dtype=np.dtype(a["dtype"]))
        mm = np.memmap(self.path, mode="r", dtype=np.dtype(a["dtype"]),
                       offset=a["off"], shape=tuple(a["shape"]) or (0,))
        return mm

    # ------------------------------------------------------------------
    # writing genomes
    # ------------------------------------------------------------------

    def _ensure_genome(self, event: str, parent: str | None) -> dict:
        g = self.toc["genomes"].setdefault(event, _genome_entry())
        if parent is not None:
            g["parent"] = parent
        return g

    def add_dna(self, event: str, seqs: dict[str, Sequence],
                parent: str | None = None) -> None:
        g = self._ensure_genome(event, parent)
        if "dna" in g["arrays"]:
            return
        g["sequences"] = [[n, len(s)] for n, s in seqs.items()]
        codes = (np.concatenate([s.codes for s in seqs.values()])
                 if seqs else np.zeros(0, np.uint8))
        packed, n_mask = pack_2bit(codes)

        def emit(w):
            g["arrays"]["dna"] = w.write(packed)
            g["arrays"]["n_mask"] = w.write(np.packbits(n_mask))
        self._append_blobs(emit)

    def set_bottom(self, event: str, seq_idx, start, length, name) -> None:
        g = self._ensure_genome(event, None)

        def emit(w):
            g["arrays"]["bot_seq"] = w.write(np.asarray(seq_idx, np.int32))
            g["arrays"]["bot_start"] = w.write(np.asarray(start, np.int64))
            g["arrays"]["bot_len"] = w.write(np.asarray(length, np.int64))
            g["arrays"]["bot_name"] = w.write(np.asarray(name, np.int64))
        self._append_blobs(emit)

    def set_top(self, event: str, seq_idx, start, length, parent_name,
                orient) -> None:
        g = self._ensure_genome(event, None)

        def emit(w):
            g["arrays"]["top_seq"] = w.write(np.asarray(seq_idx, np.int32))
            g["arrays"]["top_start"] = w.write(np.asarray(start, np.int64))
            g["arrays"]["top_len"] = w.write(np.asarray(length, np.int64))
            g["arrays"]["top_parent"] = w.write(
                np.asarray(parent_name, np.int64))
            g["arrays"]["top_orient"] = w.write(
                np.asarray(orient, np.int8))
        self._append_blobs(emit)

    def append_subtree(self, step, anc_genome: dict[str, Sequence],
                       child_genomes: dict[str, dict[str, Sequence]]) -> None:
        """halAppendCactusSubtree equivalent: import one ancestor step.

        Writes the ancestor's DNA + bottom segments and each child
        genome's DNA + top segments (children that are themselves
        ancestors get their bottoms from their own later append).
        """
        from .phases.hal import read_c2h, write_c2h
        import io as _io
        buf = _io.StringIO()
        write_c2h(step, buf)          # single source of truth for segments
        buf.seek(0)
        recs = read_c2h(buf)
        self.add_dna(step.event, anc_genome)
        # bottom: ancestor sequences (is_bottom records, in step order)
        seq_names = [n for n, _l in self.toc["genomes"][step.event]
                     ["sequences"]]
        seq_of = {n: i for i, n in enumerate(seq_names)}
        bs, bst, bln, bnm = [], [], [], []
        tops: dict[str, list[tuple[int, int, int, int, int]]] = {}
        for rec in recs:
            if rec.is_bottom:
                si = seq_of[rec.header]
                for name, start, length in rec.segments:
                    bs.append(si); bst.append(start)
                    bln.append(length)
                    # filler names (>=1<<40) are unaligned gaps
                    bnm.append(-1 if name >= (1 << 40) else name)
            else:
                tops.setdefault(rec.event, []).append((rec.header,
                                                       rec.segments))
        self.set_bottom(step.event, bs, bst, bln, bnm)
        for ev, seq_recs in tops.items():
            if ev not in step.ingroup_events:
                continue        # outgroups belong to their own parent
            genome = child_genomes[ev]
            self.add_dna(ev, genome, parent=step.event)
            names = [n for n, _l in self.toc["genomes"][ev]["sequences"]]
            seq_of_c = {n: i for i, n in enumerate(names)}
            ts, tst, tln, tpn, tor = [], [], [], [], []
            for header, segments in seq_recs:
                si = seq_of_c[header]
                for seg in segments:
                    if len(seg) == 2:          # insertion
                        start, length = seg
                        parent, orient = -1, 1
                    else:
                        start, length, parent, rev = seg
                        orient = -1 if rev else 1
                    ts.append(si); tst.append(start); tln.append(length)
                    tpn.append(parent); tor.append(orient)
            self.set_top(ev, ts, tst, tln, tpn, tor)

    @classmethod
    def from_result(cls, path: str, result,
                    metadata: dict | None = None) -> "HalArchive":
        """Build a whole archive from a ProgressiveResult, root first
        (the export_hal BFS over subtree roots)."""
        arc = cls.create(path, newick=result.tree.to_newick(),
                         metadata=metadata)
        for node in result.tree.preorder():
            step = result.steps.get(node.name)
            if step is None:
                continue
            children = {c.name: result.genomes[c.name]
                        for c in node.children
                        if c.name in result.genomes}
            arc.append_subtree(step, result.genomes[node.name], children)
        return arc

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------

    def genomes(self) -> list[str]:
        return list(self.toc["genomes"])

    def parent(self, event: str) -> str | None:
        return self.toc["genomes"][event]["parent"]

    def children(self, event: str) -> list[str]:
        return [e for e, g in self.toc["genomes"].items()
                if g["parent"] == event]

    def sequences(self, event: str) -> list[tuple[str, int]]:
        return [(n, l) for n, l in self.toc["genomes"][event]["sequences"]]

    def dna(self, event: str) -> dict[str, Sequence]:
        """hal2fasta equivalent: decode a genome's sequences."""
        g = self.toc["genomes"][event]
        total = sum(l for _n, l in g["sequences"])
        packed = self._load(event, "dna")
        n_mask = np.unpackbits(self._load(event, "n_mask"))[:total]\
            .astype(bool)
        codes = unpack_2bit(np.asarray(packed), total, n_mask)
        out, pos = {}, 0
        for name, length in g["sequences"]:
            out[name] = Sequence(name, codes[pos:pos + length])
            pos += length
        return out

    def stats(self) -> list[dict]:
        """halStats genome table from the archive alone."""
        rows = []
        for ev, g in self.toc["genomes"].items():
            n_bot = n_top = 0
            if "bot_name" in g["arrays"]:
                n_bot = int((np.asarray(self._load(ev, "bot_name"))
                             >= 0).sum())
            if "top_parent" in g["arrays"]:
                n_top = int((np.asarray(self._load(ev, "top_parent"))
                             >= 0).sum())
            rows.append(dict(genome=ev, n_sequences=len(g["sequences"]),
                             length=sum(l for _n, l in g["sequences"]),
                             n_top_segments=n_top,
                             n_bottom_segments=n_bot))
        return rows

    def validate(self) -> list[str]:
        """halValidate over the archive: bounds, tiling, parent links."""
        errs: list[str] = []
        for ev, g in self.toc["genomes"].items():
            lens = np.array([l for _n, l in g["sequences"]], np.int64)
            for kind in ("bot", "top"):
                if f"{kind}_seq" not in g["arrays"]:
                    continue
                si = np.asarray(self._load(ev, f"{kind}_seq"))
                st = np.asarray(self._load(ev, f"{kind}_start"))
                ln = np.asarray(self._load(ev, f"{kind}_len"))
                if len(si) and (si.max() >= len(lens) or si.min() < 0):
                    errs.append(f"{ev}: {kind} segment on unknown seq")
                    continue
                bad = (st < 0) | (st + ln > lens[si]) if len(si) else \
                    np.zeros(0, bool)
                if bad.any():
                    errs.append(f"{ev}: {int(bad.sum())} {kind} segments "
                                "out of bounds")
                # segments must tile each sequence exactly
                order = np.lexsort((st, si))
                s_si, s_st, s_ln = si[order], st[order], ln[order]
                brk = np.flatnonzero(np.diff(s_si)) + 1
                starts = np.concatenate([[0], brk])
                ends = np.concatenate([brk, [len(s_si)]])
                for a, b in zip(starts, ends):
                    if a == b:
                        continue
                    if s_st[a] != 0 or \
                       s_st[b - 1] + s_ln[b - 1] != lens[s_si[a]] or \
                       (s_st[a + 1:b] != (s_st[a:b - 1]
                                          + s_ln[a:b - 1])).any():
                        errs.append(f"{ev}: {kind} segments do not tile "
                                    f"sequence {g['sequences'][s_si[a]][0]}")
            # parent links resolve, with equal segment length
            if "top_parent" in g["arrays"]:
                par = g["parent"]
                if par is None:
                    errs.append(f"{ev}: top segments but no parent")
                    continue
                pnames = np.asarray(self._load(par, "bot_name"))
                plens = np.asarray(self._load(par, "bot_len"))
                tp = np.asarray(self._load(ev, "top_parent"))
                tl = np.asarray(self._load(ev, "top_len"))
                sel = tp >= 0
                pos = {int(n): i for i, n in enumerate(pnames) if n >= 0}
                miss = [int(x) for x in tp[sel] if int(x) not in pos]
                if miss:
                    errs.append(f"{ev}: {len(miss)} top segments with "
                                "unresolved parent block")
                else:
                    idx = np.array([pos[int(x)] for x in tp[sel]],
                                   np.int64)
                    if len(idx) and (plens[idx] != tl[sel]).any():
                        errs.append(f"{ev}: top/bottom length mismatch")
        return errs

    def remove_dupes(self, event: str) -> int:
        """halRemoveDupes equivalent: keep one top segment per parent
        block (first by coordinate), demote the rest to insertions.
        Returns the number of segments demoted."""
        g = self.toc["genomes"][event]
        tp = np.array(self._load(event, "top_parent"))
        si = np.asarray(self._load(event, "top_seq"))
        st = np.asarray(self._load(event, "top_start"))
        ln = np.asarray(self._load(event, "top_len"))
        orient = np.asarray(self._load(event, "top_orient"))
        order = np.lexsort((st, si))
        seen: set[int] = set()
        demoted = 0
        for i in order:
            p = int(tp[i])
            if p < 0:
                continue
            if p in seen:
                tp[i] = -1
                demoted += 1
            else:
                seen.add(p)
        if demoted:
            self.set_top(event, si, st, ln, tp, orient)
        return demoted

    # ------------------------------------------------------------------
    # hal2maf: true hierarchical segment walk
    # ------------------------------------------------------------------

    # -- halLiftover / halSnps analogs ------------------------------------

    def _top_index(self, event: str):
        """Aligned top segments sorted by (seq, start)."""
        g = self.toc["genomes"][event]
        if "top_seq" not in g["arrays"]:
            return None
        si = np.asarray(self._load(event, "top_seq"))
        st = np.asarray(self._load(event, "top_start"))
        ln = np.asarray(self._load(event, "top_len"))
        pn = np.asarray(self._load(event, "top_parent"))
        orient = np.asarray(self._load(event, "top_orient"))
        keep = pn >= 0
        si, st, ln, pn, orient = (si[keep], st[keep], ln[keep], pn[keep],
                                  orient[keep])
        order = np.lexsort((st, si))
        return si[order], st[order], ln[order], pn[order], orient[order]

    def _bots_by_name(self, event: str):
        """block name → (seq idx, start, len) of the bottom segment."""
        g = self.toc["genomes"][event]
        if "bot_seq" not in g["arrays"]:
            return {}
        si = np.asarray(self._load(event, "bot_seq"))
        st = np.asarray(self._load(event, "bot_start"))
        ln = np.asarray(self._load(event, "bot_len"))
        nm = np.asarray(self._load(event, "bot_name"))
        return {int(n): (int(s), int(a), int(l))
                for n, s, a, l in zip(nm, si, st, ln) if n >= 0}

    def _tree_path(self, src: str, dst: str):
        """(ups, downs): events to climb from src to the MRCA, then the
        child chain to descend to dst."""
        anc_src = [src]
        while self.parent(anc_src[-1]) is not None:
            anc_src.append(self.parent(anc_src[-1]))
        anc_dst = [dst]
        while self.parent(anc_dst[-1]) is not None:
            anc_dst.append(self.parent(anc_dst[-1]))
        set_dst = {e: i for i, e in enumerate(anc_dst)}
        for ui, ev in enumerate(anc_src):
            if ev in set_dst:
                return anc_src[:ui], list(reversed(anc_dst[:set_dst[ev]]))
        raise ValueError(f"{src} and {dst} share no ancestor")

    @staticmethod
    def _sub_src(run, r0: int, ln: int):
        """Source coordinates of an ln-long slice at offset r0 of run."""
        s0, L, strand = run
        return s0 + r0 if strand == 1 else s0 + L - r0 - ln

    def liftover(self, src: str, intervals, dst: str):
        """Map intervals of `src` onto `dst` through the alignment
        (halLiftover): up the tree to the MRCA via top segments, down
        via bottom→child-top blocks.  Duplications in the destination
        emit one run per copy.

        intervals: [(seq_name, start, end)] on src.
        Returns [(src_seq, src_start, dst_seq, dst_start, length,
        strand)] runs where src_start+k maps to dst_start+k (strand 1)
        or dst_start+length-1-k (strand -1).

        Reference: hal submodule halLiftover (SURVEY §2.2 hal row);
        BED liftover via the same top/bottom segment composition.
        """
        ups, downs = self._tree_path(src, dst)
        seq_idx_of = {ev: {n: i for i, (n, _l) in
                           enumerate(self.toc["genomes"][ev]["sequences"])}
                      for ev in self.genomes()}
        seq_names = {ev: [n for n, _l in
                          self.toc["genomes"][ev]["sequences"]]
                     for ev in self.genomes()}
        # runs: (seq_idx, start, length, strand, src_seq, src_start)
        runs = []
        for name, a, b in intervals:
            if name not in seq_idx_of[src]:
                raise KeyError(
                    f"{name!r} is not a sequence of {src}; known: "
                    f"{sorted(seq_idx_of[src])}")
            if b > a:
                runs.append((seq_idx_of[src][name], a, b - a, 1, name, a))

        for ev in ups:                        # climb: ev → parent(ev)
            tops = self._top_index(ev)
            bots = self._bots_by_name(self.parent(ev))
            nxt = []
            if tops is None:
                runs = []
                break
            tsi, tst, tln, tpn, tor = tops
            for si, a, L, strand, sname, s0 in runs:
                lo = np.searchsorted(tsi, si, side="left")
                hi = np.searchsorted(tsi, si, side="right")
                k0 = lo + np.searchsorted(tst[lo:hi], a, side="right") - 1
                for k in range(max(k0, lo), hi):
                    oa = max(a, int(tst[k]))
                    ob = min(a + L, int(tst[k]) + int(tln[k]))
                    if ob <= oa:
                        if int(tst[k]) >= a + L:
                            break
                        continue
                    blk = bots.get(int(tpn[k]))
                    if blk is None:
                        continue
                    psi, pst, pln = blk
                    d0 = oa - int(tst[k])
                    ln = ob - oa
                    o = int(tor[k])
                    pa = pst + d0 if o == 1 else pst + pln - d0 - ln
                    ns0 = self._sub_src((s0, L, strand), oa - a, ln)
                    nxt.append((psi, pa, ln, strand * o, sname, ns0))
            runs = nxt

        for ev in downs:                      # descend: parent(ev) → ev
            par = self.parent(ev)
            bindex = self._bottom_index(par)
            if bindex is None:
                runs = []
                break
            b_si, b_st, b_ln, b_nm = bindex
            # target child's top segments grouped by block name
            ctops: dict[int, list] = {}
            tops = self._top_index(ev)
            if tops is None:
                runs = []
                break
            for si, st, ln, pn, orient in zip(*tops):
                ctops.setdefault(int(pn), []).append(
                    (int(si), int(st), int(ln), int(orient)))
            nxt = []
            for si, a, L, strand, sname, s0 in runs:
                lo = np.searchsorted(b_si, si, side="left")
                hi = np.searchsorted(b_si, si, side="right")
                k0 = lo + np.searchsorted(b_st[lo:hi], a, side="right") - 1
                for k in range(max(k0, lo), hi):
                    oa = max(a, int(b_st[k]))
                    ob = min(a + L, int(b_st[k]) + int(b_ln[k]))
                    if ob <= oa:
                        if int(b_st[k]) >= a + L:
                            break
                        continue
                    if int(b_nm[k]) < 0:
                        continue
                    ln = ob - oa
                    d0 = oa - int(b_st[k])
                    for csi, cst, cln, o in ctops.get(int(b_nm[k]), ()):
                        ca = cst + d0 if o == 1 else cst + cln - d0 - ln
                        ns0 = self._sub_src((s0, L, strand), oa - a, ln)
                        nxt.append((csi, ca, ln, strand * o, sname, ns0))
            runs = nxt

        return [(sname, s0, seq_names[dst][si], int(a), int(L), strand)
                for si, a, L, strand, sname, s0 in runs]

    def snps(self, src: str, dst: str, intervals=None):
        """Single-base differences between aligned src/dst positions
        (halSnps analog).  Returns [(src_seq, src_pos, src_base,
        dst_seq, dst_pos, dst_base)]."""
        from .io.fasta import _BASE_OF, _COMP
        if intervals is None:
            intervals = [(n, 0, l) for n, l in
                         self.toc["genomes"][src]["sequences"]]
        runs = self.liftover(src, intervals, dst)
        sdna = self.dna(src)
        ddna = self.dna(dst)
        out = []
        for sname, s0, dname, d0, L, strand in runs:
            sc = sdna[sname].codes[s0:s0 + L]
            dc = ddna[dname].codes[d0:d0 + L]
            if strand == -1:
                dc = _COMP[dc[::-1]]
            diff = np.flatnonzero((sc != dc) & (sc < 4) & (dc < 4))
            for k in diff:
                dpos = d0 + k if strand == 1 else d0 + L - 1 - k
                out.append((sname, int(s0 + k), chr(_BASE_OF[sc[k]]),
                            dname, int(dpos), chr(_BASE_OF[dc[k]])))
        return out

    def summarize_mutations(self) -> list[dict]:
        """Per-branch mutation summary (halSummarizeMutations /
        halBranchMutations analog): substitutions over aligned bases,
        insertion segments/bp (child bases with no parent), deletion bp
        (parent bases with no homolog in the child), duplicated parent
        bp (blocks with >1 child copy)."""
        out = []
        for ev in self.genomes():
            par = self.parent(ev)
            if par is None:
                continue
            g = self.toc["genomes"][ev]
            if "top_seq" not in g["arrays"]:
                continue
            tp = np.asarray(self._load(ev, "top_parent"))
            ln = np.asarray(self._load(ev, "top_len"))
            ins_mask = tp < 0
            ins_bp = int(ln[ins_mask].sum())
            ins_ev = int(ins_mask.sum())
            aligned_blocks, counts = np.unique(tp[~ins_mask],
                                               return_counts=True)
            dup_names = set(aligned_blocks[counts > 1].tolist())
            bots = self._bots_by_name(par)
            # deletions: parent blocks absent from this child + fillers
            child_blocks = set(aligned_blocks.tolist())
            del_bp = sum(l for n, (_s, _a, l) in bots.items()
                         if n not in child_blocks)
            gsz = self.toc["genomes"][par]
            bln = np.asarray(self._load(par, "bot_len"))
            bnm = np.asarray(self._load(par, "bot_name"))
            del_bp += int(bln[bnm < 0].sum())      # unaligned ancestral
            dup_bp = int(sum(bots[n][2] for n in dup_names if n in bots))
            subs = len(self.snps(ev, par))
            aligned_bp = int(ln[~ins_mask].sum())
            out.append(dict(genome=ev, parent=par,
                            aligned_bp=aligned_bp, subs=subs,
                            ins_events=ins_ev, ins_bp=ins_bp,
                            del_bp=int(del_bp), dup_parent_bp=dup_bp))
            del gsz
        return out

    def _bottom_index(self, event: str):
        """Per-seq sorted bottoms + block-name → (row) lookup."""
        g = self.toc["genomes"][event]
        if "bot_seq" not in g["arrays"]:
            return None
        si = np.asarray(self._load(event, "bot_seq"))
        st = np.asarray(self._load(event, "bot_start"))
        ln = np.asarray(self._load(event, "bot_len"))
        nm = np.asarray(self._load(event, "bot_name"))
        order = np.lexsort((st, si))
        return si[order], st[order], ln[order], nm[order]

    def _child_index(self, event: str):
        """block name → list of (child event, seq idx, start, len, orient)."""
        idx: dict[int, list] = {}
        for c in self.children(event):
            g = self.toc["genomes"][c]
            if "top_parent" not in g["arrays"]:
                continue
            tp = np.asarray(self._load(c, "top_parent"))
            si = np.asarray(self._load(c, "top_seq"))
            st = np.asarray(self._load(c, "top_start"))
            ln = np.asarray(self._load(c, "top_len"))
            orient = np.asarray(self._load(c, "top_orient"))
            for i in np.flatnonzero(tp >= 0):
                idx.setdefault(int(tp[i]), []).append(
                    (c, int(si[i]), int(st[i]), int(ln[i]),
                     int(orient[i])))
        return idx

    def hal2maf(self, ref_genome: str | None = None,
                ref_seq: str | None = None, ref_start: int = 0,
                ref_end: int | None = None,
                include_ancestor: bool = True) -> list[MafBlock]:
        """MAF referenced on `ref_genome` by walking the stored segment
        hierarchy (top/bottom composition, as the hal library does) —
        independent of any in-memory maps, so it cross-validates the
        ProgressiveResult-based hal2maf.

        Host-side recursive walk: intended for export/validation, not
        the inner loop (genome-scale exports use the vectorized
        phases.hal.hal2maf path).
        """
        if ref_genome is None:
            roots = [e for e, g in self.toc["genomes"].items()
                     if g["parent"] is None]
            ref_genome = roots[0]
        bindex = {ev: self._bottom_index(ev) for ev in self.genomes()}
        cindex = {ev: self._child_index(ev) for ev in self.genomes()
                  if bindex[ev] is not None}
        dna = {ref_genome: self.dna(ref_genome)}
        leaves = [ev for ev in self.genomes() if bindex[ev] is None]
        for lf in leaves:
            dna[lf] = self.dna(lf)
        seq_names = {ev: [n for n, _l in g["sequences"]]
                     for ev, g in self.toc["genomes"].items()}
        seq_lens = {ev: {n: l for n, l in g["sequences"]}
                    for ev, g in self.toc["genomes"].items()}

        def expand(ev, si, start, length, col0, cstrand, out_runs):
            """Map [start,start+length) of ev's sequence si into columns
            [col0, col0+length) (reversed if cstrand=-1); recurse to
            leaves."""
            name = seq_names[ev][si]
            if bindex[ev] is None:      # leaf
                out_runs.append((ev, name, start, length, col0, cstrand))
                return
            b_si, b_st, b_ln, b_nm = bindex[ev]
            lo = np.searchsorted(b_si, si, side="left")
            hi = np.searchsorted(b_si, si, side="right")
            # overlapping bottoms via binary search on start
            j0 = lo + max(0, int(np.searchsorted(
                b_st[lo:hi], start, side="right")) - 1)
            for j in range(j0, hi):
                b0, bl = int(b_st[j]), int(b_ln[j])
                if b0 >= start + length:
                    break
                o0 = max(start, b0)
                o1 = min(start + length, b0 + bl)
                if o1 <= o0 or int(b_nm[j]) < 0:
                    continue
                # columns covered by this overlap
                if cstrand == 1:
                    c0 = col0 + (o0 - start)
                else:
                    c0 = col0 + (start + length - o1)
                for (cev, csi, cst, cln, corient) in \
                        cindex[ev].get(int(b_nm[j]), []):
                    off = o0 - b0
                    n = o1 - o0
                    if corient == 1:
                        cpos = cst + off
                        expand(cev, csi, cpos, n, c0, cstrand, out_runs)
                    else:
                        cpos = cst + (cln - off - n)
                        expand(cev, csi, cpos, n, c0, -cstrand, out_runs)

        r_si, r_st, r_ln, r_nm = bindex[ref_genome]
        ref_names = seq_names[ref_genome]
        out: list[MafBlock] = []
        for j in range(len(r_si)):
            if int(r_nm[j]) < 0:
                continue
            si, astart, L = int(r_si[j]), int(r_st[j]), int(r_ln[j])
            sname = ref_names[si]
            if ref_seq is not None:
                hi_lim = ref_end if ref_end is not None else 1 << 62
                if sname != ref_seq or astart >= hi_lim or \
                        astart + L <= ref_start:
                    continue
            runs: list = []
            for (cev, csi, cst, cln, corient) in \
                    cindex[ref_genome].get(int(r_nm[j]), []):
                if corient == 1:
                    expand(cev, csi, cst, cln, 0, 1, runs)
                else:
                    expand(cev, csi, cst, cln, 0, -1, runs)
            rows = []
            if include_ancestor:
                codes = dna[ref_genome][sname].codes[astart:astart + L]
                rows.append(MafRow(
                    src=sname, start=astart, size=L, strand="+",
                    src_size=seq_lens[ref_genome][sname],
                    text=_BASE_OF[codes].tobytes().decode("ascii")))
            for (ev, name, start, n, c0, cstrand) in runs:
                text = np.full(L, ord("-"), dtype=np.uint8)
                codes = dna[ev][name].codes[start:start + n]
                src_size = seq_lens[ev][name]
                if cstrand == 1:
                    text[c0:c0 + n] = _BASE_OF[codes]
                    rows.append(MafRow(src=name, start=start, size=n,
                                       strand="+", src_size=src_size,
                                       text=text.tobytes()
                                       .decode("ascii")))
                else:
                    text[c0:c0 + n] = _BASE_OF[revcomp(codes)]
                    rows.append(MafRow(src=name,
                                       start=src_size - start - n,
                                       size=n, strand="-",
                                       src_size=src_size,
                                       text=text.tobytes()
                                       .decode("ascii")))
            if len(rows) >= (1 if include_ancestor else 2):
                blk = MafBlock(rows=rows)
                if ref_seq is not None:
                    from .phases.hal import maf_block_trim
                    hi_lim = (ref_end if ref_end is not None
                              else astart + L)
                    blk = maf_block_trim(
                        blk, max(0, ref_start - astart),
                        min(L, hi_lim - astart))
                    if blk is None:
                        continue
                out.append(blk)
        return out


# --------------------------------------------------------------------------
# metadata (halSetMetadata / halStats --metadata equivalents)
# --------------------------------------------------------------------------

def _metadata_set(arc: HalArchive, key: str, value) -> None:
    arc.toc["metadata"][key] = value
    arc._write_toc()


HalArchive.set_metadata = _metadata_set


def _metadata_get(arc: HalArchive, key: str | None = None):
    md = arc.toc.get("metadata", {})
    return md if key is None else md.get(key)


HalArchive.get_metadata = _metadata_get
