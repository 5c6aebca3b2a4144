"""Sequence chunking + PAF coordinate rebasing (faffy/paffy analog).

Reference semantics: `faffy chunk` splits FASTAs into chunkSize pieces
with overlapSize overlap (30 Mb / 10 kb, config XML :90-92) so the
pairwise grid stays bounded; `paffy dechunk` rebases the resulting PAF
coordinates into the original sequences (src/cactus/paf/
local_alignment.py:370-408, 336-367).  On TPU the same bounds keep the
seed-join and DP buffers at fixed device-friendly shapes; chunks are the
unit sharded over the mesh (parallel/mesh.py).

Duplicate suppression: an alignment is kept only if its query start
falls inside its chunk's CORE region (the chunk minus the leading
overlap), so overlap zones produce each alignment exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import Sequence
from ..io.paf import PafRecord


@dataclass
class Chunk:
    name: str          # chunk sequence name (globally unique)
    origin: str        # original sequence name
    offset: int        # start of the chunk in the original
    core_start: int    # dedup boundary: keep alignments starting here+
    seq: Sequence


def chunk_sequence(name: str, seq: Sequence, chunk_size: int,
                   overlap: int) -> list[Chunk]:
    n = len(seq)
    if n <= chunk_size:
        return [Chunk(name=name, origin=name, offset=0, core_start=0,
                      seq=seq)]
    chunks = []
    step = chunk_size - overlap
    k = 0
    for start in range(0, n, step):
        end = min(n, start + chunk_size)
        cname = f"{name}__chunk{k}"
        sub = Sequence(name=cname, codes=seq.codes[start:end],
                       mask=seq.mask[start:end] if seq.mask is not None
                       else None)
        chunks.append(Chunk(name=cname, origin=name, offset=start,
                            core_start=0 if k == 0 else overlap,
                            seq=sub))
        k += 1
        if end >= n:
            break
    return chunks


def chunk_genome(genome: dict[str, Sequence], chunk_size: int,
                 overlap: int) -> list[Chunk]:
    out = []
    for name, seq in genome.items():
        out.extend(chunk_sequence(name, seq, chunk_size, overlap))
    return out


def dechunk_records(records: list[PafRecord],
                    chunks: dict[str, Chunk]) -> list[PafRecord]:
    """Rebase chunk-space PAF records to original coordinates.

    Overlap-zone duplicates are NOT filtered here: a record that starts
    inside the leading overlap may be the only copy of the rest of its
    chunk's alignment, so whole-record dedup loses coverage.  Downstream
    consumers dedup safely — the pinch-column CC collapses identical
    base pairs, and mark_primaries demotes redundant records.
    """
    out = []
    for r in records:
        qc = chunks.get(r.qname)
        tc = chunks.get(r.tname)
        if qc is not None:
            r.qname = qc.origin
            r.qstart += qc.offset
            r.qend += qc.offset
        if tc is not None:
            r.tname = tc.origin
            r.tstart += tc.offset
            r.tend += tc.offset
        out.append(r)
    return out


def fix_lengths(records: list[PafRecord],
                lengths: dict[str, int]) -> list[PafRecord]:
    """Set qlen/tlen to the original sequence lengths after rebasing.

    Must run before strand math: '-' records' query coordinates are
    forward-strand already in our PafRecord convention.
    """
    for r in records:
        if r.qname in lengths:
            r.qlen = lengths[r.qname]
        if r.tname in lengths:
            r.tlen = lengths[r.tname]
    return records


SPACER = 100  # Ns between packed contigs (kills seeds across the joint)


def pack_small_contigs(genome: dict[str, Sequence],
                       small_threshold: int = 50_000,
                       pack_name: str = "__packed__"
                       ) -> tuple[dict[str, Sequence], dict]:
    """Concatenate small contigs into N-spaced super-contigs.

    Fragmented genomes (reconstructed ancestors especially) otherwise
    explode the all-pairs contig grid; faffy chunk packs many contigs
    into one chunk file the same way.  Returns (new genome, mapping)
    where mapping[pack_seq_name] = [(origin, offset, length), ...].
    """
    big = {n: s for n, s in genome.items() if len(s) >= small_threshold}
    small = [(n, s) for n, s in genome.items() if len(s) < small_threshold]
    if len(small) <= 4:
        return dict(genome), {}
    event = next(iter(genome)).split(".", 1)[0]
    parts = []
    table = []
    pos = 0
    for n, s in small:
        if parts:
            parts.append(np.full(SPACER, 4, dtype=np.uint8))
            pos += SPACER
        table.append((n, pos, len(s)))
        parts.append(s.codes)
        pos += len(s)
    name = f"{event}.{pack_name}"
    out = dict(big)
    out[name] = Sequence(name, np.concatenate(parts))
    return out, {name: table}


def split_packed_records(records: list[PafRecord],
                         mapping: dict) -> list[PafRecord]:
    """Rebase records on packed super-contigs back to their origins.

    Records crossing a contig boundary (possible only when chaining
    bridged an N spacer) are dropped — they carry no usable signal.
    """
    if not mapping:
        return records
    out = []
    for r in records:
        ok = True
        for side in ("q", "t"):
            name = getattr(r, side + "name")
            table = mapping.get(name)
            if table is None:
                continue
            start = getattr(r, side + "start")
            end = getattr(r, side + "end")
            hit = None
            for origin, off, ln in table:
                if off <= start and end <= off + ln:
                    hit = (origin, off, ln)
                    break
            if hit is None:
                ok = False
                break
            origin, off, ln = hit
            setattr(r, side + "name", origin)
            setattr(r, side + "start", start - off)
            setattr(r, side + "end", end - off)
            setattr(r, side + "len", ln)
        if ok:
            out.append(r)
    return out


def align_genomes_chunked(q_genome: dict[str, Sequence],
                          t_genome: dict[str, Sequence],
                          cfg, preset: str = "default",
                          chunk_size: int | None = None,
                          overlap: int | None = None,
                          device=None) -> list[PafRecord]:
    """Chunked all-pairs anchoring between two genomes → rebased PAF.

    Sequence names must already carry their event prefixes.  The gap
    fill runs on `device` (None = the current CUDA device).
    """
    from . import blast
    chunk_size = chunk_size or cfg.chunk_size
    overlap = overlap if overlap is not None else cfg.overlap_size
    qchunks = chunk_genome(q_genome, chunk_size, overlap)
    tchunks = chunk_genome(t_genome, chunk_size, overlap)
    by_name = {c.name: c for c in qchunks + tchunks}
    records = []
    for qc in qchunks:
        if len(qc.seq) < cfg.minimum_sequence_length:
            continue
        for tc in tchunks:
            if len(tc.seq) < cfg.minimum_sequence_length:
                continue
            records.extend(blast.align_contig_pair(
                qc.seq, tc.seq, qc.name, tc.name, cfg, preset,
                device=device))
    records = dechunk_records(records, by_name)
    lengths = {n: len(s) for n, s in list(q_genome.items())
               + list(t_genome.items())}
    records = fix_lengths(records, lengths)
    return records


def uncovered_subsequences(genome: dict[str, Sequence],
                           records: list[PafRecord],
                           min_size: int = 100, flank: int = 100
                           ) -> tuple[dict[str, Sequence], dict[str, "Chunk"]]:
    """Extract the parts of `genome` no record covers — the
    `paffy to_bed --excludeAligned --minSize` + `faffy extract --flank`
    step of the ingroup→outgroup trim cascade
    (paf/local_alignment.py:460-496).

    Uncovered intervals ≥ min_size (before flanking) are extended by
    `flank` and clipped; returns (subsequence genome, rebase map usable
    with dechunk_records).
    """
    from ..utils.intervals import complement_intervals, merge_intervals
    ivs: dict[str, list[tuple[int, int]]] = {}
    for r in records:
        for name, a, b in ((r.qname, r.qstart, r.qend),
                           (r.tname, r.tstart, r.tend)):
            if name in genome:
                ivs.setdefault(name, []).append((a, b))
    subs: dict[str, Sequence] = {}
    rebase: dict[str, Chunk] = {}
    for name, seq in genome.items():
        n = len(seq)
        s, e = merge_intervals(np.asarray(ivs.get(name, []),
                                          dtype=np.int64).reshape(-1, 2))
        gs, ge = complement_intervals(s, e, 0, n)
        keep = ge - gs >= min_size
        gs, ge = gs[keep], ge[keep]
        # flank, then re-merge overlaps created by flanking
        gs, ge = merge_intervals(np.stack(
            [np.maximum(gs - flank, 0), np.minimum(ge + flank, n)], axis=1))
        for k, (a, b) in enumerate(zip(gs, ge)):
            a, b = int(a), int(b)
            if a == 0 and b == n:
                subs[name] = seq
                continue
            sub_name = f"{name}__sub{k}_{a}"
            subs[sub_name] = Sequence(
                name=sub_name, codes=seq.codes[a:b],
                mask=seq.mask[a:b] if seq.mask is not None else None)
            rebase[sub_name] = Chunk(name=sub_name, origin=name, offset=a,
                                     core_start=0, seq=subs[sub_name])
    return subs, rebase
