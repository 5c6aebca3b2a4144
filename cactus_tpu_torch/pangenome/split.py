"""Reference-chromosome contig splitting (rgfa-split / graphmap-split
analog).

The reference pipeline maps every assembly to the SV graph, then
rgfa-split assigns each contig to a reference chromosome by PAF coverage
before per-chromosome alignment batches
(refmap/cactus_graphmap_split.py:346; minQueryCoverages="0.75 0.5 0.25"
bins with ambiguous contigs routed to `_AMBIGUOUS_`, config XML
:463-473).  Here the mapping steps ride the chunked blast path against
the reference event directly, and coverage is computed from the PAF
query side, with the gap fill on the caller's device.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..io.fasta import Sequence

AMBIGUOUS = "_AMBIGUOUS_"


def contig_coverage(records, contig_lengths: dict[str, int]
                    ) -> dict[str, dict[str, int]]:
    """Covered query bases per (contig, target chromosome), overlap-safe:
    intervals per target are merged before counting."""
    from ..utils.intervals import merge_intervals
    ivs: dict[tuple[str, str], list[tuple[int, int]]] = {}
    for r in records:
        if r.qname in contig_lengths:
            ivs.setdefault((r.qname, r.tname), []).append(
                (r.qstart, r.qend))
    out: dict[str, dict[str, int]] = {}
    for (qname, tname), pairs in ivs.items():
        s, e = merge_intervals(np.asarray(pairs, dtype=np.int64))
        out.setdefault(qname, {})[tname] = int((e - s).sum())
    return out


def assign_contigs(coverage: dict[str, dict[str, int]],
                   contig_lengths: dict[str, int],
                   chrom_of_ref_seq: dict[str, str],
                   coverage_bins=(0.75, 0.5, 0.25),
                   min_uniqueness: float = 2.0) -> dict[str, str]:
    """Assign each contig to the chromosome covering the most of it.

    Bins relax in order (rgfa-split minQueryCoverages): a contig is
    assigned at the first bin its best-chromosome coverage fraction
    reaches, provided the best chromosome covers ≥ min_uniqueness× the
    runner-up; otherwise `_AMBIGUOUS_`.
    """
    out: dict[str, str] = {}
    for qname, n in contig_lengths.items():
        per_chrom: dict[str, int] = {}
        for tname, cov in coverage.get(qname, {}).items():
            chrom = chrom_of_ref_seq.get(tname)
            if chrom is not None:
                per_chrom[chrom] = per_chrom.get(chrom, 0) + cov
        if not per_chrom:
            out[qname] = AMBIGUOUS
            continue
        ranked = sorted(per_chrom.items(), key=lambda kv: -kv[1])
        best_chrom, best = ranked[0]
        second = ranked[1][1] if len(ranked) > 1 else 0
        frac = best / max(n, 1)
        ok_bin = any(frac >= b for b in coverage_bins)
        ok_unique = second == 0 or best >= min_uniqueness * second
        out[qname] = best_chrom if (ok_bin and ok_unique) else AMBIGUOUS
    return out


def split_by_chromosome(genomes: dict[str, dict[str, Sequence]],
                        ref_event: str,
                        config: Config | None = None,
                        log=lambda m: None, device=None):
    """Map every non-reference contig to the reference and partition the
    input into per-chromosome sub-pangenome problems.

    Each reference sequence is its own chromosome.  Returns
    (per_chrom: {chrom: {event: {seqname: Sequence}}},
     assignment: {contig: chrom}) where chrom == AMBIGUOUS collects
    unplaced contigs.  The mapping's gap fill runs on `device` (None =
    the current CUDA device).
    """
    from ..phases.chunking import align_genomes_chunked

    config = config or Config.default()
    ref_genome = genomes[ref_event]
    chrom_of_ref_seq = {name: name for name in ref_genome}

    assignment: dict[str, str] = {}
    for ev, genome in genomes.items():
        if ev == ref_event:
            continue
        records = align_genomes_chunked(genome, ref_genome, config.blast,
                                        preset="one", device=device)
        lens = {n: len(s) for n, s in genome.items()}
        cov = contig_coverage(records, lens)
        assignment.update(assign_contigs(cov, lens, chrom_of_ref_seq))
        n_amb = sum(1 for n in lens if assignment[n] == AMBIGUOUS)
        log(f"graphmap-split: {ev}: {len(lens) - n_amb}/{len(lens)} "
            "contigs placed")

    per_chrom: dict[str, dict[str, dict[str, Sequence]]] = {}
    for chrom, rseq in ref_genome.items():
        per_chrom.setdefault(chrom, {}).setdefault(
            ref_event, {})[chrom] = rseq
    for ev, genome in genomes.items():
        if ev == ref_event:
            continue
        for name, seq in genome.items():
            chrom = assignment.get(name, AMBIGUOUS)
            per_chrom.setdefault(chrom, {}).setdefault(ev, {})[name] = seq
    return per_chrom, assignment
