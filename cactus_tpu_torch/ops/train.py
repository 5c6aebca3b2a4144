"""Alignment-trained scoring (the last-train / last_scoring analog).

The reference can train a pairwise scoring matrix per genome pair with
last-train and rewrite the lastz/abPOA scores from the resulting .train
file (paf/last_scoring.py:23 parse_train_file; applied at
local_alignment.py via lastz --scores).  Native equivalent: estimate
substitution and gap log-odds directly from this package's own PAF
records (cigar M columns and indel events), emit/ingest the same
`#last -a/-b` + matrix-row text format, and apply the result to the
Config's extension and POA scores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BASES = "ACGT"
_RC = {0: 3, 1: 2, 2: 1, 3: 0}


@dataclass
class TrainedScores:
    matrix: np.ndarray        # 4x4 int
    gap_open: int             # positive cost
    gap_extend: int


def train_scores(records, seqs: dict[str, np.ndarray],
                 max_match: int = 91,
                 pseudocount: float = 1.0) -> TrainedScores:
    """Estimate log-odds scores from alignments.

    `seqs` maps sequence name → codes.  Counts are symmetrized over
    (i,j)↔(j,i) and reverse complement (the last-train --matsym
    --revsym constraints the reference requires); the scale is chosen
    so the best diagonal score equals max_match (lastz-comparable
    magnitudes).
    """
    counts = np.full((4, 4), pseudocount, np.float64)
    bg = np.full(4, 2 * pseudocount, np.float64)
    n_open = n_gapbase = n_cols = 0
    for r in records:
        q = seqs.get(r.qname)
        t = seqs.get(r.tname)
        if q is None or t is None:
            continue
        qp, tp = [], []
        for a, b in r.aligned_pairs():
            qp.append(a)
            tp.append(b)
        if not qp:
            continue
        qc = np.asarray(q)[np.asarray(qp, np.int64)]
        if r.strand == "-":
            qc = np.array([_RC.get(int(c), 4) for c in qc], np.uint8)
        tc = np.asarray(t)[np.asarray(tp, np.int64)]
        ok = (qc < 4) & (tc < 4)
        np.add.at(counts, (qc[ok], tc[ok]), 1.0)
        np.add.at(bg, qc[ok], 1.0)
        np.add.at(bg, tc[ok], 1.0)
        n_cols += int(ok.sum())
        for op, ln in r.cigar:
            if op in "ID":
                n_open += 1
                n_gapbase += ln
    # symmetrize: transpose + reverse complement
    counts = counts + counts.T
    rc = np.zeros_like(counts)
    for i in range(4):
        for j in range(4):
            rc[i, j] = counts[_RC[i], _RC[j]]
    counts = (counts + rc) / 2.0
    p = counts / counts.sum()
    f = bg / bg.sum()
    # revcomp-symmetric background (the --revsym constraint): without
    # it strand-biased composition breaks m[i,j] == m[rc j, rc i]
    f = np.array([(f[i] + f[_RC[i]]) / 2.0 for i in range(4)])
    with np.errstate(divide="ignore"):
        lod = np.log(p / np.outer(f, f))
    scale = max_match / max(1e-9, float(lod.max()))
    matrix = np.round(lod * scale).astype(np.int64)
    # gap costs from event frequencies on the same scale
    p_open = (n_open + 1.0) / (n_cols + 2.0)
    p_ext = (n_gapbase - n_open + 1.0) / (n_gapbase + 2.0)
    gap_open = int(round(-np.log(p_open) * scale))
    gap_extend = max(1, int(round(-np.log(p_ext) * scale)))
    return TrainedScores(matrix=matrix, gap_open=gap_open,
                         gap_extend=gap_extend)


def write_train_file(path_or_file, ts: TrainedScores) -> None:
    """The last-train text format the reference parses
    (last_scoring.py:23-72): `#last -a/-b` gap lines + matrix rows."""
    own = not hasattr(path_or_file, "write")
    fh = open(path_or_file, "w") if own else path_or_file
    try:
        fh.write(f"#last -a {ts.gap_open}\n")
        fh.write(f"#last -b {ts.gap_extend}\n")
        fh.write("# score matrix (query letters = rows, "
                 "reference letters = columns):\n")
        fh.write("\t" + "\t".join(_BASES) + "\n")
        for i, b in enumerate(_BASES):
            fh.write(b + "\t" + "\t".join(
                str(int(ts.matrix[i, j])) for j in range(4)) + "\n")
    finally:
        if own:
            fh.close()


def parse_train_file(path_or_file) -> TrainedScores:
    """Read a .train file; enforces the symmetric / revcomp-symmetric
    constraints exactly as the reference does (last_scoring.py:23-72)."""
    own = not hasattr(path_or_file, "read")
    fh = open(path_or_file) if own else path_or_file
    try:
        gap_open = gap_extend = None
        rows: dict[str, list[int]] = {}
        for line in fh:
            if line.startswith("#last -a") or line.startswith("#last -A"):
                v = int(line.split()[-1])
                if gap_open is not None and gap_open != v:
                    raise ValueError("asymmetric gap open")
                gap_open = v
            elif line.startswith("#last -b") or \
                    line.startswith("#last -B"):
                v = int(line.split()[-1])
                if gap_extend is not None and gap_extend != v:
                    raise ValueError("asymmetric gap extend")
                gap_extend = v
            elif line and line[0] in _BASES:
                toks = line.split()
                if len(toks) == 5:
                    rows[toks[0]] = [int(x) for x in toks[1:]]
        if gap_open is None or gap_extend is None or len(rows) != 4:
            raise ValueError("incomplete .train file")
        m = np.array([rows[b] for b in _BASES], np.int64)
        if not np.array_equal(m, m.T):
            raise ValueError("asymmetric score matrix: use --matsym")
        for i in range(4):
            for j in range(4):
                if m[i, j] != m[_RC[i], _RC[j]]:
                    raise ValueError("revcomp asymmetry: use --revsym")
        return TrainedScores(matrix=m, gap_open=gap_open,
                             gap_extend=gap_extend)
    finally:
        if own:
            fh.close()


def apply_scores(config, ts: TrainedScores):
    """New Config with the trained scores installed in the extension
    and POA stages (the reference rewrites lastz --scores and the abPOA
    matrix from the train file)."""
    import copy
    cfg = copy.deepcopy(config)
    cfg.blast.extend.match = int(ts.matrix.diagonal().max())
    off = ~np.eye(4, dtype=bool)
    cfg.blast.extend.mismatch = int(ts.matrix[off].mean())
    cfg.blast.extend.gap_open = ts.gap_open
    cfg.blast.extend.gap_extend = ts.gap_extend
    poa = getattr(getattr(cfg, "bar", None), "poa", None)
    if poa is not None:
        sub = list(poa.sub_matrix)
        for i in range(4):
            for j in range(4):
                sub[i * 5 + j] = int(ts.matrix[i, j])
        poa.sub_matrix = tuple(sub)
    return cfg
