"""Assembly statistics (cactus_analyseAssembly equivalent).

Reference: preprocessor/cactus_analyseAssembly.c:76 prints per-assembly
totals, N50, masking proportion, contig counts — used by the progressive
driver to size resources and sanity-check inputs.
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import Sequence


def assembly_stats(genome: dict[str, Sequence]) -> dict:
    lengths = sorted((len(s) for s in genome.values()), reverse=True)
    total = int(sum(lengths))
    n50 = 0
    acc = 0
    for L in lengths:
        acc += L
        if acc * 2 >= total:
            n50 = int(L)
            break
    n_masked = int(sum(int(s.mask.sum()) for s in genome.values()))
    n_n = int(sum(int((s.codes >= 4).sum()) for s in genome.values()))
    return dict(
        n_sequences=len(lengths),
        total_length=total,
        min_length=int(lengths[-1]) if lengths else 0,
        max_length=int(lengths[0]) if lengths else 0,
        n50=n50,
        masked_bases=n_masked,
        masked_fraction=(n_masked / total) if total else 0.0,
        n_bases=n_n,
    )
