"""Resource estimation — the consolidated memory/disk model.

Reference: pipeline/cactus_workflow.py:34-97 reads the
<consolidatedMemory> piecewise-linear table (config XML :571-581) to
size each ancestor job, scales for core count, and budgets disk as
5×sequence + 2×PAF bytes.  The same model here sizes host memory for
an ancestor step (the DP working set lives in HBM and is bounded by
the batch caps, so host RSS tracks sequence + graph size).
"""

from __future__ import annotations

# (total input sequence bytes, memory bytes) — config XML :571-581
_MEMORY_TABLE = [
    (10_000_000, 16 << 30),
    (50_000_000, 64 << 30),
    (1_000_000_000, 128 << 30),
    (4_000_000_000, 256 << 30),
    (10_000_000_000, 512 << 30),
    (15_000_000_000, 1 << 40),
    (20_000_000_000, int(1.99 * (1 << 40))),
]


def estimate_consolidated_memory(seq_bytes: int,
                                 cores: int = 1) -> int:
    """Piecewise-linear interpolation of the reference's memory model,
    with the same smallest-point floor and linear extrapolation past
    the last point; +5%/core beyond one (cactus_workflow.py:83-95)."""
    pts = _MEMORY_TABLE
    if seq_bytes <= pts[0][0]:
        mem = pts[0][1] * max(0.25, seq_bytes / pts[0][0])
    else:
        mem = None
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if seq_bytes <= x1:
                f = (seq_bytes - x0) / (x1 - x0)
                mem = y0 + f * (y1 - y0)
                break
        if mem is None:
            x0, y0 = pts[-2]
            x1, y1 = pts[-1]
            slope = (y1 - y0) / (x1 - x0)
            mem = y1 + slope * (seq_bytes - x1)
    if cores > 1:
        mem *= 1.0 + 0.05 * (cores - 1)
    return int(mem)


def estimate_disk(seq_bytes: int, paf_bytes: int = 0) -> int:
    """disk = 5×sequence + 2×paf (cactus_workflow.py:50)."""
    return 5 * seq_bytes + 2 * paf_bytes
