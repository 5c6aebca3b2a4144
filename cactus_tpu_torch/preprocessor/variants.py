"""Preprocessor variants: sampled self-alignment masking, tandem-repeat
masking, and satellite annotation.

The reference's preprocessor is a config-selected chain
(preprocessor/cactus_preprocessor.py:139-249, config XML :20-43):

 - `lastzRepeatMask` — sampled lastz self-alignment: align a fraction
   (proportionToSample=0.2) of query chunks against the whole genome
   and mask bases whose estimated full-genome alignment depth exceeds
   `period` (lastzRepeatMasking/cactus_lastzRepeatMask.py);
 - `fastan` — FasTAN tandem-repeat masking (config :34);
 - `dna-brnn` — ML annotation of alpha-satellite/HSAT arrays, with
   action softmask/hardmask/clip (preprocessor/dnabrnnMasking.py);
 - chunked processing: every masker runs chunk→process→merge so one
   contig never exceeds worker memory (PreprocessSequence).

Equivalents here: the sampled masker reuses this package's own anchoring
stack (its gap fill runs the banded DP kernels on `device`);
tandem/satellite detection is a vectorized previous-k-mer-occurrence-
distance pass (a tandem array of period p makes every position match its
k-mer p bases earlier, so the distance track is a run of ≈p values — no
RNN needed for the satellite classes the reference cares about, which
are defined by period).
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import Sequence

_BIG = np.int64(1 << 62)


# --------------------------------------------------------------------------
# sampled self-alignment repeat masking (cactus_lastzRepeatMask.py)
# --------------------------------------------------------------------------

def lastz_repeat_mask(genome: dict[str, Sequence], cfg,
                      proportion: float = 0.2, period: int = 10,
                      sample_chunk: int = 10_000, seed: int = 0,
                      log=lambda m: None,
                      device=None) -> dict[str, Sequence]:
    """Mask bases covered deeper than `period` by self-alignments of a
    sampled query fraction (depth is scaled by 1/proportion to estimate
    the unsampled depth, as the reference's --masking period semantics).
    The self-alignments run on `device` (None = the current CUDA device).
    """
    from ..phases.blast import align_contig_pair
    from ..phases.chunking import chunk_sequence

    rng = np.random.default_rng(seed)
    chunks = []
    for name, s in genome.items():
        chunks.extend(chunk_sequence(name, s, sample_chunk, 0))
    keep = rng.random(len(chunks)) < proportion
    sampled = [c for c, k in zip(chunks, keep) if k]
    if not sampled and chunks:
        sampled = [chunks[0]]
    depth = {name: np.zeros(len(s), np.int32)
             for name, s in genome.items()}
    for c in sampled:
        for tname, ts in genome.items():
            recs = align_contig_pair(
                c.seq, ts, c.name, tname, cfg,
                self_alignment=(c.origin == tname), device=device)
            for r in recs:
                depth[tname][r.tstart:r.tend] += 1
    thresh = max(1, int(round(period * proportion)))
    out = {}
    masked_bp = 0
    for name, s in genome.items():
        m = depth[name] > thresh
        masked_bp += int(m.sum())
        out[name] = Sequence(name=s.name, codes=s.codes,
                             mask=s.mask | m, header=s.header)
    log(f"lastz-sampled mask: {len(sampled)}/{len(chunks)} chunks, "
        f"{masked_bp} bp masked (depth > {thresh})")
    return out


# --------------------------------------------------------------------------
# previous-occurrence distance track (shared by tandem + satellite)
# --------------------------------------------------------------------------

def prev_kmer_distance(codes: np.ndarray, k: int = 12) -> np.ndarray:
    """dist[i] = distance to the previous occurrence of the k-mer at i
    (BIG where none / k-mer contains N).  One sort, no Python loops."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.full(max(0, len(codes)), _BIG)
    v = np.zeros(n, np.int64)
    ok = np.ones(n, bool)
    for j in range(k):
        c = codes[j:n + j]
        v = (v << 2) | (c & 3).astype(np.int64)
        ok &= c < 4
    # invalid k-mers get unique sentinel keys so they never match
    v = np.where(ok, v, _BIG - np.arange(n))
    order = np.argsort(v, kind="stable")   # pos ascending within a k-mer
    vs = v[order]
    dist = np.full(len(codes), _BIG)
    same = vs[1:] == vs[:-1]
    idx = order[1:][same]
    dist[idx] = idx - order[:-1][same]
    return dist


def _runs(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of True runs."""
    d = np.diff(mask.astype(np.int8), prepend=0, append=0)
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def tandem_mask(codes: np.ndarray, k: int = 12, max_period: int = 2000,
                min_length: int = 24, dilate: int = 5) -> np.ndarray:
    """FasTAN-equivalent tandem-repeat mask.

    A perfect tandem of period p matches its own k-mers at distance p,
    so positions inside the array (from the second copy on) carry a
    small previous-occurrence distance.  Mask runs of small-distance
    positions that are at least as long as their own period (≥2 copies)
    and ≥ min_length.
    """
    dist = prev_kmer_distance(codes, k)
    small = dist <= max_period
    starts, ends = _runs(small)
    n = len(codes)
    diff = np.zeros(n + 1, np.int64)
    for a, b in zip(starts, ends):
        run_len = b - a
        p = int(np.median(dist[a:b]))
        if run_len + k < max(min_length, p):
            continue
        lo = max(0, a - p - dilate)     # cover the first copy too
        hi = min(n, b + k + dilate)
        diff[lo] += 1
        diff[hi] -= 1
    return np.cumsum(diff[:-1]) > 0


def tandem_mask_genome(genome: dict[str, Sequence], **kw
                       ) -> dict[str, Sequence]:
    out = {}
    for name, s in genome.items():
        m = tandem_mask(s.codes, **kw)
        out[name] = Sequence(name=s.name, codes=s.codes,
                             mask=s.mask | m, header=s.header)
    return out


# --------------------------------------------------------------------------
# satellite annotation (dna-brnn analog)
# --------------------------------------------------------------------------

SATELLITE_CLASSES = {
    # label: (period lo, period hi, min array length)
    "alphoid": (150, 200, 1000),     # alpha satellite, ~171 bp monomer
    "hsat": (2, 12, 500),            # HSAT2/3-like short-period arrays
}


def satellite_bed(genome: dict[str, Sequence], k: int = 12,
                  classes: dict | None = None
                  ) -> list[tuple[str, int, int, str]]:
    """Annotate satellite arrays by repeat period → BED rows
    (name, start, end, label).  The dna-brnn replacement: the reference
    runs an RNN trained on alpha/HSAT classes (dnabrnnMasking.py,
    attcc-alpha.knm); those classes are period-defined, so a period
    detector covers them without a model file.
    """
    classes = classes or SATELLITE_CLASSES
    bed: list[tuple[str, int, int, str]] = []
    for name, s in genome.items():
        if len(s) < 2 * k:
            continue
        dist = prev_kmer_distance(s.codes, k)
        for label, (lo, hi, min_len) in classes.items():
            sel = (dist >= lo) & (dist <= hi)
            # close gaps up to one period before extracting runs
            starts, ends = _runs(sel)
            if not len(starts):
                continue
            merged: list[list[int]] = []
            for a, b in zip(starts, ends):
                if merged and a - merged[-1][1] <= hi:
                    merged[-1][1] = b
                else:
                    merged.append([a, int(b)])
            for a, b in merged:
                period = int(np.median(dist[a:b][sel[a:b]]))
                a0 = max(0, a - period)          # first copy
                if (b + k) - a0 >= min_len:
                    bed.append((name, a0, min(len(s), b + k), label))
    bed.sort()
    return bed


def apply_bed(genome: dict[str, Sequence],
              bed: list[tuple[str, int, int, str]],
              action: str = "softmask") -> dict[str, Sequence]:
    """Apply annotated intervals: softmask / hardmask / clip
    (dnabrnnMasking.py action semantics; clip splits the contig and
    drops the interval, renaming fragments `name:start-end`)."""
    by_name: dict[str, list[tuple[int, int]]] = {}
    for name, a, b, _label in bed:
        by_name.setdefault(name, []).append((a, b))
    out: dict[str, Sequence] = {}
    for name, s in genome.items():
        ivs = sorted(by_name.get(name, []))
        if not ivs:
            out[name] = s
            continue
        if action in ("softmask", "hardmask"):
            m = s.mask.copy()
            codes = s.codes.copy()
            for a, b in ivs:
                if action == "softmask":
                    m[a:b] = True
                else:
                    codes[a:b] = 4
            out[name] = Sequence(name=s.name, codes=codes, mask=m,
                                 header=s.header)
        elif action == "clip":
            pos = 0
            for a, b in ivs:
                if a > pos:
                    frag = f"{name}:{pos}-{a}"
                    out[frag] = Sequence(frag, s.codes[pos:a],
                                         mask=s.mask[pos:a])
                pos = max(pos, b)
            if pos < len(s):
                frag = f"{name}:{pos}-{len(s)}"
                out[frag] = Sequence(frag, s.codes[pos:],
                                     mask=s.mask[pos:])
        else:
            raise ValueError(f"unknown action {action!r}")
    return out


# --------------------------------------------------------------------------
# chunked preprocessing (PreprocessSequence chunk→process→merge)
# --------------------------------------------------------------------------

def preprocess_chunked(genome: dict[str, Sequence], masker,
                       chunk_size: int = 3_000_000,
                       overlap: int = 10_000) -> dict[str, Sequence]:
    """Run a per-genome masker in bounded-memory chunks and merge the
    masks back (overlapping chunk masks OR together), so a chromosome
    never has to fit the masker's working set at once."""
    out: dict[str, Sequence] = {}
    for name, s in genome.items():
        if len(s) <= chunk_size:
            out.update(masker({name: s}))
            continue
        mask = s.mask.copy()
        pos = 0
        while pos < len(s):
            hi = min(len(s), pos + chunk_size)
            sub = Sequence(name, s.codes[pos:hi], mask=s.mask[pos:hi])
            m = masker({name: sub})[name].mask
            mask[pos:hi] |= m
            if hi == len(s):
                break
            pos = hi - overlap
        out[name] = Sequence(name=s.name, codes=s.codes, mask=mask,
                             header=s.header)
    return out
