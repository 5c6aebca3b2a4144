"""Repeat soft-masking by k-mer frequency (Red / lastzRepeatMask analog).

The reference's default preprocessor masks repeats with Red (k-mer
statistics learner; preprocessor entry `redMasking.py`, config XML :29)
or sampled lastz self-alignment (`cactus_lastzRepeatMask.py`,
proportionToSample=0.2).  The equivalent here: genome-wide k-mer
occurrence counting as one device pass (PyTorch sort + searchsorted on
the card, the same machinery as the seed join), then soft-masking every
position covered by a k-mer whose count exceeds a threshold, with window
dilation to close small gaps (host).  Masked positions are excluded from
SEEDING but remain alignable (soft-mask semantics, as lastz treats
lower-case).
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import Sequence


def kmer_start_mask(codes, k: int, max_count: int, dev):
    """The device part of kmer_counts_mask: a bool tensor on `dev`, True
    at each k-mer start whose k-mer occurs more than max_count times."""
    import torch

    from ..ops.seeds import INVALID_Q, kmer_hashes

    c = torch.as_tensor(np.asarray(codes), device=dev)
    h, _pos = kmer_hashes(c, torch.ones_like(c, dtype=torch.bool), k, 1,
                          device=dev)
    hs = torch.sort(h).values
    left = torch.searchsorted(hs, h, out_int32=True)
    right = torch.searchsorted(hs, h, right=True, out_int32=True)
    del hs
    cnt = torch.where(h == int(INVALID_Q), 0, right - left)
    return cnt > max_count


def kmer_counts_mask(codes: np.ndarray, k: int = 13,
                     max_count: int = 8, dilate: int = 10,
                     device=None) -> np.ndarray:
    """Boolean mask of positions covered by over-represented k-mers.

    The count runs on `device` (None = the current CUDA device)."""
    from ..ops import resolve_device

    n = len(codes)
    if n < k:
        return np.zeros(n, dtype=bool)

    dev = resolve_device(device)
    start_mask = kmer_start_mask(codes, k, max_count, dev).cpu().numpy()
    # cover the whole k-mer span + dilation: difference-array interval
    # stamping (O(#repeat-starts + n), no per-interval python loop)
    starts = np.flatnonzero(start_mask)
    if not len(starts):
        return np.zeros(n, dtype=bool)
    lo = np.maximum(0, starts - dilate)
    hi = np.minimum(n, starts + k + dilate)
    diff = np.zeros(n + 1, dtype=np.int64)
    np.add.at(diff, lo, 1)
    np.add.at(diff, hi, -1)
    return np.cumsum(diff[:-1]) > 0


def mask_genome(genome: dict[str, Sequence], k: int = 13,
                max_count: int = 8, dilate: int = 10,
                min_length: int = 0,
                gc_skew_limit: float = 1.0,
                device=None) -> dict[str, Sequence]:
    """Soft-mask every sequence (mask is additive to existing masking).

    min_length / gc_skew_limit are the redPrefilter options (config XML
    :28 `-m 20000 -b 0.98`, cactus_redPrefilter.c:31-35): contigs
    shorter than min_length, or where one base comprises more than
    gc_skew_limit of the sequence, skip masking (the repeat statistics
    of tiny / low-information contigs are garbage)."""
    out = {}
    for name, s in genome.items():
        if len(s) < max(min_length, k):
            out[name] = s
            continue
        if gc_skew_limit < 1.0 and len(s):
            top = np.bincount(s.codes % 6, minlength=6).max()
            if top > gc_skew_limit * len(s):
                out[name] = s
                continue
        m = kmer_counts_mask(s.codes, k=k, max_count=max_count,
                             dilate=dilate, device=device)
        out[name] = Sequence(name=s.name, codes=s.codes,
                             mask=(s.mask | m), header=s.header)
    return out


def hardmask(seq: Sequence) -> Sequence:
    """softmask2hardmask equivalent: masked bases become N (code 4)."""
    codes = np.where(seq.mask, np.uint8(4), seq.codes)
    return Sequence(name=seq.name, codes=codes,
                    mask=np.zeros(len(codes), bool), header=seq.header)


def unmask_if_overmasked(seq: Sequence, threshold: float = 0.99) -> Sequence:
    """Contig rescue: drop the mask entirely when nearly everything is
    masked (reference: preprocessor/unmasking.py contig unmask/remask,
    config XML :147-158)."""
    if len(seq) and seq.mask.mean() >= threshold:
        return Sequence(name=seq.name, codes=seq.codes,
                        mask=np.zeros(len(seq), bool), header=seq.header)
    return seq
