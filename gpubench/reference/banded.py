"""Plain NumPy reference of the banded global affine alignment.

The semantics the banded engine (`align_pairs_banded`) owes its callers,
written again here without any code of the program: each pair (q, t)
aligns globally inside a band of `band` diagonals [lo, lo + band) placed
on the pair's diagonal range; a 3-matrix (H match, I gap in the target =
query consumed, D gap in the query = target consumed) affine recurrence
with a first gap base costing open + extend; the end score is the first
best of (H, I, D) at (m, n); the CIGAR is walked back from there through
each cell's direction bits, and a walk that leaves the band gives the
pure-indel fallback (score NEG, ops I m then D n).  Ties break as the
port's contract breaks them (cactus_tpu_torch/ops/banded.py
`banded_align_batch` and `traceback_band`): H's source is H when H >= I,
then D when D > max(H, I); an I cell is fresh when H - open >= I; a D
cell is fresh when it equals the left H - open - extend.

`dtype` is the integer type of the scores: int32 is the configuration's
precision; int16 is the control (the nearest precision below), whose
sums wrap.
"""

from __future__ import annotations

import numpy as np

NEG32 = -(1 << 28)
NEG16 = -(1 << 14)
PAD = 5


def neg_of(dtype) -> int:
    return NEG16 if np.dtype(dtype) == np.int16 else NEG32


def band_offset(m: int, n: int, band: int) -> int:
    """lo: the band [lo, lo + band) centred on the diagonals [min(0, n - m),
    max(0, n - m)], holding j = 0 at i = 0 and j = n at i = m."""
    dmin, dmax = min(0, n - m), max(0, n - m)
    lo = dmin - (band - (dmax - dmin)) // 2
    lo = min(lo, 0)
    return max(lo, (n - m) - band + 1)


def pack(pairs, band: int):
    """A batch as the DP reads it: q (P, M) and t_shift (P, M + band)
    codes (PAD past each sequence), with t_shift[p, y] = t[y + lo], and
    m, n, lo (P,); M the longest query."""
    P = len(pairs)
    M = max(1, max(len(q) for q, _t in pairs))
    m = np.array([len(q) for q, _t in pairs], np.int64)
    n = np.array([len(t) for _q, t in pairs], np.int64)
    lo = np.array([band_offset(int(a), int(b), band) for a, b in zip(m, n)],
                  np.int64)
    q = np.full((P, M), PAD, np.int64)
    ts = np.full((P, M + band), PAD, np.int64)
    for p, (qa, ta) in enumerate(pairs):
        q[p, :len(qa)] = qa
        y0 = max(0, -int(lo[p]))
        src0 = y0 + int(lo[p])
        k = min(len(ta) - src0, M + band - y0)
        if k > 0:
            ts[p, y0:y0 + k] = ta[src0:src0 + k]
    return q, ts, m, n, lo


def _dp(pairs, submat, band, gap_open, gap_extend, dtype):
    """Direction bytes and end states of a batch: (dirs (P, M, B) uint8,
    score (P,), end_mat (P,), lo (P,))."""
    dt = np.dtype(dtype)
    neg = neg_of(dt)
    q, ts, m, n, lo = pack(pairs, band)
    P, M = q.shape
    B = band
    sub = np.asarray(submat).astype(dt)
    go, ge = dt.type(gap_open), dt.type(gap_extend)
    b = np.arange(B, dtype=np.int64)[None, :]
    j0 = lo[:, None] + b
    H = np.where(j0 == 0, 0, neg).astype(dt)
    D = np.where(j0 > 0, -(gap_open + j0 * gap_extend), neg).astype(dt)
    I = np.full((P, B), neg, dt)
    negcol = np.full((P, 1), neg, dt)
    ramp = (gap_extend * b).astype(dt)
    dopen = (gap_open + gap_extend * (b + 1)).astype(dt)
    at0 = (m == 0)[:, None]
    end = [np.where(at0, H, neg).astype(dt), np.full((P, B), neg, dt),
           np.where(at0, D, neg).astype(dt)]
    dirs = np.zeros((P, M, B), np.uint8)
    negs = np.full((P, B), neg, dt)
    with np.errstate(over="ignore"):
        for i in range(1, M + 1):
            s = sub[q[:, i - 1:i], ts[:, i - 1:i - 1 + B]]
            hi = np.maximum(H, I)
            best = np.maximum(hi, D)
            src = np.where(H >= I, 0, 1)
            src = np.where(D > hi, 2, src).astype(np.uint8)
            Hn = (best + s).astype(dt)
            Hu = np.concatenate([H[:, 1:], negcol], axis=1)
            Iu = np.concatenate([I[:, 1:], negcol], axis=1)
            Ho = (Hu - go).astype(dt)
            ifresh = Ho >= Iu
            In = (np.maximum(Ho, Iu) - ge).astype(dt)
            j = i + lo[:, None] + b
            first = np.asarray(-(gap_open + i * gap_extend)).astype(dt)
            In = np.where(j == 0, first, In)
            Hn = np.where(j <= 0, neg, Hn).astype(dt)
            In = np.where(j < 0, neg, In).astype(dt)
            Hl = np.concatenate([negcol, Hn[:, :-1]], axis=1)
            Y = np.maximum.accumulate((Hl + ramp).astype(dt), axis=1)
            Dn = (Y - dopen).astype(dt)
            dfresh = Dn == (Hl - go - ge).astype(dt)
            Dn = np.where(j <= 0, neg, Dn).astype(dt)
            Dn = np.maximum(Dn, negs)
            Hn = np.maximum(Hn, negs)
            In = np.maximum(In, negs)
            dirs[:, i - 1] = (src | (ifresh.astype(np.uint8) << 2)
                              | (dfresh.astype(np.uint8) << 3))
            at = (m == i)[:, None]
            end = [np.where(at, Hn, end[0]), np.where(at, In, end[1]),
                   np.where(at, Dn, end[2])]
            H, I, D = Hn, In, Dn
    b_end = (n - m - lo)[:, None]
    ends = np.stack([np.take_along_axis(e, b_end, 1)[:, 0] for e in end],
                    axis=1)
    end_mat = np.argmax(ends, axis=1)
    score = ends[np.arange(P), end_mat]
    return dirs, score, end_mat, lo


def _walk(dirs, m, n, lo, state):
    """CIGAR ops (forward order) walked back from (m, n) in `state`
    (0 H, 1 I, 2 D); None when the walk leaves the band."""
    B = dirs.shape[1]
    i, j = m, n
    ops = []
    while i > 0 or j > 0:
        if i == 0:
            op = "D"
            j -= 1
        elif j == 0:
            op = "I"
            i -= 1
        else:
            b = j - i - lo
            if not 0 <= b < B:
                return None
            byte = int(dirs[i - 1, b])
            if state == 0:
                op = "M"
                state = byte & 3
                i -= 1
                j -= 1
            elif state == 1:
                op = "I"
                state = 0 if byte & 4 else 1
                i -= 1
            else:
                op = "D"
                state = 0 if byte & 8 else 2
                j -= 1
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return [(op, k) for op, k in reversed(ops)]


def align(pairs, submat, band: int, gap_open: int, gap_extend: int,
          dtype=np.int32):
    """(score, ops) per pair, in the order of `pairs`.  Pairs are run in
    batches of one power-of-two query length (a pair's answer does not
    depend on its batch)."""
    out = [None] * len(pairs)
    groups: dict[int, list[int]] = {}
    for k, (q, _t) in enumerate(pairs):
        groups.setdefault(max(1, len(q) - 1).bit_length(), []).append(k)
    neg = neg_of(dtype)
    for idxs in groups.values():
        batch = [pairs[k] for k in idxs]
        dirs, score, end_mat, lo = _dp(batch, submat, band, gap_open,
                                       gap_extend, dtype)
        for row, k in enumerate(idxs):
            m, n = len(pairs[k][0]), len(pairs[k][1])
            ops = _walk(dirs[row], m, n, int(lo[row]), int(end_mat[row]))
            if ops is None:
                fallback = ([("I", m)] if m else []) + (
                    [("D", n)] if n else [])
                out[k] = (neg, fallback)
            else:
                out[k] = (int(score[row]), ops)
    return out
