"""Batched banded affine-gap pairwise alignment (PyTorch port).

The DP workhorse replacing the inner loops of lastz gapped extension and
cPecan's banded aligner (reference: submodules lastz, cPecan
pairwiseAligner.h; banding params at cactus_progressive_config.xml:276-280).

Row-wise banded DP in diagonal-band coordinates, batched over pairs:

 - Each pair p aligns q_p (len M_p) vs t_p (len N_p) globally inside a band
   of B diagonals [lo_p, lo_p + B).  The host pre-shifts each target into
   ``t_shift[p, y] = t_p[y + lo_p]``, so row i reads the contiguous slice
   ``t_shift[:, i-1 : i-1+B]``.
 - Affine gaps via the 3-matrix recurrence; the intra-row D chain (gap
   consuming target) is an inclusive max-scan along the band.
 - Direction bits are emitted per cell for traceback (bit0-1: H
   predecessor in {H,I,D}; bit2: I opened fresh; bit3: D opened fresh).
   Scores/end state are captured at each pair's true endpoint (M_p, N_p).

`banded_align_batch` here is the plain PyTorch version of the contract
(cactus_tpu/ops/banded.py::banded_align_batch), bit-identical to it; the
hand-written CUDA kernel is ops/banded_cuda.py::banded_dp, which
`align_pairs_banded` launches for every batch on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..trace import span
from . import resolve_device

NEG = -(1 << 28)  # -inf substitute, safe against int32 accumulation
PAD_Q = 5         # query pad code
PAD_T = 5         # target pad code


def score_matrix_6(sub_matrix_5x5, pad_score: int = -1000) -> np.ndarray:
    """Extend the 5x5 ACGTN matrix (config XML :312-318) with a pad code."""
    m = np.full((6, 6), pad_score, dtype=np.int32)
    m[:5, :5] = np.asarray(sub_matrix_5x5, dtype=np.int32).reshape(5, 5)
    return m


@dataclass(frozen=True)
class GapParams:
    gap_open: int = 400    # first gap base costs open+extend
    gap_extend: int = 30


def pack_band_batch(pairs, band: int, submat: np.ndarray | None = None,
                    min_batch: int = 8, min_rows: int = 32):
    """Pack a list of (q_codes, t_codes) into uniform banded-batch arrays.

    Returns dict of arrays: q (P, Mmax) uint8, t_shift (P, Mmax+band) uint8,
    m_len, n_len, lo (P,) int32.  Band offset lo_p is chosen to center the
    [0, N-M] diagonal range; caller must bin pairs so that
    |N_p - M_p| + slack <= band.  min_batch/min_rows floor the pow2
    quantization of P and Mmax.
    """
    P = max(min_batch, 1 << (len(pairs) - 1).bit_length())
    Mmax = max(len(q) for q, _ in pairs)
    Mmax = max(min_rows, 32, 1 << (Mmax - 1).bit_length())
    q_arr = np.full((P, Mmax), PAD_Q, dtype=np.uint8)
    t_arr = np.full((P, Mmax + band), PAD_T, dtype=np.uint8)
    m_len = np.zeros(P, dtype=np.int32)
    n_len = np.zeros(P, dtype=np.int32)
    lo = np.zeros(P, dtype=np.int32)
    for p, (q, t) in enumerate(pairs):
        M, N = len(q), len(t)
        if abs(N - M) >= band:
            raise ValueError(f"pair {p}: diag span {N - M} exceeds band {band}")
        # center band on the [min(0,N-M), max(0,N-M)] diagonal range
        dmin, dmax = min(0, N - M), max(0, N - M)
        lo_p = dmin - (band - (dmax - dmin)) // 2
        # j = i + lo_p + b must reach j=0 at i=0 (lo_p <= 0) and j=N at i=M
        lo_p = min(lo_p, 0)
        lo_p = max(lo_p, (N - M) - band + 1)
        q_arr[p, :M] = q
        m_len[p] = M
        n_len[p] = N
        lo[p] = lo_p
        # t_shift[y] = t[y + lo_p]
        y0 = max(0, -lo_p)           # first y with valid t index
        src0 = y0 + lo_p             # = max(lo_p, 0)
        n_copy = min(N - src0, Mmax + band - y0)
        if n_copy > 0:
            t_arr[p, y0:y0 + n_copy] = t[src0:src0 + n_copy]
    return dict(q=q_arr, t_shift=t_arr, m_len=m_len, n_len=n_len, lo=lo)


def banded_align_batch(q, t_shift, m_len, n_len, lo, submat,
                       band: int, gap_open: int, gap_extend: int):
    """Batched banded global affine alignment (plain PyTorch, int32).

    q (P, Mmax) uint8, t_shift (P, Mmax+band) uint8, m_len/n_len/lo (P,)
    int, submat (6, 6) int.  Returns (dirs (P, Mmax, band) uint8,
    end_scores (P, 3) int32 [H,I,D at endpoint], end_mat (P,) int32 first
    argmax).  Mirrors cactus_tpu/ops/banded.py:158-254 op for op,
    including the Kogge-Stone order of the D-chain max-scan.
    """
    P, Mmax = q.shape
    B = band
    dev = q.device
    i32 = torch.int32
    submat = submat.to(i32)
    b_idx = torch.arange(B, dtype=i32, device=dev)[None, :]      # (1, B)
    lo_c = lo.to(i32)[:, None]                                   # (P, 1)
    m_c = m_len.to(i32)

    # row 0 carry: j = lo + b at i=0
    j0 = lo_c + b_idx
    H = torch.where(j0 == 0, 0, NEG).to(i32)
    D = torch.where(j0 > 0, -(gap_open + j0 * gap_extend), NEG).to(i32)
    negs = torch.full((P, B), NEG, dtype=i32, device=dev)
    I = negs
    at0 = (m_c == 0)[:, None]
    endH = torch.where(at0, H, negs)
    endI = negs
    endD = torch.where(at0, D, negs)

    ext_ramp = gap_extend * b_idx
    neg_col = torch.full((P, 1), NEG, dtype=i32, device=dev)
    q_l = q.long()
    t_l = t_shift.long()
    dirs = torch.empty((P, Mmax, B), dtype=torch.uint8, device=dev)
    for i in range(1, Mmax + 1):
        qc = q_l[:, i - 1:i]                                     # (P, 1)
        tc = t_l[:, i - 1:i - 1 + B]                             # (P, B)
        s = submat[qc, tc]                                       # (P, B)

        # H: diagonal predecessor is the SAME band index in the previous row
        hi = torch.maximum(H, I)
        prev_best = torch.maximum(hi, D)
        h_src = torch.where(H >= I, 0, 1)
        h_src = torch.where(D > hi, 2, h_src).to(torch.uint8)
        H_new = prev_best + s

        # I (gap consuming query): predecessor band index b+1 in prev row
        H_up = torch.cat([H[:, 1:], neg_col], dim=1)
        I_up = torch.cat([I[:, 1:], neg_col], dim=1)
        i_fresh = (H_up - gap_open) >= I_up
        I_new = torch.maximum(H_up - gap_open, I_up) - gap_extend

        # boundary: j = i + lo + b; j == 0 cells are the left DP boundary
        j = i + lo_c + b_idx
        I_new = torch.where(j == 0, -(gap_open + i * gap_extend), I_new)
        H_new = torch.where(j <= 0, NEG, H_new)
        I_new = torch.where(j < 0, NEG, I_new)

        # D (gap consuming target): intra-row chain via max-scan.
        # D[b] = max_{c<=b} (H_new[c-1] + e*c) - open - e*(b+1)
        Hl = torch.cat([neg_col, H_new[:, :-1]], dim=1)
        Y = Hl + ext_ramp
        off = 1
        while off < B:
            shifted = torch.cat(
                [torch.full((P, off), NEG, dtype=i32, device=dev),
                 Y[:, :-off]], dim=1)
            Y = torch.maximum(Y, shifted)
            off *= 2
        D_new = Y - gap_open - gap_extend * (b_idx + 1)
        d_fresh = D_new == (Hl - gap_open - gap_extend)
        D_new = torch.where(j <= 0, NEG, D_new)
        D_new = torch.clamp_min(D_new, NEG)
        H_new = torch.clamp_min(H_new, NEG)
        I_new = torch.clamp_min(I_new, NEG)

        dirs[:, i - 1] = (h_src
                          | (i_fresh.to(torch.uint8) << 2)
                          | (d_fresh.to(torch.uint8) << 3))

        at_end = (m_c == i)[:, None]
        endH = torch.where(at_end, H_new, endH)
        endI = torch.where(at_end, I_new, endI)
        endD = torch.where(at_end, D_new, endD)
        H, I, D = H_new, I_new, D_new

    b_end = (n_len.long() - m_len.long() - lo.long())[:, None]
    end_scores = torch.stack([endH.gather(1, b_end)[:, 0],
                              endI.gather(1, b_end)[:, 0],
                              endD.gather(1, b_end)[:, 0]], dim=1)
    end_mat = torch.argmax(end_scores, dim=1).to(i32)
    return dirs, end_scores, end_mat


def traceback_band(dirs: np.ndarray, m: int, n: int, lo: int,
                   end_mat: int) -> list[tuple[str, int]]:
    """Host traceback from banded direction bits for one pair.

    dirs is (Mmax, B) uint8 from banded_align_batch; walk from (m, n) back
    to (0, 0).  Returns cigar ops in forward order (M/I/D; I consumes query).
    """
    B = dirs.shape[1]
    i, j, cur = m, n, int(end_mat)
    ops: list[tuple[str, int]] = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    while i > 0 or j > 0:
        if i == 0:
            push("D")
            j -= 1
            continue
        if j == 0:
            push("I")
            i -= 1
            continue
        b = j - i - lo
        if not (0 <= b < B):
            raise RuntimeError(f"traceback left the band at ({i},{j}) b={b}")
        byte = int(dirs[i - 1, b])
        if cur == 0:      # in H: M op, predecessor from bits 0-1
            push("M")
            cur = byte & 3
            i -= 1
            j -= 1
        elif cur == 1:    # in I
            push("I")
            cur = 0 if (byte >> 2) & 1 else 1
            i -= 1
        else:             # in D
            push("D")
            cur = 0 if (byte >> 3) & 1 else 2
            j -= 1
    return ops[::-1]


_OP_CHARS = np.array(["?", "M", "I", "D"])


def moves_to_ops(moves: np.ndarray, count: int) -> list[tuple[str, int]]:
    """Reverse-order move codes → forward cigar ops (host run-length)."""
    mv = moves[:count][::-1]
    if not len(mv):
        return []
    brk = np.flatnonzero(np.diff(mv)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(mv)]])
    return [(str(_OP_CHARS[mv[s]]), int(e - s))
            for s, e in zip(starts, ends)]


# Below this many DP cells a CPU caller runs the native C++ kernel
# (threaded, exact) instead of the plain PyTorch row loop — the same
# routing cactus_tpu applies on a host without an accelerator.  CUDA
# callers never take it: every batch there goes to the CUDA kernel.
NATIVE_MAX_CELLS = 256_000_000


def moves_to_ops_fwd(moves: np.ndarray) -> list[tuple[str, int]]:
    """Forward-order move codes → cigar ops (host run-length encode)."""
    if not len(moves):
        return []
    brk = np.flatnonzero(np.diff(moves)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(moves)]])
    return [(str(_OP_CHARS[moves[s]]), int(e - s))
            for s, e in zip(starts, ends)]


def gap_fallback(qlen: int, tlen: int) -> tuple[int, list]:
    """Unalignable-gap fallback: when the optimal path leaves the band
    (a large balanced insertion+deletion hiding inside one chain gap),
    emit the pure indel pair with a floor score — the caller's
    min_gap_score check then splits the record there, which is the
    lastz ydrop-termination behavior for a non-homologous interval."""
    ops = []
    if qlen:
        ops.append(("I", int(qlen)))
    if tlen:
        ops.append(("D", int(tlen)))
    return NEG, ops


def align_pairs_native(pairs, submat, gap: GapParams, band: int):
    """Native C++ banded batch (bit-identical to banded_align_batch).

    Returns list of (score, cigar_ops) or None if unavailable."""
    from ..native import build as native
    res = native.dp_banded_batch(
        pairs, submat, gap.gap_open, gap.gap_extend,
        np.full(len(pairs), band, np.int32))
    if res is None:
        return None
    scores, moves, moves_off, n_moves = res
    out = []
    for p in range(len(pairs)):
        n = int(n_moves[p])
        if n < 0:
            out.append(gap_fallback(len(pairs[p][0]), len(pairs[p][1])))
            continue
        o = int(moves_off[p])
        out.append((int(scores[p]), moves_to_ops_fwd(moves[o:o + n])))
    return out


def _to_device(packed: dict, n: int, dev) -> dict:
    """The first n pairs of a packed batch as tensors on `dev` (pairs are
    independent, so the pow2 batch padding is dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[:n])).to(dev)
            for k, v in packed.items()}


def _align_pairs_cuda(pairs, submat, gap: GapParams, band: int,
                      max_batch_bytes: int, dev):
    """Every pair through the CUDA kernels: DP, then device traceback.

    Pairs are grouped by pow2 query length so a long pair does not pad a
    batch of short ones (each pair's result is independent of its
    batch), and each group is split so its direction tensor stays under
    max_batch_bytes."""
    from .banded_cuda import banded_dp, banded_traceback, live_width
    bins: dict[int, list[int]] = {}
    for k, (q, _t) in enumerate(pairs):
        rows = max(32, 1 << (max(1, len(q)) - 1).bit_length())
        bins.setdefault(rows, []).append(k)
    sub = torch.from_numpy(np.ascontiguousarray(submat, np.int32)).to(dev)
    out: list = [None] * len(pairs)
    for rows, idxs in sorted(bins.items()):
        max_pairs = max(1, int(max_batch_bytes // (rows * band)))
        for c in range(0, len(idxs), max_pairs):
            chunk = idxs[c:c + max_pairs]
            batch = [pairs[k] for k in chunk]
            with span("cactus.pack"):
                packed = pack_band_batch(batch, band)
                t = _to_device(packed, len(batch), dev)
            # the kernel sizes its blocks by the widest live row, taken
            # here from the host arrays
            live = live_width(packed["n_len"][:len(batch)], band)
            dirs, end_scores, end_mat = banded_dp(
                t["q"], t["t_shift"], t["m_len"], t["n_len"], t["lo"], sub,
                band=band, gap_open=gap.gap_open, gap_extend=gap.gap_extend,
                max_live=live)
            smax = max(len(q) + len(tt) for q, tt in batch)
            S = max(32, 1 << (smax - 1).bit_length())
            moves, counts = banded_traceback(dirs, t["m_len"], t["n_len"],
                                             t["lo"], end_mat, S)
            del dirs
            with span("cactus.fetch"):
                moves = moves.cpu().numpy()
                counts = counts.cpu().numpy()
                end_scores = end_scores.cpu().numpy()
                end_mat = end_mat.cpu().numpy()
            with span("cactus.unpack"):
                for row, k in enumerate(chunk):
                    if counts[row] < 0:
                        # the walk left the band: same fallback as the
                        # host traceback's RuntimeError
                        out[k] = gap_fallback(len(pairs[k][0]),
                                              len(pairs[k][1]))
                    else:
                        out[k] = (int(end_scores[row, end_mat[row]]),
                                  moves_to_ops(moves[row], int(counts[row])))
    return out


def _align_pairs_plain(pairs, submat, gap: GapParams, band: int, backend,
                       max_batch_bytes: int, dev):
    """Every pair through `backend` (banded_align_batch's signature) and
    the host traceback, in batches whose dirs tensor (P x Mmax x band
    bytes) stays under max_batch_bytes: a single bin of long, wide-band
    pairs could otherwise demand >100 GB."""
    max_m = max(len(q) for q, _t in pairs)
    est_m = max(32, 1 << (max_m - 1).bit_length())
    max_pairs = max(1, int(max_batch_bytes // (est_m * band)))
    sub = torch.from_numpy(np.ascontiguousarray(submat, np.int32)).to(dev)
    out = []
    for c in range(0, len(pairs), max_pairs):
        batch = pairs[c:c + max_pairs]
        with span("cactus.pack"):
            packed = pack_band_batch(batch, band)
            t = _to_device(packed, len(packed["q"]), dev)
        dirs, end_scores, end_mat = backend(
            t["q"], t["t_shift"], t["m_len"], t["n_len"], t["lo"], sub,
            band=band, gap_open=gap.gap_open, gap_extend=gap.gap_extend)
        with span("cactus.fetch"):
            dirs = dirs.cpu().numpy()
            end_scores = end_scores.cpu().numpy()
            end_mat = end_mat.cpu().numpy()
        with span("cactus.unpack"):
            for p in range(len(batch)):
                m, n = int(packed["m_len"][p]), int(packed["n_len"][p])
                score = int(end_scores[p, end_mat[p]])
                try:
                    ops = traceback_band(dirs[p], m, n, int(packed["lo"][p]),
                                         int(end_mat[p]))
                except RuntimeError:
                    out.append(gap_fallback(m, n))
                    continue
                out.append((score, ops))
    return out


def align_pairs_banded(pairs, submat, gap: GapParams, band: int = 128,
                       backend=None,
                       max_batch_bytes: int = 512 << 20, device=None):
    """Pack, run the batched DP, trace back.

    Returns list of (score, cigar_ops) matching `pairs` order.  On a CUDA
    device every batch runs the CUDA DP and traceback kernels.  On the
    CPU, batches under NATIVE_MAX_CELLS run the native C++ kernel and the
    rest the plain PyTorch DP with the host traceback; `backend` (a
    function with banded_align_batch's signature) forces that path, for
    tests on the CPU only.  The whole call is the span
    `cactus.align_pairs_banded` (cactus_tpu_torch/trace.py).
    """
    if not pairs:
        return []
    dev = resolve_device(device)
    if dev.type == "cuda" and backend is not None:
        raise ValueError("backend is a CPU test hook: on a CUDA device "
                         "every batch runs the banded_dp kernel")
    with span("cactus.align_pairs_banded"):
        if dev.type == "cuda":
            return _align_pairs_cuda(pairs, submat, gap, band,
                                     max_batch_bytes, dev)
        if backend is None:
            true_cells = sum(len(q) for q, _t in pairs) * band
            if true_cells < NATIVE_MAX_CELLS:
                out = align_pairs_native(pairs, submat, gap, band)
                if out is not None:
                    return out
            backend = banded_align_batch
        return _align_pairs_plain(pairs, submat, gap, band, backend,
                                  max_batch_bytes, dev)


def align_pairs_windowed(pairs, submat, gap: GapParams,
                         window: int = 10_000, band: int = 512,
                         overlap_frac: float = 0.5,
                         backend=None,
                         device=None) -> list[list[tuple[int, int, int]]]:
    """Long pairwise alignment as banded windows with carry-over cursors.

    The reference BAR slides 10 kb POA windows with 50% overlap over
    sequences up to bandingLimit=1 Mb and stitches them at per-window cut
    points (poaBarAligner.c:463-560).  Here each window is a banded
    affine DP; only matches in the committed prefix (the first
    (1-overlap) of the window) are kept, the cursors resume at the last
    committed match, and the overlap is re-aligned by the next window —
    so indel drift never accumulates past one window.  All active pairs
    advance in lockstep, one batched launch per generation.

    Returns, per pair, a list of (q_pos, t_pos, length) match runs.
    """
    dev = resolve_device(device)
    runs: list[list[tuple[int, int, int]]] = [[] for _ in pairs]
    cursors: dict[int, tuple[int, int]] = {
        k: (0, 0) for k, (q, t) in enumerate(pairs) if len(q) and len(t)}
    while cursors:
        active = sorted(cursors)
        batch = []
        for k in active:
            qi, ti = cursors[k]
            q, t = pairs[k]
            batch.append((q[qi:qi + window], t[ti:ti + window]))
        out = align_pairs_banded(batch, submat, gap, band=band,
                                 backend=backend, device=dev)
        for k, (_score, ops) in zip(active, out):
            qi, ti = cursors[k]
            q, t = pairs[k]
            qw = min(window, len(q) - qi)
            tw = min(window, len(t) - ti)
            last_window = (qi + qw >= len(q)) and (ti + tw >= len(t))
            cut = qw if last_window else max(1, int(qw * (1 - overlap_frac)))
            i = j = 0
            resume = None          # (i, j) just past the last kept match
            for op, ln in ops:
                if op == "M":
                    take = min(ln, cut - i)
                    if take > 0:
                        runs[k].append((qi + i, ti + j, take))
                        resume = (i + take, j + take)
                    i += ln
                    j += ln
                elif op == "I":
                    i += ln
                else:
                    j += ln
            if last_window:
                del cursors[k]
                continue
            if resume is None:
                # nothing committed: hop forward, re-syncing the axes
                step = cut
                nqi, nti = qi + step, ti + step
            else:
                nqi, nti = qi + resume[0], ti + resume[1]
            if nqi >= len(q) or nti >= len(t):
                del cursors[k]
            else:
                cursors[k] = (nqi, nti)
    return runs
