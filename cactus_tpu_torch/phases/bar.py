"""BAR phase: base-level refinement of the unaligned tangles left by CAF.

Reference flow (bar/impl/bar.c:52-176): for each leaf flower, gather the
adjacency sequences hanging off each block End (cap→cap strings, capped at
bandingLimit=1e6, cactus_progressive_config.xml:245), build one MSA per
End (abPOA windowed partial-order alignment, poaBarAligner.c:1115-1240, or
cPecan pair-HMM), keep every base in exactly ONE end's alignment
(consistency trimming, poaBarAligner.c:751-806), and pinch the MSA blocks
back into the graph (mini CAF anneal/melt, bar.c:133-145).

Design here:
 - the MSA engine is a batched STAR alignment on the banded affine-DP
   kernel (ops/banded.py, the CUDA kernel on a GPU): per end, the longest
   adjacency string is the
   backbone and every other member is banded-aligned to it; transitivity
   through backbone columns yields the multiple alignment (the poset-MSA
   analog).  All (member, backbone) pairs across ALL ends are packed into
   shape-binned device batches — the batched replacement for the
   reference's OpenMP flower loop.
 - long strings (up to bandingLimit=1 Mb) are aligned as 10 kb banded
   windows with 50% overlap and carry-over cursors
   (ops/banded.py:align_pairs_windowed — the scan-over-tiles analog of
   poaBarAligner.c:463-560's sliding windows).
 - consistency (best-cut): both ends of an adjacency gap see the full
   gap string (capped at bandingLimit); after alignment, each gap picks
   the cut point maximizing left-side coverage before it plus
   right-side coverage after it, and match runs are clipped so every
   base lands in exactly ONE end's alignment (poaBarAligner.c:751-806).
 - BAR match runs merge with the CAF block runs and columns/blocks are
   rebuilt in one vectorized pass (graph/columns.py), replacing the
   reference's incremental re-pinching.

 - the pecan engine (partialOrderAlignment=0, or msa_engine='pecan')
   replaces the star's member-vs-backbone jobs with spanning-tree pair
   selection and aligns each pair, split at MUM anchors, by pair-HMM
   posteriors (ops/pairhmm5.py, the 5-state CUDA kernels on a GPU).

 - the poa engine (msa_engine='poa', reached through the Python API:
   Config.bar.msa_engine) builds one partial-order MSA per end by
   progressive POA (ops/poa.py::poa_msa_batch, the POA CUDA kernels on a
   GPU: poa_chain for the chain graphs of round 1, poa_affine after) and
   emits a match run for every pair of members sharing a column.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import BarParams, PoaParams
from ..io.fasta import Sequence, revcomp
from ..graph import chains as chain_graph
from ..graph.columns import Blocks, SeqTable, build_columns, columns_to_blocks
from ..ops.banded import GapParams, align_pairs_banded, score_matrix_6
from .caf import CafResult, blocks_to_match_edges, filter_blocks_by_events, event_of

BOUNDARY = chain_graph.BOUNDARY

_warned: set[str] = set()


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        import logging
        logging.getLogger("cactus_tpu_torch").warning(msg)


def _check_pecan_knobs(pec) -> None:
    """Flag the one pecan knob this engine cannot honor (never a
    silent no-op).  spanningTrees / useProgressiveMerging / gapGamma /
    diagonalExpansion are honored since round 4 (poset pair selection,
    MEA threshold, band floor — see spanning_tree_pairs and the pecan
    branch of star_align_ends)."""
    from ..config import PecanParams
    ref = PecanParams()
    if pec.constraint_diagonal_trim != ref.constraint_diagonal_trim:
        _warn_once("pecan constraintDiagonalTrim is n/a to the "
                   "MUM-split banded design (no per-anchor constraint "
                   "diagonals to trim); value ignored")


def _minhash_sim(codes_list, k: int = 12, n_hash: int = 48):
    """Pairwise Jaccard-ish similarity via per-string minhash sketches
    (the cheap stand-in for cPecan's pairwise-alignment-score spanning
    trees).  Returns a (m, m) float matrix."""
    sketches = []
    mod = (1 << 61) - 1
    short = np.zeros(len(codes_list), dtype=bool)
    for idx, c in enumerate(codes_list):
        c = np.asarray(c, np.int64)
        if len(c) < k:
            # below-k members get a DISTINCT sentinel sketch (index
            # salt): an all-zeros sketch made every short-short pair
            # similarity 1.0 and biased spanning-tree-0 edges toward
            # degenerate short pairs (round-5 advisor finding — and the
            # measured mechanism of the pecan cross-clade collapse:
            # ancestor-refinement members are mostly short gap strings)
            short[idx] = True
            sketches.append(np.full(n_hash, -(idx + 1), np.int64))
            continue
        h = np.zeros(len(c) - k + 1, np.int64)
        for j in range(k):
            h = (h * 4 + np.clip(c[j:j + len(c) - k + 1], 0, 3)) % mod
        # n_hash independent permutations via multiply-shift
        rng = np.random.default_rng(12345)
        a = rng.integers(1, mod, n_hash)
        sk = ((h[None, :] * a[:, None]) % mod).min(axis=1)
        sketches.append(sk)
    S = np.stack(sketches)
    m = len(codes_list)
    sim = np.zeros((m, m))
    for i in range(m):
        sim[i, i + 1:] = (S[i] == S[i + 1:]).mean(axis=1)
        sim[i + 1:, i] = sim[i, i + 1:]
    return sim


def spanning_tree_pairs(codes_list, n_trees: int,
                        progressive: bool = True) -> list[tuple[int, int]]:
    """Pair selection for the pecan poset MSA: `n_trees` EDGE-DISJOINT
    spanning trees over the end's members (reference: cPecan
    makeAlignment's spanningTrees parameter, consumed at
    bar/impl/endAligner.c:87; config XML :272 spanningTrees=5).

    Tree 0 is the MAXIMUM-similarity spanning tree — with
    useProgressiveMerging (config :283) this is the progressive merge
    order (closest members pair first); subsequent trees exclude used
    edges so the pair set covers diverse member combinations, which is
    what lets the transitive poset (pinch) columns capture
    non-backbone homology a star misses.  Falls back to all pairs when
    that is no more work."""
    m = len(codes_list)
    if m < 2:
        return []
    all_pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    if len(all_pairs) <= n_trees * (m - 1):
        return all_pairs
    sim = _minhash_sim(codes_list)
    if not progressive:
        # non-progressive: same edge-disjoint construction but from an
        # arbitrary (index) order rather than similarity
        sim = -np.abs(np.subtract.outer(np.arange(m), np.arange(m))) \
            .astype(float)
    used: set[tuple[int, int]] = set()
    for _t in range(n_trees):
        cands = sorted(((i, j) for i, j in all_pairs
                        if (i, j) not in used),
                       key=lambda p: -sim[p[0], p[1]])
        parent = list(range(m))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        added = 0
        for i, j in cands:
            ri, rj = find(i), find(j)
            if ri == rj:
                continue
            parent[ri] = rj
            used.add((i, j))
            added += 1
            if added == m - 1:
                break
        if added == 0:
            break
    return sorted(used)


def estimate_block_identity(caf: CafResult, gcodes: np.ndarray,
                            max_bases: int = 200_000) -> float | None:
    """Observed per-column member agreement over sampled live blocks —
    the last-train role (reference: last-train via paf/last_scoring.py
    trains the scoring/HMM on the data's own divergence; cPecan's HMM
    is likewise divergence-trained).  Drives the pecan pair-HMM's
    emission p_match so posteriors stay confident at high divergence
    (measured: the stock p_match=0.94 emission collapses posterior
    recall to 0.41 on a divergence-0.4 ancestor pair)."""
    blocks, alive = caf.blocks, caf.alive
    sel = np.flatnonzero(alive[blocks.seg_block])
    if not len(sel):
        return None
    blk = blocks.seg_block[sel]
    order = np.argsort(blk, kind="stable")
    sel, blk = sel[order], blk[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(blk)) + 1])
    counts = np.diff(np.concatenate([starts, [len(blk)]]))
    two = counts >= 2
    if not two.any():
        return None
    first = sel[starts[two]]
    second = sel[starts[two] + 1]
    ln = blocks.seg_len[first].astype(np.int64)
    # cap total sampled bases
    cum = np.cumsum(ln)
    n_blocks = int(np.searchsorted(cum, max_bases)) + 1
    first, second, ln = first[:n_blocks], second[:n_blocks], ln[:n_blocks]
    n = int(ln.sum())
    if n == 0:
        return None
    seg_of = np.repeat(np.arange(len(ln)), ln)
    k = np.arange(n) - np.repeat(np.cumsum(ln) - ln, ln)
    table = caf.table

    def base_at(seg_idx):
        s = seg_idx[seg_of]
        st = blocks.seg_strand[s].astype(np.int64)
        pos = np.where(st == 1, k, ln[seg_of] - 1 - k)
        g = (table.offsets[blocks.seg_seq[s]]
             + blocks.seg_start[s] + pos)
        from ..io.fasta import complement
        raw = gcodes[g]
        return np.where(st == 1, raw, complement(raw))

    b1, b2 = base_at(first), base_at(second)
    ok = (b1 < 4) & (b2 < 4)
    if not ok.any():
        return None
    return float((b1[ok] == b2[ok]).mean())


def global_codes(table: SeqTable, seqs: dict[str, Sequence]) -> np.ndarray:
    """Concatenate per-sequence codes into the table's global index space."""
    out = np.empty(table.total, dtype=np.uint8)
    for name, i in table.index.items():
        o = int(table.offsets[i])
        out[o:o + int(table.lengths[i])] = seqs[name].codes
    return out


@dataclass
class EndString:
    """One adjacency string oriented walking away from its end.

    Oriented position i maps to global base:
      forward: gstart + i            (strand +1)
      reverse: gend - 1 - i          (strand -1)

    allow_lo/allow_hi bound the oriented positions this string may claim
    after best-cut consistency trimming (poaBarAligner.c:751-806): when
    two ends share a gap, both see the overlapping string, and the cut
    assigns each base to exactly one side.
    """
    gstart: int
    gend: int
    forward: bool
    allow_lo: int = 0
    allow_hi: int = 1 << 62

    def length(self) -> int:
        return self.gend - self.gstart

    def codes(self, gcodes: np.ndarray) -> np.ndarray:
        c = gcodes[self.gstart:self.gend]
        return c if self.forward else revcomp(c)

    def to_run(self, i0: int, ln: int) -> tuple[int, int]:
        """Oriented run [i0, i0+ln) → (global ascending start, strand)."""
        if self.forward:
            return self.gstart + i0, 1
        return self.gend - i0 - ln, -1

    def global_interval(self, i0: int, ln: int) -> tuple[int, int]:
        """Oriented run [i0, i0+ln) → ascending global [lo, hi)."""
        if self.forward:
            return self.gstart + i0, self.gstart + i0 + ln
        return self.gend - i0 - ln, self.gend - i0

    def set_allowed_global(self, glo: int, ghi: int) -> None:
        """Restrict claims to ascending global interval [glo, ghi)."""
        if self.forward:
            self.allow_lo = max(0, glo - self.gstart)
            self.allow_hi = max(self.allow_lo, ghi - self.gstart)
        else:
            self.allow_lo = max(0, self.gend - ghi)
            self.allow_hi = max(self.allow_lo, self.gend - glo)


@dataclass
class GapPair:
    """A two-real-end adjacency gap whose strings overlap and need a
    consistency cut: global range [g0, g1), left string walks forward
    from g0, right string walks backward from g1."""
    g0: int
    g1: int
    left: EndString
    right: EndString


def end_strings(caf: CafResult, cfg: BarParams, min_len: int = 2,
                with_gaps: bool = False):
    """Collect the adjacency strings per block end.

    Each thread adjacency contributes its gap, capped at bandingLimit
    (reference config:245).  Between two real ends BOTH sides see the
    (overlapping) gap string, preliminarily bounded at its midpoint; the
    best-cut pass after alignment moves the boundary to where alignment
    quality crosses over (poaBarAligner.c:751-806).  Assigned wholly to
    the real end when the other side is a thread boundary.

    Returns per_end, or (per_end, gap_pairs) when with_gaps.
    """
    cap = min(cfg.banding_limit, cfg.max_end_string)
    adj = chain_graph.thread_adjacencies(caf.blocks, caf.alive)
    table = caf.table
    per_end: dict[int, list[EndString]] = {}
    gaps: list[GapPair] = []
    for k in range(len(adj.seq)):
        u, v = int(adj.end_u[k]), int(adj.end_v[k])
        s = int(adj.seq[k])
        g0 = int(table.offsets[s] + adj.gap_start[k])
        g1 = int(table.offsets[s] + adj.gap_end[k])
        L = g1 - g0
        if L < min_len:
            continue
        if u == BOUNDARY and v == BOUNDARY:
            continue
        if v == BOUNDARY:
            per_end.setdefault(u, []).append(
                EndString(g0, g0 + min(L, cap), True))
        elif u == BOUNDARY:
            per_end.setdefault(v, []).append(
                EndString(g1 - min(L, cap), g1, False))
        else:
            mid = g0 + (L + 1) // 2
            left = EndString(g0, g0 + min(L, cap), True)
            right = EndString(g1 - min(L, cap), g1, False)
            left.set_allowed_global(g0, mid)
            right.set_allowed_global(mid, g1)
            if left.length() >= min_len:
                per_end.setdefault(u, []).append(left)
            if right.length() >= min_len:
                per_end.setdefault(v, []).append(right)
            if (min(L, cap) > (L + 1) // 2
                    and left.length() >= min_len
                    and right.length() >= min_len):
                # strings overlap: eligible for a best-cut refinement
                gaps.append(GapPair(g0, g1, left, right))
    if with_gaps:
        return per_end, gaps
    return per_end


def star_align_ends(per_end: dict[int, list[EndString]],
                    gcodes: np.ndarray, cfg: BarParams,
                    max_band: int = 2048,
                    ingroup_seqs: np.ndarray | None = None,
                    gap_pairs: list[GapPair] | None = None,
                    est_identity: float | None = None,
                    device=None):
    """Batched star MSA over all ends → global match runs.

    Returns a list of (ga, gb, ln, strand) runs (edges_from_runs format).
    Pairs are length-trimmed so the backbone slice matches the member
    length (+slack), keeping bands narrow; the pair list across all ends
    is aligned in shape-binned device batches.  Pairs longer than the POA
    window go through the windowed carry-over aligner
    (align_pairs_windowed), so strings up to bandingLimit refine fully.

    ingroup_seqs: boolean per global base — when given, the backbone is
    the longest INGROUP member (an outgroup backbone makes every
    ingroup↔ingroup homology transit two high-divergence alignments,
    which poisons the columns; reference BAR avoids this by running a
    full MSA rather than a star).

    gap_pairs: overlapping two-end gaps for the best-cut consistency
    pass — after alignment, each gap's cut point maximizes left-side
    coverage before it + right-side coverage after it, and all runs are
    clipped to their strings' allowed intervals so every base is claimed
    by exactly one end (poaBarAligner.c:751-806).

    est_identity: the pecan engine's divergence-trained emission
    p_match (estimate_block_identity), clipped to [0.60, 0.95].

    device: where the banded DP, the pair-HMMs and the POA DPs run (None =
    the current CUDA device).
    """
    engine = cfg.msa_engine
    if not cfg.partial_order_alignment and engine == "star":
        engine = "pecan"   # reference semantics: POA off → cPecan path
    poa: PoaParams = cfg.poa
    submat = score_matrix_6(poa.sub_matrix)
    gap = GapParams(poa.gap_open1, poa.gap_extend1)

    def is_ingroup(e: EndString) -> bool:
        if ingroup_seqs is None:
            return True
        return bool(ingroup_seqs[e.gstart])

    jobs = []        # (member EndString, backbone EndString, t_len, band)
    long_jobs = []   # (member EndString, backbone EndString)
    for end, members in per_end.items():
        if len(members) < 2:
            continue
        members = sorted(members,
                         key=lambda e: (not is_ingroup(e), -e.length()))
        backbone = members[0]
        bb_len = backbone.length()
        for m in members[1:]:
            ml = m.length()
            if ml > poa.window or bb_len > poa.window:
                long_jobs.append((m, backbone))
                continue
            # adaptive band (reference: abPOA band 1000 + 0.1*len,
            # config:310-311); long/pathological ratios go windowed
            t_len = min(bb_len, ml + poa.band_constant // 4)
            band = 128
            need = abs(t_len - ml) + min(
                poa.band_constant + int(poa.band_fraction * ml), max_band)
            while band <= need:
                band *= 2
            if band > max_band:
                long_jobs.append((m, backbone))
                continue
            jobs.append((m, backbone, t_len, band))

    by_band: dict[int, list] = {}
    for job in jobs:
        by_band.setdefault(job[3], []).append(job)

    raw: list[tuple[EndString, EndString, int, int, int]] = []

    def emit(m: EndString, b: EndString, i0: int, j0: int, ln: int):
        raw.append((m, b, i0, j0, ln))

    if engine == "poa":
        # true partial-order MSA per end (abPOA-parity path): all member
        # pairs sharing a column emit matches, not just member<->backbone.
        # Members longer than the POA window go through the windowed
        # pairwise path (long_jobs) like the other engines.
        from ..ops.poa import poa_msa_batch
        end_jobs = []
        for end, members in per_end.items():
            members = [m for m in members if m.length() <= poa.window]
            if len(members) < 2:
                continue
            members = sorted(members, key=lambda e: -e.length())
            end_jobs.append((members, [m.codes(gcodes) for m in members]))
        # one batched launch per shape bin per progressive round (the
        # per-flower OpenMP loop of bar.c:52 as batched device launches)
        graphs = poa_msa_batch([sq for _m, sq in end_jobs], poa,
                               device=device)
        for (members, _sq), graph in zip(end_jobs, graphs):
            matched = graph.match_runs_between_walks()
            matched.sort()
            prev = None
            start = None
            run_len = 0
            for wi, pi, wj, pj in matched:
                if (prev is not None and prev[0] == wi and prev[2] == wj
                        and pi == prev[1] + 1 and pj == prev[3] + 1):
                    run_len += 1
                else:
                    if prev is not None:
                        emit(members[start[0]], members[start[2]],
                             start[1], start[3], run_len)
                    start = (wi, pi, wj, pj)
                    run_len = 1
                prev = (wi, pi, wj, pj)
            if prev is not None:
                emit(members[start[0]], members[start[2]],
                     start[1], start[3], run_len)
        by_band = {}

    pecan_pairs = []      # (member, member, t_len)
    if engine == "pecan":
        # poset MSA pair selection (reference makeFlowerAlignment ->
        # cPecan makeAlignment, endAligner.c:87): spanningTrees
        # edge-disjoint trees per end replace the star's
        # member-vs-backbone jobs; every selected pair emits match
        # runs, and the pinch graph's transitive column merge IS the
        # poset combine — homology between non-backbone members no
        # longer has to transit two backbone alignments
        pec = cfg.pecan
        by_band = {}
        # members up to bandingLimit pecan-align when MUM anchoring can
        # split their matrices (reference: adjacency sequences trimmed
        # to bandingLimit=1e6 feed cPecan, flowerAligner.c;
        # config :245); without anchors the full-matrix band explodes,
        # so the POA-window cap stays
        mcap = (min(cfg.banding_limit, cfg.max_end_string)
                if pec.use_mum_anchors else poa.window)
        for end, members in per_end.items():
            if len(members) < 2:
                continue
            members = sorted(members,
                             key=lambda e: (not is_ingroup(e),
                                            -e.length()))
            elig = [m for m in members if m.length() <= mcap]
            if len(elig) < 2:
                continue
            for i, j in spanning_tree_pairs(
                    [m.codes(gcodes) for m in elig],
                    pec.spanning_trees,
                    progressive=pec.use_progressive_merging):
                a, b = elig[i], elig[j]
                t_len = min(b.length(),
                            a.length() + poa.band_constant // 4)
                pecan_pairs.append((a, b, t_len))

    for band, group in by_band.items():
        pairs = [(m.codes(gcodes), b.codes(gcodes)[:t_len])
                 for m, b, t_len, _ in group]
        out = align_pairs_banded(pairs, submat, gap, band=band,
                                 device=device)
        for (m, b, t_len, _), (_score, ops) in zip(group, out):
            i = j = 0
            for op, ln in ops:
                if op == "M":
                    emit(m, b, i, j, ln)
                    i += ln
                    j += ln
                elif op == "I":
                    i += ln
                else:
                    j += ln

    if pecan_pairs:
        _pecan_align(pecan_pairs, gcodes, cfg, max_band, est_identity, emit,
                     device)

    if long_jobs:
        # strings beyond the POA window: banded windows with carry-over
        # cursors, full length up to bandingLimit
        from ..ops.banded import align_pairs_windowed
        wruns = align_pairs_windowed(
            [(m.codes(gcodes), b.codes(gcodes)) for m, b in long_jobs],
            submat, gap, window=poa.window, band=512, device=device)
        for (m, b), rr in zip(long_jobs, wruns):
            for i0, j0, ln in rr:
                emit(m, b, i0, j0, ln)

    if gap_pairs:
        _apply_best_cuts(raw, gap_pairs)

    # convert oriented runs to global runs, clipped to each string's
    # allowed interval (consistency: every base in exactly one end MSA)
    runs: list[tuple[int, int, int, int]] = []
    for m, b, i0, j0, ln in raw:
        k0 = max(0, m.allow_lo - i0, b.allow_lo - j0)
        k1 = min(ln, m.allow_hi - i0, b.allow_hi - j0)
        if k1 <= k0:
            continue
        i0, j0, ln = i0 + k0, j0 + k0, k1 - k0
        ga, sa = m.to_run(i0, ln)
        gb, sb = b.to_run(j0, ln)
        if sa == 1:
            runs.append((ga, gb, ln, sb))
        elif sb == 1:
            runs.append((gb, ga, ln, sa))
        else:
            # both reversed: forward pairing of the reversed intervals
            runs.append((ga, gb, ln, 1))
    return runs


def _pecan_align(pecan_pairs, gcodes: np.ndarray, cfg: BarParams,
                 max_band: int, est_identity: float | None, emit,
                 device) -> None:
    """The pecan engine's pair-HMM posterior matches (bar.c cPecan
    branch), emitted as oriented runs.

    Five-state machine by default (stateMachine5, bar.c:65); big matrices
    split at MUM-chain anchors first (useMumAnchors /
    splitMatrixBiggerThanThis semantics, config:276-285), then PIECES bin
    by their own band requirement — so a 500 kb member costs narrow
    anchored strips, never a member-sized band (reference pecan handles
    adjacency sequences up to bandingLimit = 1 Mb)."""
    pec = cfg.pecan
    poa = cfg.poa
    _check_pecan_knobs(pec)
    pairs = [(m.codes(gcodes), b.codes(gcodes)[:t_len])
             for m, b, t_len in pecan_pairs]
    if pec.use_mum_anchors:
        from ..ops.anchors import split_pair_by_mums
        pieces = []      # (pair idx, q0, t0, qs, ts)
        for gi, (qc, tc) in enumerate(pairs):
            # matrices under anchorMatrixBiggerThanThis run without
            # anchoring (cPecan semantics, config :278)
            if max(len(qc), len(tc)) <= pec.anchor_matrix_bigger_than_this:
                pieces.append((gi, 0, 0, qc, tc))
                continue
            for q0, t0, qs, ts in split_pair_by_mums(
                    qc, tc, max_span=pec.split_matrix_bigger_than_this,
                    recursive=pec.recursive_mums):
                pieces.append((gi, q0, t0, qs, ts))
    else:
        pieces = [(gi, 0, 0, qc, tc) for gi, (qc, tc) in enumerate(pairs)]
    # MEA acceptance honoring gapGamma (config :272): the decoder picks
    # match over gap when p >= gapGamma*(1-p), i.e. p >=
    # gapGamma/(1+gapGamma); matchGamma floors it
    gamma_eff = max(pec.match_gamma, pec.gap_gamma / (1.0 + pec.gap_gamma))
    # divergence-trained emissions (the last-train role,
    # estimate_block_identity): the stock p_match=0.94 is a low-divergence
    # model and its posteriors collapse at divergence ~0.4
    pm = (float(np.clip(est_identity, 0.60, 0.95))
          if est_identity is not None else 0.94)
    piece_bins: dict[int, list] = {}
    for gi, q0, t0, qs, ts in pieces:
        la = len(qs)
        if pec.use_banding:
            need = abs(len(ts) - la) + max(
                2 * pec.diagonal_expansion,
                min(poa.band_constant + int(poa.band_fraction * la),
                    max_band))
        else:
            need = max(len(qs), len(ts)) + 8
        pband = 128
        while pband <= need:
            pband *= 2
        piece_bins.setdefault(pband, []).append((gi, q0, t0, qs, ts))
    hits = [[] for _ in pairs]
    for pband, bin_pieces in piece_bins.items():
        piece_pairs = [(qs, ts) for _g, _q, _t, qs, ts in bin_pieces]
        if pec.five_state:
            from ..ops.pairhmm5 import Hmm5Params, posterior_pairs_banded5
            piece_hits = posterior_pairs_banded5(
                piece_pairs, Hmm5Params(p_match=pm), band=pband,
                gamma=gamma_eff, device=device)
        else:
            from ..ops.pairhmm import HmmParams, posterior_pairs_banded
            piece_hits = posterior_pairs_banded(
                piece_pairs, HmmParams(p_match=pm), band=pband,
                gamma=gamma_eff, device=device)
        for (gi, q0, t0, _qs, _ts), ph in zip(bin_pieces, piece_hits):
            hits[gi].extend((i + q0, j + t0, p) for i, j, p in ph)
    for h in hits:
        h.sort()
    if not pec.align_ambiguity_characters:
        # drop pairs touching an N (alignAmbiguityCharacters=0)
        hits = [[(i, j, p) for i, j, p in h
                 if pairs[gi][0][i] < 4 and pairs[gi][1][j] < 4]
                for gi, h in enumerate(hits)]
    for (m, b, _t_len), matched in zip(pecan_pairs, hits):
        # merge consecutive (i,j) hits into runs
        start = None
        for k, (i, j, _p) in enumerate(matched):
            if (start is not None
                    and i == matched[k - 1][0] + 1
                    and j == matched[k - 1][1] + 1):
                continue
            if start is not None:
                i0, j0 = matched[start][:2]
                emit(m, b, i0, j0, matched[k - 1][0] - i0 + 1)
            start = k
        if start is not None:
            i0, j0 = matched[start][:2]
            emit(m, b, i0, j0, matched[-1][0] - i0 + 1)


def _apply_best_cuts(raw, gap_pairs: list[GapPair]) -> None:
    """Pick each overlapping gap's cut point from alignment coverage.

    The cut c maximizes (bases the left string aligned in [g0,c)) +
    (bases the right string aligned in [c,g1)); ties resolve to the
    position nearest the midpoint.  Updates the strings' allowed
    intervals in place (reference per-window trimming + consistency,
    poaBarAligner.c:751-806)."""
    side_of: dict[int, tuple[int, int]] = {}
    cov: dict[int, tuple[int, int, np.ndarray]] = {}
    for gi, g in enumerate(gap_pairs):
        side_of[id(g.left)] = (gi, 0)
        side_of[id(g.right)] = (gi, 1)
        lo = max(g.right.gstart, g.g0)
        hi = min(g.left.gend, g.g1)
        cov[gi] = (lo, hi, np.zeros((hi - lo, 2), dtype=bool))
    for m, b, i0, j0, ln in raw:
        for e, o0 in ((m, i0), (b, j0)):
            tag = side_of.get(id(e))
            if tag is None:
                continue
            gi, side = tag
            lo, hi, c = cov[gi]
            glo, ghi = e.global_interval(o0, ln)
            a, z = max(glo, lo), min(ghi, hi)
            if a < z:
                c[a - lo:z - lo, side] = True
    for gi, g in enumerate(gap_pairs):
        lo, hi, c = cov[gi]
        n = hi - lo
        cl = np.concatenate([[0], np.cumsum(c[:, 0])])
        cr = np.concatenate([[0], np.cumsum(c[:, 1])])
        f = cl + (cr[n] - cr)       # f[k]: cut at lo+k
        cand = np.flatnonzero(f == f.max())
        midc = (g.g0 + g.g1) // 2 - lo
        cut = lo + int(cand[np.argmin(np.abs(cand - midc))])
        g.left.set_allowed_global(g.g0, cut)
        g.right.set_allowed_global(cut, g.g1)


def run_bar(caf: CafResult, seqs: dict[str, Sequence],
            cfg: BarParams,
            ingroup_events: set[str] | None = None,
            outgroup_events: set[str] | None = None,
            device=None) -> CafResult:
    """Refine the CAF result with base-level end alignments.

    CAF block evidence and BAR MSA evidence are merged and the
    columns/blocks rebuilt; block filters re-apply (bar re-runs the CAF
    filters on the refined graph, reference bar.c:133-145).
    """
    if not cfg.run_bar:
        return caf
    gcodes = global_codes(caf.table, seqs)
    per_end, gaps = end_strings(caf, cfg, with_gaps=True)
    ingroup_seqs = None
    if ingroup_events:
        ingroup_seqs = np.zeros(caf.table.total, dtype=bool)
        for name, i in caf.table.index.items():
            if name.split(".", 1)[0] in ingroup_events:
                o = int(caf.table.offsets[i])
                ingroup_seqs[o:o + int(caf.table.lengths[i])] = True
    est_identity = None
    if cfg.msa_engine == "pecan" or not cfg.partial_order_alignment:
        est_identity = estimate_block_identity(caf, gcodes)
    bar_runs = star_align_ends(per_end, gcodes, cfg,
                               ingroup_seqs=ingroup_seqs,
                               gap_pairs=gaps if cfg.best_cut else None,
                               est_identity=est_identity, device=device)
    caf_runs = blocks_to_match_edges(caf.blocks, caf.alive)
    bar_arr = (np.asarray(bar_runs, np.int64).reshape(-1, 4)
               if len(bar_runs) else np.zeros((0, 4), np.int64))
    # rebuild the graph from (CAF ∪ BAR) evidence on the segment-level
    # pinch path (the mini CAF re-anneal of bar.c:133-145); CAF block
    # runs pinch first so established homology keeps its orientation
    from ..graph.pinch import pinch_blocks, global_runs_to_thread_runs
    blocks = pinch_blocks(
        caf.table, caf.events_of_seq,
        primary_runs=global_runs_to_thread_runs(
            np.concatenate([caf_runs, bar_arr]), caf.table),
        min_degree=cfg.minimum_block_degree)
    alive = np.ones(blocks.n_blocks, dtype=bool)
    # BarParams carries the same degree/species knobs as CafParams, so the
    # CAF block filter applies directly to the refined graph
    alive = filter_blocks_by_events(blocks, alive, cfg,
                                    ingroup_events or set(),
                                    outgroup_events or set())
    return CafResult(table=caf.table, blocks=blocks, alive=alive,
                     events_of_seq=caf.events_of_seq,
                     outgroup_events=caf.outgroup_events)


def rescue_outgroup_covered(caf: CafResult, og_records, cfg: BarParams
                            ) -> CafResult:
    """bar rescue: unblocked ingroup runs that outgroup blast alignments
    covered become single-degree blocks, so the sequence reaches the
    ancestor (it existed in the parent — an outgroup witnessed it even
    though every other child lost it).  Reference bar/impl/rescue.c:
    rescueCoveredRegions (minSegmentLength + coveredBasesThreshold
    filters; vestigial in the reference's current call path, but
    load-bearing here because the ancestor only carries block sequence).
    """
    if not og_records:
        return caf
    table = caf.table
    # 1. outgroup-coverage intervals on ingroup global coordinates
    ivs = []
    for r in og_records:
        for name, a, b in ((r.qname, r.qstart, r.qend),
                           (r.tname, r.tstart, r.tend)):
            i = table.index.get(name)
            if i is not None:
                off = int(table.offsets[i])
                ivs.append((off + a, off + b))
    from ..utils.intervals import interval_coverage, merge_intervals
    cov_s, cov_e = merge_intervals(np.asarray(ivs, dtype=np.int64))
    if not len(cov_s):
        return caf
    # 2. unblocked gaps: complement of live-block segments per sequence
    blocks = caf.blocks
    live_seg = caf.alive[blocks.seg_block]
    g0 = (table.offsets[blocks.seg_seq[live_seg]]
          + blocks.seg_start[live_seg])
    g1 = g0 + blocks.seg_len[live_seg]
    blk_s, blk_e = merge_intervals(np.stack([g0, g1], axis=1))
    gaps = []
    for name, si in table.index.items():
        lo = int(table.offsets[si])
        hi = lo + int(table.lengths[si])
        # intervals OVERLAPPING [lo,hi) — merged intervals can straddle
        # a sequence boundary (adjacent sequences are contiguous in
        # global coordinates), so select by overlap and clip
        from ..utils.intervals import complement_intervals
        a = np.searchsorted(blk_e, lo, side="right")
        b = np.searchsorted(blk_s, hi, side="left")
        seg_s, seg_e = complement_intervals(blk_s[a:b], blk_e[a:b], lo, hi)
        keep = seg_e - seg_s >= cfg.rescue_min_segment_length
        for x, y in zip(seg_s[keep], seg_e[keep]):
            gaps.append((int(x), int(y), si))
    if not gaps:
        return caf
    garr = np.asarray(gaps, dtype=np.int64)
    covered = interval_coverage(garr[:, 0], garr[:, 1], cov_s, cov_e)
    frac = covered / (garr[:, 1] - garr[:, 0])
    take = frac > cfg.rescue_covered_threshold
    if not take.any():
        return caf
    sel = garr[take]
    n_new = len(sel)
    new_ids = np.arange(blocks.n_blocks, blocks.n_blocks + n_new)
    new_blocks = Blocks(
        table=table,
        seg_block=np.concatenate([blocks.seg_block, new_ids]),
        seg_seq=np.concatenate([blocks.seg_seq, sel[:, 2]]),
        seg_start=np.concatenate(
            [blocks.seg_start, sel[:, 0] - table.offsets[sel[:, 2]]]),
        seg_len=np.concatenate([blocks.seg_len, sel[:, 1] - sel[:, 0]]),
        seg_strand=np.concatenate(
            [blocks.seg_strand, np.ones(n_new, dtype=blocks.seg_strand.dtype)]),
        n_blocks=blocks.n_blocks + n_new,
        support=(np.concatenate([blocks.support, np.ones(n_new, dtype=blocks.support.dtype)])
                 if blocks.support is not None else None))
    alive = np.concatenate([caf.alive, np.ones(n_new, dtype=bool)])
    return CafResult(table=table, blocks=new_blocks, alive=alive,
                     events_of_seq=caf.events_of_seq,
                     outgroup_events=caf.outgroup_events)
