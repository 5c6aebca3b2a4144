"""Reference phase: ancestral genome ordering + ML base reconstruction.

Reference flow (reference/impl/buildReference.c:1007-1110,1285-1332):
nodes are chain ends + stub ends; adjacency edges carry Z-scores with gap
decay and phylogenetic weighting; stub ends are perfect-matched
(blossom5/greedy/maxWeight), blocks are greedily ordered (+ permutation
nudges), broken adjacencies become scaffold gaps of Ns
(cactus_progressive_config.xml:339-361).  Ancestral bases are maximum-
likelihood under Jukes-Cantor via Felsenstein pruning
(reference/impl/blockMLString.c:11-50, JC matrices generated per branch at
pipeline/cactus_consolidated.c:108,489).

Design:
 - ordering/matching is host-side: exact blossom max-weight matching
   (matching_algorithm=blossom5/maxWeight/maxCardinality, the vendored
   networkx algorithm in utils/matching.py) with a greedy fallback past a
   size cap, plus nudge permutations — the reference's
   matchingAndOrdering surface (buildReference.c:1293-1306);
 - the Felsenstein pruning pass is ONE batched computation over every
   column of a window of blocks: messages are (columns, 4) tensors
   propagated up the event tree with per-branch JC transition matmuls —
   numpy for modest windows, PyTorch on the device for large ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..config import ReferenceParams
from ..io.fasta import Sequence, complement, N as N_CODE
from ..ops import resolve_device
from ..utils.trees import Tree
from .caf import CafResult, event_of

# observation tensors of at least this many elements run on the device;
# smaller ones run the identical float32 arithmetic in numpy
DEVICE_MIN_ELEMENTS = 200_000_000


# --------------------------------------------------------------------------
# ML ancestral bases (Felsenstein pruning, Jukes-Cantor)
# --------------------------------------------------------------------------

def jc_matrix(t: float) -> np.ndarray:
    """Jukes-Cantor transition matrix for branch length t (subs/site)."""
    e = np.exp(-4.0 / 3.0 * max(t, 1e-8))
    same = 0.25 + 0.75 * e
    diff = 0.25 - 0.25 * e
    m = np.full((4, 4), diff)
    np.fill_diagonal(m, same)
    return m


def _postorder_schedule(tree: Tree, event_index: dict[str, int]):
    """(child_idx, parent_idx, P_matrix) edges in postorder."""
    edges = []
    for node in tree.postorder():
        if node.parent is not None:
            edges.append((event_index[node.name],
                          event_index[node.parent.name],
                          jc_matrix(node.length or 0.0)))
    return edges


def felsenstein_ml(obs: np.ndarray, counts: np.ndarray, tree: Tree,
                   event_names: list[str], device=None,
                   device_min_elements: int = DEVICE_MIN_ELEMENTS
                   ) -> np.ndarray:
    """Batched ML root-state reconstruction.

    obs:    (C, E, 4) float32 — per column, per event, product of one-hot
            observations of that event's segments (uniform 1s if the event
            is absent in the column / base is N).
    counts: (C, E) int — observation counts (0 = missing; only used to
            keep absent-event messages at exactly ones).
    Returns (C,) uint8 argmax root base per column.  Tensors of at least
    device_min_elements elements run on `device` (None = the current
    CUDA device).
    """
    event_index = {n: i for i, n in enumerate(event_names)}
    edges = _postorder_schedule(tree, event_index)
    root_idx = event_index[tree.name]
    E = len(event_names)

    # device dispatch only pays off when the column batch is large: the
    # pruning pass moves (C,E,4) float32 over PCIe for ~16 flops/element,
    # so modest ancestors run as plain numpy — the arithmetic is the same
    # (float32 matmul + renormalize + argmax)
    if obs.size < device_min_elements:
        obs32 = obs.astype(np.float32)
        msgs = [np.ascontiguousarray(obs32[:, i, :]) for i in range(E)]
        for child, parent, P in edges:
            lifted = msgs[child] @ P.T.astype(np.float32)
            m = msgs[parent] * lifted
            m /= np.maximum(m.sum(axis=1, keepdims=True),
                            np.float32(1e-30))
            msgs[parent] = m
        return np.argmax(msgs[root_idx], axis=1).astype(np.uint8)

    dev = resolve_device(device)
    # float32 products in full float32 (torch's default for matmul)
    obs_t = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(dev)
    msgs = [obs_t[:, i, :] for i in range(E)]
    for child, parent, P in edges:
        lifted = msgs[child] @ torch.from_numpy(
            np.ascontiguousarray(P.T, np.float32)).to(dev)
        m = msgs[parent] * lifted
        # renormalize to dodge underflow on deep trees
        msgs[parent] = m / torch.clamp_min(m.sum(dim=1, keepdim=True),
                                           1e-30)
    return torch.argmax(msgs[root_idx], dim=1).to(torch.uint8).cpu().numpy()


def overlay_outgroup_observations(caf: CafResult, obs: np.ndarray,
                                  col_off: dict, og_records,
                                  og_codes: dict[str, np.ndarray],
                                  event_names: list[str]) -> int:
    """Apply og votes directly to a whole-genome obs tensor (legacy
    unchunked entry; run_reference streams via overlay_vote_arrays)."""
    rows, evs, bases = overlay_vote_arrays(caf, col_off, og_records,
                                           og_codes, event_names)
    # accumulate over duplicate (row, event) votes (see run_reference)
    np.multiply.at(obs, (rows, evs), np.float32(1e-3))
    np.multiply.at(obs, (rows, evs, bases), np.float32(1e3))
    return len(rows)


def overlay_vote_arrays(caf: CafResult, col_off: dict, og_records,
                        og_codes: dict[str, np.ndarray],
                        event_names: list[str]):
    """Project outgroup alignments onto existing block columns as
    Felsenstein votes WITHOUT pinching them into the graph.

    Outgroup pinches fragment ingroup block segmentation (alignment
    wobble between independent og alignments splits lockstep runs), so
    the driver keeps og records out of CAF and adds their evidence here:
    for each aligned pair (ingroup base q, outgroup base t), q's block
    column gets a soft vote for t's base.  This is the reconstruction
    role outgroups play in the reference (ancestral ML bases,
    blockMLString.c) with none of the structural interference.
    Returns (rows, events, bases) int arrays sorted by global column
    row, ready for chunked application.
    """
    from ..io.fasta import complement
    eidx = {n: i for i, n in enumerate(event_names)}
    table = caf.table
    blocks = caf.blocks
    lens = blocks.block_length()
    # per-sequence segment arrays for column lookup
    seg_by_seq: dict[int, tuple] = {}
    order = np.lexsort((blocks.seg_start, blocks.seg_seq))
    sseq = blocks.seg_seq[order]
    for si in np.unique(sseq):
        sel = order[sseq == si]
        seg_by_seq[int(si)] = (blocks.seg_start[sel], blocks.seg_len[sel],
                               blocks.seg_strand[sel], blocks.seg_block[sel])
    out_rows, out_evs, out_bases = [], [], []
    for r in og_records:
        # orient: q side must be the INGROUP sequence
        qname, tname = r.qname, r.tname
        q_in = qname in table.index
        t_in = tname in table.index
        og_name = tname if q_in else qname
        if og_name not in og_codes:
            continue
        codes_og = og_codes[og_name]
        e = eidx.get(og_name.split(".", 1)[0])
        if e is None:
            continue
        pairs = list(r.aligned_pairs())
        if not pairs:
            continue
        qp = np.array([p[0] for p in pairs], dtype=np.int64)
        tp = np.array([p[1] for p in pairs], dtype=np.int64)
        if not q_in:
            qp, tp = tp, qp
            in_name = tname
        else:
            in_name = qname
        si = table.index[in_name]
        seg = seg_by_seq.get(si)
        if seg is None:
            continue
        starts, slens, strands, sblocks = seg
        idx = np.searchsorted(starts, qp, side="right") - 1
        ok = (idx >= 0) & (qp < starts[np.maximum(idx, 0)]
                           + slens[np.maximum(idx, 0)])
        if not ok.any():
            continue
        idx, qv, tv = idx[ok], qp[ok], tp[ok]
        b = sblocks[idx]
        live = caf.alive[b]
        idx, qv, tv, b = idx[live], qv[live], tv[live], b[live]
        if not len(b):
            continue
        k = qv - starts[idx]
        col = np.where(strands[idx] == 1, k, slens[idx] - 1 - k)
        base = codes_og[tv]
        # og base orientation: record strand relative to the ingroup
        # forward strand; '-' records pair q forward with t reversed
        if r.strand == "-":
            base = complement(base)
        # segment orientation flips again in block space
        base = np.where(strands[idx] == 1, base, complement(base))
        offs = np.array([col_off.get(int(bb), -1) for bb in b])
        okc = (offs >= 0) & (base < 4)
        rows = offs[okc] + col[okc]
        out_rows.append(rows)
        out_evs.append(np.full(len(rows), e, np.int32))
        out_bases.append(base[okc].astype(np.int32))
    if not out_rows:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int32), z.astype(np.int32)
    rows = np.concatenate(out_rows)
    evs = np.concatenate(out_evs)
    bases = np.concatenate(out_bases)
    order = np.argsort(rows, kind="stable")
    return rows[order], evs[order], bases[order]


def block_observations(caf: CafResult, gcodes: np.ndarray,
                       event_names: list[str], live_slice=None,
                       col_base: int = 0):
    """Build the (C, E, 4) observation tensor over live block columns.

    Column order within block b is the block's column chain; a -1-strand
    segment contributes complemented bases in reversed order (bidirected
    column semantics, graph/columns.py).
    Returns (obs, counts, block_ids (C,), block_col_lens {b: L}).

    live_slice=(i0, i1): restrict to live blocks [i0, i1) of the live
    list, with col_base = the global column offset of live block i0 —
    the streaming window run_reference iterates so the observation
    tensor and its per-base expansion stay bounded at genome scale
    (unchunked, the expansion is ~65 B per segment base: >100 GB for a
    1 Gb pair)."""
    blocks = caf.blocks
    table = caf.table
    eidx = {n: i for i, n in enumerate(event_names)}
    live_all = np.flatnonzero(caf.alive)
    live = (live_all if live_slice is None
            else live_all[live_slice[0]:live_slice[1]])
    lens = blocks.block_length()
    live_lens = lens[live].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(live_lens)])
    total = int(offs[-1])
    col_off = {int(b): col_base + int(o) for b, o in zip(live, offs[:-1])}
    E = len(event_names)
    block_ids = np.repeat(live.astype(np.int64), live_lens)
    seq_event = np.array([eidx.get(event_of(n), -1) for n in table.names])
    coloff_arr = np.full(blocks.n_blocks, -1, dtype=np.int64)
    coloff_arr[live] = offs[:-1]
    in_window = np.zeros(blocks.n_blocks, dtype=bool)
    in_window[live] = True

    # vectorized over all segment bases (no per-segment Python loop):
    # obs[c,e,s] = 1e-3^N(c,e) * 1e3^n(c,e,s) with N = #observations of
    # event e in column c and n = #observations in state s — identical
    # to the sequential multiplicative form, computed via bincounts;
    # per-(c,e) max-normalization guards float32 underflow on deep
    # paralogous columns.
    sel = np.flatnonzero(in_window[blocks.seg_block]
                         & (seq_event[blocks.seg_seq] >= 0))
    if len(sel):
        ln = blocks.seg_len[sel]
        n_base = int(ln.sum())
        seg_of = np.repeat(np.arange(len(sel)), ln)
        k = np.arange(n_base) - np.repeat(np.cumsum(ln) - ln, ln)
        s_seg = sel[seg_of]
        gpos = (table.offsets[blocks.seg_seq[s_seg]]
                + blocks.seg_start[s_seg] + k)
        raw = gcodes[gpos]
        strand = blocks.seg_strand[s_seg]
        base = np.where(strand == 1, raw, complement(raw))
        col = np.where(strand == 1, k, ln[seg_of] - 1 - k)
        gcol = coloff_arr[blocks.seg_block[s_seg]] + col
        e_rep = seq_event[blocks.seg_seq[s_seg]]
        valid = base < 4
        gv, ev, bv = gcol[valid], e_rep[valid], base[valid]
        ce = gv * E + ev
        counts = np.bincount(ce, minlength=total * E).reshape(
            total, E).astype(np.int32)
        # obs[c,e,:] = max-normalized 10^(3*(n_s - max_s n_s)).  The
        # overwhelming majority of (column, event) cells hold exactly
        # ONE observation — a one-hot row — so build those by direct
        # scatter and run the full histogram only over the rare
        # multi-observation cells (the (C,E,4) int64 bincount pair was
        # the genome-scale hot spot).
        obs = np.ones((total, E, 4), dtype=np.float32)
        flat = obs.reshape(-1, 4)
        single = counts.reshape(-1)[ce] == 1
        ce1, bv1 = ce[single], bv[single]
        flat[ce1] = np.float32(1e-3)
        flat.reshape(-1)[ce1 * 4 + bv1] = 1.0
        if not single.all():
            cem, bvm = ce[~single], bv[~single]
            uniq_ce, inv = np.unique(cem, return_inverse=True)
            n_s = np.zeros((len(uniq_ce), 4), np.int64)
            np.add.at(n_s, (inv, bvm), 1)
            diff = np.minimum(n_s.max(axis=1, keepdims=True) - n_s, 12
                              ).astype(np.uint8)
            lut = (10.0 ** (-3.0 * np.arange(13))).astype(np.float32)
            flat[uniq_ce] = lut[diff]
    else:
        obs = np.ones((total, E, 4), dtype=np.float32)
        counts = np.zeros((total, E), dtype=np.int32)
    return obs, counts, block_ids, col_off


@dataclass
class ReferenceResult:
    """Ancestral genome: block order, orientation, ML bases, coordinates."""
    event: str                                  # ancestor event name
    threads: list[list[tuple[int, int]]]        # [(block, orient)] per thread
    block_codes: dict[int, np.ndarray]          # block -> ML codes (col order)
    block_coord: dict[int, tuple[str, int, int]]  # block -> (seq, start, orient)
    sequences: dict[str, Sequence]              # ancestor FASTA

    def total_length(self) -> int:
        return sum(len(s) for s in self.sequences.values())


def _end_adjacency_weights(caf: CafResult, ingroup_only: bool = False):
    """Aggregate DIRECT thread adjacencies between live block ends.

    Returns {(end_u, end_v) canonical: (support, median_gap)} — the
    countDAL analog (buildReference.c:1190: countAdapterFn direct
    adjacency support, used for minNumberOfSequencesToSupportAdjacency
    breaking) plus median gaps for scaffold sizing.

    ingroup_only skips adjacencies carried by OUTGROUP threads
    (caf.outgroup_events): with caf.pinch_outgroups, og alignment
    boundaries wobble between independent og-vs-ingroup alignments, and
    their threads exiting mid-run must not make an ingroup-proven chain
    link look ambiguous (the reference's chains come from the cactus
    graph, where a link needs only the shared adjacency component —
    stubs wandering off do not break it; buildReference.c:413-476
    orders CHAIN nodes, never individual wobble fragments).
    """
    from ..graph import chains as chain_graph
    adj = chain_graph.thread_adjacencies(caf.blocks, caf.alive)
    skip_og = ingroup_only and caf.outgroup_events
    weights: dict[tuple[int, int], list[int]] = {}
    for k in range(len(adj.seq)):
        u, v = int(adj.end_u[k]), int(adj.end_v[k])
        if u < 0 or v < 0:
            continue
        if skip_og and caf.events_of_seq[int(adj.seq[k])] \
                in caf.outgroup_events:
            continue
        key = (u, v) if u <= v else (v, u)
        gap = int(adj.gap_end[k] - adj.gap_start[k])
        weights.setdefault(key, []).append(gap)
    return {k: (len(g), int(np.median(g))) for k, g in weights.items()}


def z_score(m, n, gap, theta: float):
    """Closed-form pairwise-base Z-score between two segments of lengths
    m and n separated by `gap` bases: sum over base pairs of
    (1-theta)^distance (reference: calculateZScore, matchingAndOrdering
    submodule; buildReference.c:296-306 applies event weights on top).
    Vectorizes over numpy arrays m, n, gap.
    """
    if theta <= 0.0:
        return np.asarray(m, np.float64) * np.asarray(n, np.float64)
    beta = 1.0 - theta
    m = np.asarray(m, np.float64)
    n = np.asarray(n, np.float64)
    gap = np.asarray(gap, np.float64)
    return ((1.0 - beta ** m) / theta) * (beta ** gap) \
        * ((1.0 - beta ** n) / theta)


def event_weighting(tree: Tree, phi: float) -> dict[str, float]:
    """Phylogenetic event weights for Z-scores (getEventWeighting,
    buildReference.c:256-282): for leaf event A with path branches b_i
    of length d_i from the reference event R, multiplicity s(b_i) =
    number of leaf paths through b_i, weight =
    exp(-phi * sum d_i) * (sum d_i/s_i) / (sum d_i).
    The tree is rooted at the reference (ancestor) event.
    """
    weights: dict[str, float] = {}
    # multiplicity of each branch (node→parent) = leaves under the node
    mult: dict[str, int] = {}

    def count(node) -> int:
        if node.is_leaf():
            mult[node.name] = 1
            return 1
        c = sum(count(ch) for ch in node.children)
        mult[node.name] = c
        return c

    count(tree)

    def walk(node, path_len: float, adj_len: float):
        if node.is_leaf():
            w = float(np.exp(-phi * path_len))
            if path_len > 0:
                w *= adj_len / path_len
            weights[node.name] = w
            return
        for ch in node.children:
            d = ch.length or 0.0
            walk(ch, path_len + d, adj_len + d / max(mult[ch.name], 1))

    walk(tree, 0.0, 0.0)
    return weights


def build_chain_units(caf: CafResult):
    """Chain units: maximal runs of live blocks joined by UNAMBIGUOUS
    direct adjacencies — end pairs (u, v) where every live thread
    leaving u enters v and vice versa.  These are the flat-model analog
    of the reference's chain nodes (getChainNodes,
    buildReference.c:413-476): a chain enters the matching as ONE node
    spanning its two outer ends, because its internal order is already
    proven by every thread.  Matching individual block ends instead
    would let the m*n term of the Z-score rip proven-adjacent blocks
    apart (big-block pairings outscore in-order pairings when theta
    decay is negligible at the flower's scale).

    Returns (units, unit_of, orient_in): units = [[(block, orient)],
    ...]; unit_of / orient_in map each block to its unit id and its
    orientation within the unit (-1 / 0 for dead blocks).
    """
    live = [int(b) for b in np.flatnonzero(caf.alive)]
    # chain links are proven by INGROUP threads; og wobble must not
    # veto them (see _end_adjacency_weights docstring)
    weights = _end_adjacency_weights(caf, ingroup_only=True)
    partners: dict[int, set[int]] = {}
    for (u, v) in weights:
        partners.setdefault(u, set()).add(v)
        partners.setdefault(v, set()).add(u)
    links: dict[int, int] = {}
    parent = {b: b for b in live}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (u, v), (_s, _g) in sorted(weights.items(),
                                   key=lambda kv: (-kv[1][0], kv[0])):
        if u // 2 == v // 2:
            continue
        if partners.get(u) != {v} or partners.get(v) != {u}:
            continue
        ru, rv = find(u // 2), find(v // 2)
        if ru == rv:
            continue  # circular chain: leave one link open
        links[u] = v
        links[v] = u
        parent[ru] = rv
    # second pass: MUTUAL-BEST links for ends unanimity left unlinked.
    # A single ingroup thread's indel at a wobble boundary (thread A
    # goes b1→b2, thread B skips to b3) breaks strict unanimity at
    # every fragment boundary of an og-pinched graph; the reference's
    # cactus chains still link b1—b2—b3 (the skipping thread rides the
    # link's adjacency component, pinchToCactus.c).  Best = highest
    # support, then SMALLEST median gap (the immediate neighbor beats
    # the skip target at equal support).  Restricted to single-copy
    # blocks — any block carrying two segments of one event is a
    # duplication candidate whose continuations must stay strict.
    seg_live = caf.alive[caf.blocks.seg_block]
    ev_idx = {}
    for n in set(caf.events_of_seq):
        ev_idx.setdefault(n, len(ev_idx))
    ev_of_seg = np.array([ev_idx[caf.events_of_seq[s]]
                          for s in caf.blocks.seg_seq])
    # dup guard counts INGROUP copies only: overlapping trimmed og
    # fragments routinely put two og segments of one event in a block,
    # and og copy count says nothing about ancestor ordering
    ing_seg = np.array([caf.events_of_seq[s] not in caf.outgroup_events
                        for s in caf.blocks.seg_seq])
    key = (caf.blocks.seg_block.astype(np.int64) * len(ev_idx)
           + ev_of_seg)[seg_live & ing_seg]
    _u, cnt = np.unique(key, return_counts=True)
    multi = np.zeros(caf.blocks.n_blocks, dtype=bool)
    multi[(_u[cnt > 1] // len(ev_idx)).astype(np.int64)] = True

    def mutual_best_pass(w):
        part: dict[int, set[int]] = {}
        for (u, v) in w:
            part.setdefault(u, set()).add(v)
            part.setdefault(v, set()).add(u)
        best: dict[int, int] = {}
        for e, ps in part.items():
            if e in links or multi[e // 2]:
                continue
            cand = []
            for p in ps:
                k = (e, p) if e <= p else (p, e)
                s, g = w[k]
                cand.append((-s, g, p))
            cand.sort()
            if cand and not multi[cand[0][2] // 2]:
                best[e] = cand[0][2]
        pairs = sorted((min(u, v), max(u, v)) for u, v in best.items()
                       if best.get(v) == u and u // 2 != v // 2)
        for u, v in pairs:
            if u in links or v in links:
                continue
            ru, rv = find(u // 2), find(v // 2)
            if ru == rv:
                continue
            links[u] = v
            links[v] = u
            parent[ru] = rv

    mutual_best_pass(weights)
    if caf.outgroup_events:
        # third pass: boundaries only an OUTGROUP thread crosses (no
        # shared ingroup thread between two og-witnessed fragments) —
        # the og genome's own contiguity is real adjacency evidence,
        # exactly as its thread is in the reference's cactus graph
        mutual_best_pass(_end_adjacency_weights(caf))
    units = walk_threads(live, links)
    n_blocks = caf.blocks.n_blocks
    unit_of = np.full(n_blocks, -1, dtype=np.int64)
    orient_in = np.zeros(n_blocks, dtype=np.int64)
    for ui, unit in enumerate(units):
        for b, o in unit:
            unit_of[b] = ui
            orient_in[b] = o
    return units, unit_of, orient_in


def calculate_z(caf: CafResult, cfg: ReferenceParams,
                ev_weights: dict[str, float] | None = None,
                decay_floor: float = 1e-10,
                pair_budget: int = 2_000_000,
                units: tuple[np.ndarray, np.ndarray] | None = None):
    """Z-scores between live block ends via per-thread segment walks
    (calculateZ, buildReference.c:313-392): for segments i and i+k on a
    thread, the exit end of i and entry end of i+k accumulate
    w_event * z_score(len_i, len_{i+k}, gap).  With ignoreUnalignedGaps
    the gap counts only ALIGNED bases between them (the reference
    subtracts unaligned adjacency bases, :348-358); the walk stops when
    the pure decay term drops below 1e-10, and at maxWalkForCalculatingZ
    segments.  Fully vectorized: per-k numpy passes, one
    unique-and-reduce at the end.

    pair_budget bounds memory on huge flat threads (the reference runs
    per nested flower where node counts are small; our flat model can
    see thousands of segments per thread): threads whose full walk would
    exceed the budget get their walk depth capped, with a warning.

    With `units` = (unit_of, orient_in) from build_chain_units, runs of
    consecutive same-unit segments on a thread are merged and the walk
    happens over UNIT ends — the reference's semantics, where a thread
    at a flower traverses a whole chain as one segment and Z accrues to
    the chain node's outer ends.

    Returns dict {(end_u, end_v) canonical: z} — block ends, or unit
    ends when `units` is given.
    """
    blocks = caf.blocks
    table = caf.table
    theta = cfg.theta
    live_seg = caf.alive[blocks.seg_block]
    order = np.lexsort((blocks.seg_start, blocks.seg_seq))
    order = order[live_seg[order]]
    sseq = blocks.seg_seq[order]
    beta = 1.0 - theta if theta > 0 else 1.0
    keys_l: list[np.ndarray] = []
    vals_l: list[np.ndarray] = []
    for si in np.unique(sseq):
        sel = order[sseq == si]
        if len(sel) < 2:
            continue
        ev = event_of(table.names[int(si)])
        w_ev = 1.0 if ev_weights is None else ev_weights.get(ev, 0.0)
        if w_ev <= 0.0:
            continue
        blk = blocks.seg_block[sel].astype(np.int64)
        strand = blocks.seg_strand[sel]
        start = blocks.seg_start[sel]
        length = blocks.seg_len[sel]
        end_pos = start + length
        if units is not None:
            unit_of, orient_in = units
            node = unit_of[blk]
            ndir = strand * orient_in[blk]
            cut = np.flatnonzero((node[1:] != node[:-1])
                                 | (ndir[1:] != ndir[:-1])) + 1
            first = np.concatenate([[0], cut])
            last = np.concatenate([cut - 1, [len(blk) - 1]])
            cl = np.concatenate([[0], np.cumsum(length)])
            length = cl[last + 1] - cl[first]
            start = start[first]
            end_pos = end_pos[last]
            node = node[first]
            ndir = ndir[first]
        else:
            node = blk
            ndir = strand
        entry = 2 * node + np.where(ndir == 1, 0, 1)
        exit_ = 2 * node + np.where(ndir == 1, 1, 0)
        clen = np.concatenate([[0], np.cumsum(length)])
        n = len(node)
        if n < 2:
            continue
        max_k = min(cfg.max_walk_for_calculating_z, n)
        if n * max_k > pair_budget:
            capped = max(1, pair_budget // n)
            import warnings
            warnings.warn(
                f"calculate_z: thread {table.names[int(si)]} has {n} "
                f"segments; capping Z walk at {capped} (< {max_k}) to "
                f"bound memory", RuntimeWarning)
            max_k = capped
        for k in range(1, max_k):
            i = np.arange(n - k)
            if cfg.ignore_unaligned_gaps:
                # aligned bases between the two segments + 1
                gap = 1 + (clen[i + k] - clen[i + 1])
            else:
                gap = start[i + k] - end_pos[i] + 1
            decay = beta ** gap.astype(np.float64) if theta > 0 else \
                np.ones(len(i))
            ok = decay >= decay_floor
            if not ok.any():
                break
            zz = w_ev * z_score(length[i], length[i + k], gap, theta)
            u = exit_[i][ok]
            v = entry[i + k][ok]
            lo = np.minimum(u, v)
            hi = np.maximum(u, v)
            keys_l.append(lo << 32 | hi)
            vals_l.append(zz[ok])
    if not keys_l:
        return {}
    keys = np.concatenate(keys_l)
    vals = np.concatenate(vals_l)
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=vals)
    return {(int(kk) >> 32, int(kk) & 0xFFFFFFFF): float(s)
            for kk, s in zip(uniq, sums)}


def match_ends(live: list[int], weights: dict[tuple[int, int], float],
               algorithm: str = "greedy") -> dict[int, int]:
    """Acyclic end matching over the Z-score graph.

    greedy: best-weight-first with union-find cycle rejection
    (makeReferenceGreedily2 spirit).  maxWeight/blossom5: exact
    max-weight matching (networkx's blossom, vendored in
    utils/matching.py — the blossom5/maxWeight
    options of buildReference.c's matchingAlgorithm), then cycles in
    the induced block graph are broken at their weakest edge.
    maxCardinality: blossom with maxcardinality=True.
    Returns {end: partner_end} (symmetric).
    """
    alive_set = set(live)
    edges = [(u, v, w) for (u, v), w in weights.items()
             if u // 2 != v // 2 and u // 2 in alive_set
             and v // 2 in alive_set and w > 0]
    matched: dict[int, int] = {}
    if algorithm in ("blossom5", "maxWeight", "maxCardinality"):
        # max-weight matching decomposes EXACTLY over connected
        # components; the blossom code is pure-Python superlinear, so
        # run it per component (cheap on the local component sizes this
        # graph produces) and only degrade a component to greedy past a
        # size cap
        from ..utils.matching import Graph, max_weight_matching
        # partition edges by connected component (union-find) and run
        # blossom per REAL per-component Graph: matching decomposes
        # exactly across components, and fragmented graphs avoid one
        # big superlinear pure-Python blossom call
        uf: dict[int, int] = {}

        def find(x: int) -> int:
            r = x
            while uf.setdefault(r, r) != r:
                r = uf[r]
            while uf[x] != r:
                uf[x], x = r, uf[x]
            return r

        for u, v, _w in edges:
            uf[find(u)] = find(v)
        comp_edges: dict[int, list] = {}
        for u, v, w in edges:
            comp_edges.setdefault(find(u), []).append((u, v, w))
        mate = set()
        greedy_comps = 0
        for ce in comp_edges.values():
            if len(ce) == 1:
                u, v, _w = ce[0]
                mate.add((min(u, v), max(u, v)))
                continue
            import os
            cap = int(os.environ.get("CACTUS_MATCH_EDGE_CAP", "50000"))
            if len(ce) > cap:
                # oversized component: degrade to greedy, loudly
                greedy_comps += 1
                used: set[int] = set()
                for u, v, w in sorted(ce, key=lambda e: -e[2]):
                    if u not in used and v not in used:
                        used.update((u, v))
                        mate.add((min(u, v), max(u, v)))
                continue
            sub = Graph()
            sub.add_weighted_edges_from(ce)
            mate.update(max_weight_matching(
                sub, maxcardinality=(algorithm == "maxCardinality")))
        if greedy_comps:
            import warnings
            warnings.warn(f"match_ends: {greedy_comps} oversized "
                          f"component(s) matched greedily instead of "
                          f"{algorithm}", RuntimeWarning)
        pairs = sorted((min(u, v), max(u, v)) for u, v in mate)
        # break cycles: add matched edges best-first, reject closures
        pairs.sort(key=lambda uv: -weights[uv])
    elif algorithm == "greedy":
        pairs = [uv for uv, _w in sorted(weights.items(),
                                         key=lambda kv: (-kv[1], kv[0]))
                 if uv[0] // 2 != uv[1] // 2]
    else:
        raise NotImplementedError(
            f"matching_algorithm {algorithm!r}; supported: greedy, "
            f"maxWeight, blossom5, maxCardinality")

    parent: dict[int, int] = {b: b for b in live}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in pairs:
        bu, bv = u // 2, v // 2
        if bu == bv or u in matched or v in matched:
            continue
        if bu not in parent or bv not in parent:
            continue
        ru, rv = find(bu), find(bv)
        if ru == rv:
            continue  # would close a cycle
        matched[u] = v
        matched[v] = u
        parent[ru] = rv
    return matched


def walk_threads(live: list[int], matched: dict[int, int]):
    """Path walk of the matched end graph → [(block, orient)] threads."""
    threads = []
    seen: set[int] = set()
    for b in live:
        for start_end in (2 * b, 2 * b + 1):
            if b in seen or start_end in matched:
                continue
            thread = []
            cur_b = b
            entry = start_end
            while True:
                seen.add(cur_b)
                orient = 1 if entry == 2 * cur_b else -1
                thread.append((cur_b, orient))
                exit_end = 2 * cur_b + (1 if orient == 1 else 0)
                nxt = matched.get(exit_end)
                if nxt is None:
                    break
                cur_b = nxt // 2
                entry = nxt
            threads.append(thread)
            break
    for b in live:
        if b not in seen:
            threads.append([(b, 1)])
            seen.add(b)
    return threads


def _adj_weight(z: dict, u: int, v: int) -> float:
    return z.get((u, v) if u <= v else (v, u), 0.0)


def insert_stranded_threads(threads, z: dict, max_passes: int = 256,
                            theta: float = 1e-6,
                            ulen: dict | None = None):
    """Splice stranded threads into longer threads at their best
    Z-supported interior position (the reference never leaves a chain
    unplaced: makeReferenceGreedily2/updateReferenceGreedily insert
    every chain into the growing reference order,
    buildReference.c:1285-1332).

    A pure end-matching fragments the order whenever sub-paths
    interleave: with pinched outgroups the mr ancestor came out as 90
    threads whose terminal ends had Z edges ONLY to interior ends of
    other threads (measured: 180 terminal ends, 178 with Z>0 edges, 0
    to another terminal end) — og-witnessed single-clade runs alternate
    with shared runs, and the matching builds one path per run.  The
    fragmented ancestor then collapses the next level's blast
    (human-mouse recall 0.95 -> 0.10).  Insertion repairs this: splice
    thread T between consecutive units (A, B) of a longer thread where
    z(A, T_head) + z(T_tail, B) - z(A, B) is maximal and positive,
    trying both orientations of T.  Genuinely unrelated threads (no
    positive interior support — e.g. different chromosomes) stay
    separate.
    """
    threads = [list(t) for t in threads]
    incident: dict[int, list[tuple[int, float]]] = {}
    for (u, v), w in z.items():
        if w > 0:
            incident.setdefault(u, []).append((v, w))
            incident.setdefault(v, []).append((u, w))

    def entry_end(item):
        b, o = item
        return 2 * b + (0 if o == 1 else 1)

    def exit_end(item):
        b, o = item
        return 2 * b + (1 if o == 1 else 0)

    import math

    def decay(tt) -> float:
        """(1-theta)^(base length of tt): the surviving fraction of a
        bridged adjacency's Z after inserting tt between its ends."""
        if ulen is None:
            return 0.0      # unknown lengths: fall back to full charge
        L = sum(ulen.get(b, 0) for b, _o in tt)
        return math.exp(L * math.log1p(-theta)) if theta > 0 else 1.0

    for _pass in range(max_passes):
        if len(threads) <= 1:
            break
        pos_of: dict[int, tuple[int, int]] = {}
        for ti, t in enumerate(threads):
            for pi, (b, _o) in enumerate(t):
                pos_of[b] = (ti, pi)
        lens = [len(t) for t in threads]

        plans = []   # (gain, ti, target unit, oriented unit list)
        for ti, t in enumerate(threads):
            if not t:
                continue
            best = None
            for tt in (t, [(b, -o) for b, o in reversed(t)]):
                head = entry_end(tt[0])
                tail = exit_end(tt[-1])
                # candidates from BOTH of T's outward ends: an edge off
                # the head anchors T after its partner unit; an edge off
                # the tail anchors T before its partner (i.e. after that
                # unit's predecessor — covers prepend via opi == -1...
                # skipped: order needs an anchor unit, retry reversed)
                cand_pos: dict[tuple[int, int], float] = {}
                for other, w in incident.get(head, ()):
                    ob = other // 2
                    if ob not in pos_of:
                        continue
                    oti, opi = pos_of[ob]
                    if other == exit_end(threads[oti][opi]):
                        cand_pos[(oti, opi)] = max(
                            cand_pos.get((oti, opi), 0.0), w)
                for other, w in incident.get(tail, ()):
                    ob = other // 2
                    if ob not in pos_of:
                        continue
                    oti, opi = pos_of[ob]
                    if other == entry_end(threads[oti][opi]) and opi > 0:
                        cand_pos.setdefault((oti, opi - 1), 0.0)
                for (oti, opi), _w0 in cand_pos.items():
                    if oti == ti:
                        continue
                    # (no length restriction: mutual-splice cycles are
                    # prevented at apply time — a moving thread is never
                    # a target in the same pass, and each pass strictly
                    # reduces the thread count)
                    anchor = threads[oti][opi]
                    head_w = _adj_weight(z, exit_end(anchor), head)
                    nxt_w = old_w = 0.0
                    if opi + 1 < len(threads[oti]):
                        nx_entry = entry_end(threads[oti][opi + 1])
                        nxt_w = _adj_weight(z, tail, nx_entry)
                        old_w = _adj_weight(z, exit_end(anchor), nx_entry)
                    # inserting T between (A, B) does NOT discard
                    # z(A, B): the reference objective scores every pair
                    # by (1-theta)^distance (buildReference.c Z-score
                    # doc comment), so the old adjacency only DECAYS by
                    # T's base length — an adjacent-only gain model
                    # would charge the full 2.7e6 weight of a hot
                    # junction and never splice anything (measured)
                    loss = old_w * (1.0 - decay(tt))
                    gain = head_w + nxt_w - loss
                    if gain > 1e-12 and (best is None or gain > best[0]):
                        best = (gain, oti, anchor[0], list(tt))
            if best is not None:
                plans.append((best[0], ti, best[1], best[2], best[3]))
        if not plans:
            break
        # apply best-gain-first; at most one splice per anchor unit, and
        # a thread may not move if it is (a) already moving or (b) the
        # TARGET of an accepted splice this pass — emptying a target
        # thread would silently drop the units just spliced into it
        # (measured: cow-dog recall 0.98 -> 0.26 from exactly that)
        plans.sort(key=lambda p: -p[0])
        total0 = sum(len(t) for t in threads)
        taken: set[int] = set()
        moving: set[int] = set()
        targeted: set[int] = set()
        after: dict[int, list] = {}
        for _gain, ti, oti, ob, units in plans:
            if (ti in moving or ti in targeted or oti in moving
                    or ob in taken):
                continue
            moving.add(ti)
            targeted.add(oti)
            taken.add(ob)
            after[ob] = units
            threads[ti] = []
        if not after:
            break
        new_threads = []
        for t in threads:
            if not t:
                continue
            nt = []
            for item in t:
                nt.append(item)
                nt.extend(after.get(item[0], ()))
            new_threads.append(nt)
        # splices must conserve units exactly (a lost unit = lost
        # ancestor blocks = silently lost homology downstream)
        assert sum(len(t) for t in new_threads) == total0, \
            "splice dropped units"
        threads = new_threads
    return threads


def nudge_threads(threads, z: dict, permutations: int):
    """Permutation nudges (updateReferenceGreedily/nudgeGreedily,
    buildReference.c:1157-1171): repeatedly try relocating single blocks
    to better insertion points; keep a move when it raises the summed
    adjacency Z.  Candidate insertion points come from Z edges incident
    to the moved block's ends (everything else scores zero).
    """
    if permutations <= 0 or sum(len(t) for t in threads) < 2:
        return threads
    threads = [list(t) for t in threads]
    incident: dict[int, list[tuple[int, float]]] = {}
    for (u, v), w in z.items():
        if w > 0:
            incident.setdefault(u, []).append((v, w))
            incident.setdefault(v, []).append((u, w))
    for _round in range(permutations):
        improved = False
        pos_of: dict[int, tuple[int, int]] = {}
        for ti, t in enumerate(threads):
            for pi, (b, _o) in enumerate(t):
                pos_of[b] = (ti, pi)

        def ends_at(ti, pi):
            b, o = threads[ti][pi]
            entry = 2 * b + (0 if o == 1 else 1)
            exit_ = 2 * b + (1 if o == 1 else 0)
            return entry, exit_

        for b in sorted(pos_of):
            ti, pi = pos_of[b]
            t = threads[ti]
            if len(t) == 1:
                continue
            entry, exit_ = ends_at(ti, pi)
            left_w = _adj_weight(z, ends_at(ti, pi - 1)[1], entry) \
                if pi > 0 else 0.0
            right_w = _adj_weight(z, exit_, ends_at(ti, pi + 1)[0]) \
                if pi + 1 < len(t) else 0.0
            join_w = 0.0
            if 0 < pi < len(t) - 1:
                join_w = _adj_weight(z, ends_at(ti, pi - 1)[1],
                                     ends_at(ti, pi + 1)[0])
            remove_gain = join_w - left_w - right_w
            # candidate insertions: after any block whose exit end shares
            # a Z edge with one of b's ends (other spots add zero weight)
            best = None
            for e_b in (2 * b, 2 * b + 1):
                for other, w in incident.get(e_b, ()):
                    ob = other // 2
                    if ob == b or ob not in pos_of:
                        continue
                    oti, opi = pos_of[ob]
                    if oti == ti and opi in (pi - 1, pi):
                        continue  # no-op move
                    _o_entry, o_exit = ends_at(oti, opi)
                    if other != o_exit:
                        continue
                    # insert b after (oti, opi) with e_b facing `other`
                    orient = 1 if e_b == 2 * b else -1
                    b_exit = 2 * b + (1 if orient == 1 else 0)
                    nxt_w = 0.0
                    old_w = 0.0
                    if opi + 1 < len(threads[oti]):
                        nx_entry = ends_at(oti, opi + 1)[0]
                        nxt_w = _adj_weight(z, b_exit, nx_entry)
                        old_w = _adj_weight(z, o_exit, nx_entry)
                    gain = w + nxt_w - old_w + remove_gain
                    if gain > 1e-12 and (best is None or gain > best[0]):
                        best = (gain, oti, opi, orient)
            if best is not None:
                _gain, oti, opi, orient = best
                item = (b, orient)
                del threads[ti][pi]
                if oti == ti and opi > pi:
                    opi -= 1
                threads[oti].insert(opi + 1, item)
                threads = [t for t in threads if t]
                improved = True
                break   # positions stale: restart the round
        if not improved:
            break
    return threads


def order_blocks(caf: CafResult, cfg: ReferenceParams,
                 tree: Tree | None = None):
    """Block ordering: Z-scores → matching → threads → nudges
    (buildReferenceTopDown steps 2-5, buildReference.c:1007-1171).
    Returns list of threads: [(block, orient)] with orient +1 = block
    columns forward (enter left end).
    """
    live = [int(b) for b in np.flatnonzero(caf.alive)]
    if not live:
        return []
    units, unit_of, orient_in = build_chain_units(caf)
    ev_w = event_weighting(tree, cfg.phi) if tree is not None else None
    z = calculate_z(caf, cfg, ev_w, units=(unit_of, orient_in))
    live_units = list(range(len(units)))
    matched = match_ends(live_units, z, cfg.matching_algorithm)
    uthreads = walk_threads(live_units, matched)
    blen = caf.blocks.block_length()
    ulen = {ui: int(sum(blen[b] for b, _o in unit))
            for ui, unit in enumerate(units)}
    import os as _os
    if _os.environ.get("CACTUS_INSERT_STRANDED", "1") == "1":
        uthreads = insert_stranded_threads(uthreads, z, theta=cfg.theta,
                                           ulen=ulen)
    uthreads = nudge_threads(uthreads, z, cfg.permutations)
    threads = []
    for ut in uthreads:
        t = []
        for ui, uo in ut:
            unit = units[ui]
            if uo == 1:
                t.extend(unit)
            else:
                t.extend((b, -o) for b, o in reversed(unit))
        threads.append(t)
    return threads


def run_reference(caf: CafResult, gcodes: np.ndarray, tree: Tree,
                  ancestor_event: str, cfg: ReferenceParams,
                  scaffold_gap_threshold: int = 1,
                  og_records=None,
                  og_codes: dict[str, np.ndarray] | None = None,
                  device=None) -> ReferenceResult:
    """Build the ancestral genome for `ancestor_event`.

    tree: the event tree rooted at the ancestor (leaves = child events
    and outgroups present in the alignment).  og_records/og_codes carry
    outgroup alignments as overlay evidence (votes on existing columns;
    see overlay_outgroup_observations).  Large Felsenstein windows run
    on `device` (None = the current CUDA device).
    """
    event_names = [n.name for n in tree.preorder()]
    lens = caf.blocks.block_length()
    live = np.flatnonzero(caf.alive)
    live_lens = lens[live].astype(np.int64)
    goffs = np.concatenate([[0], np.cumsum(live_lens)])
    total_cols = int(goffs[-1])
    col_off = {int(b): int(o) for b, o in zip(live, goffs[:-1])}

    # STREAMED ancestral reconstruction: the observation tensor and its
    # per-base expansion are built per column window (~bounded MB), not
    # for the whole genome at once — the reference-phase RSS spike at
    # scale (measured +3 GB at a 20 Mb pair, extrapolating >100 GB at
    # 1 Gb) becomes O(window).  The og overlay votes are materialized
    # once as sorted (row, event, base) arrays and applied per window.
    if og_records:
        v_rows, v_evs, v_bases = overlay_vote_arrays(
            caf, col_off, og_records, og_codes or {}, event_names)
    else:
        v_rows = np.zeros(0, np.int64)
        v_evs = v_bases = np.zeros(0, np.int32)
    root_codes = np.empty(total_cols, dtype=np.uint8)
    target_cols = max(1, int(cfg.felsenstein_window_columns))
    i0 = 0
    while i0 < len(live):
        i1 = int(np.searchsorted(goffs, goffs[i0] + target_cols,
                                 side="left"))
        i1 = max(i1, i0 + 1)
        lo, hi = int(goffs[i0]), int(goffs[min(i1, len(live))])
        obs, counts, _bi, _co = block_observations(
            caf, gcodes, event_names, live_slice=(i0, i1), col_base=lo)
        if len(v_rows):
            a = np.searchsorted(v_rows, lo, side="left")
            z = np.searchsorted(v_rows, hi, side="left")
            if z > a:
                rows_l = v_rows[a:z] - lo
                # multiply.at accumulates over duplicate (row, event)
                # indices — a column voted by k og records must be
                # scaled k times (fancy `*=` applies only once)
                np.multiply.at(obs, (rows_l, v_evs[a:z]),
                               np.float32(1e-3))
                np.multiply.at(obs, (rows_l, v_evs[a:z], v_bases[a:z]),
                               np.float32(1e3))
        if len(obs):
            root_codes[lo:hi] = felsenstein_ml(obs, counts, tree,
                                               event_names, device=device)
        i0 = i1

    block_codes = {}
    for b, o in col_off.items():
        block_codes[b] = root_codes[o:o + int(lens[b])]

    threads = order_blocks(caf, cfg, tree)
    weights = _end_adjacency_weights(caf)

    # break adjacencies lacking direct sequence support (buildReference.c
    # step 6: minNumberOfSequencesToSupportAdjacency; top-level flowers
    # always allow breaks) — unless scaffolding bridges them
    if cfg.min_sequences_to_support_adjacency > 0 and not cfg.make_scaffolds:
        broken = []
        for thread in threads:
            cur = [thread[0]]
            for prev, item in zip(thread, thread[1:]):
                key = _thread_adj_key(prev, item)
                support, _g = weights.get(key, (0, 0))
                if support < cfg.min_sequences_to_support_adjacency:
                    broken.append(cur)
                    cur = []
                cur.append(item)
            broken.append(cur)
        threads = broken

    sequences: dict[str, Sequence] = {}
    block_coord: dict[int, tuple[str, int, int]] = {}
    for ti, thread in enumerate(threads):
        name = f"{ancestor_event}.seq{ti}"
        parts = []
        pos = 0
        prev = None
        for b, orient in thread:
            codes = block_codes[b]
            if orient == -1:
                codes = complement(codes)[::-1]
            if prev is not None and cfg.make_scaffolds:
                key = _thread_adj_key(prev, (b, orient))
                support, gap_med = weights.get(key, (0, 0))
                if support < cfg.min_sequences_to_support_adjacency:
                    # indirect (Z-walk) adjacency: scaffold join of
                    # numberOfNs (step 7, getReferenceIntervalsToPreserve)
                    parts.append(np.full(cfg.number_of_ns, N_CODE,
                                         dtype=np.uint8))
                    pos += cfg.number_of_ns
                elif gap_med >= scaffold_gap_threshold:
                    # scaffold Ns only where child threads imply missing
                    # bases between the blocks (median adjacency gap);
                    # gap-sized Ns capped at numberOfNs: the full run
                    # would pepper the ancestor with seed-killing N
                    # islands at every 1-2bp indel
                    n_ns = min(int(gap_med), cfg.number_of_ns)
                    parts.append(np.full(n_ns, N_CODE, dtype=np.uint8))
                    pos += n_ns
            block_coord[b] = (name, pos, orient)
            parts.append(codes.astype(np.uint8))
            pos += len(codes)
            prev = (b, orient)
        sequences[name] = Sequence(name=name, codes=np.concatenate(parts)
                                   if parts else np.zeros(0, np.uint8))
    return ReferenceResult(event=ancestor_event, threads=threads,
                           block_codes=block_codes, block_coord=block_coord,
                           sequences=sequences)


def _thread_adj_key(prev, cur):
    (pb, po), (cb, co) = prev, cur
    pe = 2 * pb + (1 if po == 1 else 0)
    ce = 2 * cb + (0 if co == 1 else 1)
    return (pe, ce) if pe <= ce else (ce, pe)
