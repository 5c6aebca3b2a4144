"""Blast phase: all-pairs pairwise anchoring → PAF (lastz+paffy equivalent).

Pipeline per (query contig, target contig), both strands (reference flow:
src/cactus/paf/local_alignment.py:370-408 make_chunked_alignments and
:660-727 chain/tile/filter):

  1. k-mer seed join on the host (ops/seeds_host.py), or batched on the
     card for chunk pairs past SeedParams.device_join_threshold
     (ops/seeds.py)
  2. merge seed hits into diagonal runs (host)
  3. collinear chaining with affine gap costs (ops/chain.py, native C++)
  4. gap-fill between chained runs with the banded DP kernel
     (ops/banded.py, the CUDA kernel on a GPU) → full base-level cigars
  5. emit PafRecords; primary/secondary selection by query coverage
     (tp:A:P / tp:A:S as in paffy; local_alignment.py:133-143 consumes them)

Functions that join seeds or fill gaps take `device` (None = the current
CUDA device, see ops.resolve_device).  `run_tasks(mesh=...)` shards the
chunk-pair seed joins over a parallel/mesh.py mesh of devices and
processes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import BlastParams, PoaParams
from ..io.fasta import Sequence, revcomp
from ..io.paf import PafRecord, merge_cigar
from ..ops import seeds as seed_ops
from ..ops import chain as chain_ops
from ..ops.banded import (GapParams, align_pairs_banded, score_matrix_6)


def _pad_pow2(codes: np.ndarray, min_len: int = 256) -> np.ndarray:
    n = max(min_len, 1 << (max(1, len(codes)) - 1).bit_length())
    if n == len(codes):
        return codes
    out = np.full(n, 4, dtype=np.uint8)  # N pad → invalid seeds
    out[:len(codes)] = codes
    return out


@dataclass
class _PendingGap:
    """A gap between chained runs awaiting banded alignment."""
    task: int          # index into the task list (0 for single-pair use)
    chain_id: int
    slot: int          # position in the chain's op layout
    q0: int
    q1: int
    t0: int
    t1: int


def _fill_gaps_banded(gaps, qcodes, tcodes, submat, gap_params,
                      device=None):
    """Batch-align all pending gaps, binned by band requirement.

    `qcodes`/`tcodes` may be single arrays (all gaps on one pair) or
    lists indexed by `g.task` for a cross-task global batch."""
    results = {}
    by_band: dict[int, list] = {}
    for g in gaps:
        span = abs((g.t1 - g.t0) - (g.q1 - g.q0))
        band = 128
        while band <= span + 16:
            band *= 2
        by_band.setdefault(band, []).append(g)
    multi = isinstance(qcodes, list)
    for band, group in by_band.items():
        if multi:
            pairs = [(qcodes[g.task][g.q0:g.q1], tcodes[g.task][g.t0:g.t1])
                     for g in group]
        else:
            pairs = [(qcodes[g.q0:g.q1], tcodes[g.t0:g.t1]) for g in group]
        out = align_pairs_banded(pairs, submat, gap_params, band=band,
                                 device=device)
        for g, (score, ops) in zip(group, out):
            results[(g.task, g.chain_id, g.slot)] = (ops, int(score))
    return results


def _extract_trimmed(runs, order, scores, preds, min_score: int):
    """Chains (descending score) with overlap-trimmed runs, as flat
    arrays: (runs_flat (R,3) int64, chain_off (C+1,), chain_scores (C,)).
    Native C++ fused extract+trim; python fallback."""
    from ..native import build as native
    res = native.dp_chain_extract(runs[order], scores, preds, min_score)
    if res is not None:
        return res
    chains = chain_ops.extract_chains(runs, order, scores, preds,
                                      min_score=min_score)
    flat, off, cs = [], [0], []
    for ch in chains:
        t = chain_ops.trim_chain_overlaps(ch["runs"])
        if len(t) == 0:
            continue
        flat.append(t)
        off.append(off[-1] + len(t))
        cs.append(ch["score"])
    runs_flat = (np.concatenate(flat) if flat
                 else np.zeros((0, 3), np.int64))
    return runs_flat, np.asarray(off, np.int64), np.asarray(cs, np.int32)


def _layout_one(runs, cid: int, task: int, max_fill: int,
                pending: list[_PendingGap]):
    """Layout for one chain's (already overlap-trimmed) runs."""
    layout = []       # ("run", qs, ts, ln) | ("gap", slot) | ("split",)
    slot = 0
    prev = None
    for qs, ts, ln in runs:
        if prev is not None:
            pqe, pte = prev
            qg, tg = qs - pqe, ts - pte
            if qg > max_fill or tg > max_fill:
                layout.append(("split",))
            elif qg == 0 and tg == 0:
                pass
            elif qg == 0:
                layout.append(("ops", [("D", int(tg))]))
            elif tg == 0:
                layout.append(("ops", [("I", int(qg))]))
            elif min(qg, tg) * 16 < max(qg, tg) and max(qg, tg) > 1024:
                # grossly asymmetric gap: banding would cost a band
                # the size of the indel for a near-pure I+D — emit it
                # directly and let BAR refine the flanks
                layout.append(("ops", [("I", int(qg)),
                                       ("D", int(tg))]))
            else:
                layout.append(("gap", slot))
                pending.append(_PendingGap(task, cid, slot,
                                           int(pqe), int(qs),
                                           int(pte), int(ts)))
                slot += 1
        layout.append(("run", int(qs), int(ts), int(ln)))
        prev = (qs + ln, ts + ln)
    return layout


def _chain_layouts(chains, cfg: BlastParams, task: int = 0,
                   max_fill: int = 8192):
    """Pass 1 of chains→records: op layouts + pending gap list."""
    pending: list[_PendingGap] = []
    layouts = []  # per chain: list of ops or placeholders ("gap", slot)
    for cid, ch in enumerate(chains):
        runs = chain_ops.trim_chain_overlaps(ch["runs"])
        if len(runs) == 0:
            layouts.append(None)
            continue
        layouts.append(_layout_one(runs, cid, task, max_fill, pending))
    return layouts, pending


def _emit_records(layouts, filled, qcodes, tcodes, qname, tname, qlen_full,
                  tlen, strand, cfg: BlastParams, submat, task: int = 0,
                  cids=None, keyed: bool = False):
    """Pass 2 of chains→records: assemble cigars + score + emit PAF.

    Scoring is ONE vectorized pass over all candidate records: every M
    run of every record lands in global index arrays, substitution
    scores and match counts come from a single gather + reduceat — no
    per-record numpy slicing (the 40k-call hot spot at genome scale).

    `cids` overrides each layout's chain id (for sparse layout lists);
    `keyed=True` returns ((chain_rank, seg_idx), record) pairs so the
    caller can interleave with the vectorized single-run path in the
    original descending-chain-score order.
    """
    gap_params = GapParams(cfg.extend.gap_open, cfg.extend.gap_extend)
    cands = []                     # (ops, q0, t0, q1, t1, gap_cost)
    cand_keys = []                 # (chain_rank, seg_idx)
    run_rows = []                  # (cand idx, qstart, tstart, len)
    for li, layout in enumerate(layouts):
        cid = cids[li] if cids is not None else li
        if not layout:
            continue
        # a filled gap with a NEGATIVE DP score means the chain bridged
        # a non-homologous interval (inversion / unrelated insertion):
        # split the record there (lastz ydrop termination analog), so
        # the true alignment of the interval can win primary status.
        # Only sequence-vs-sequence gaps qualify: a pure indel (one side
        # ~empty, e.g. a SV deletion) always scores negative yet is a
        # legitimate bridge — gate on min(q-side, t-side) length.
        lay2 = []
        for item in layout:
            if item[0] == "gap":
                ops_g, score_g = filled[(task, cid, item[1])]
                qside = sum(ln for o, ln in ops_g if o in ("M", "I"))
                tside = sum(ln for o, ln in ops_g if o in ("M", "D"))
                if (min(qside, tside) >= cfg.extend.min_gap_score_cols
                        and score_g < cfg.extend.min_gap_score):
                    lay2.append(("split",))
                    continue
            lay2.append(item)
        layout = lay2
        # split layout into segments at "split" markers
        segs: list[list] = [[]]
        for item in layout:
            if item[0] == "split":
                segs.append([])
            else:
                segs[-1].append(item)
        for seg_i, seg in enumerate(segs):
            runs_in_seg = [it for it in seg if it[0] == "run"]
            if not runs_in_seg:
                continue
            q0, t0 = runs_in_seg[0][1], runs_in_seg[0][2]
            q1 = runs_in_seg[-1][1] + runs_in_seg[-1][3]
            t1 = runs_in_seg[-1][2] + runs_in_seg[-1][3]
            ops = []
            for it in seg:
                if it[0] == "run":
                    ops.append(("M", it[3]))
                elif it[0] == "ops":
                    ops.extend(it[1])
                else:  # gap
                    ops.extend(filled[(task, cid, it[1])][0])
            ops = merge_cigar(ops)
            ci = len(cands)
            i, j = q0, t0
            gap_cost = 0
            for op, ln in ops:
                if op == "M":
                    run_rows.append((ci, i, j, ln))
                    i += ln
                    j += ln
                elif op == "I":
                    gap_cost += gap_params.gap_open \
                        + ln * gap_params.gap_extend
                    i += ln
                else:
                    gap_cost += gap_params.gap_open \
                        + ln * gap_params.gap_extend
                    j += ln
            cands.append((ops, q0, t0, q1, t1, gap_cost))
            cand_keys.append((cid, seg_i))
    if not cands:
        return []
    # vectorized substitution scoring over all M runs at once
    nmatch_v = np.zeros(len(cands), np.int64)
    sub_v = np.zeros(len(cands), np.int64)
    if run_rows:
        rr = np.asarray(run_rows, np.int64)
        ln = rr[:, 3]
        total = int(ln.sum())
        row_of = np.repeat(np.arange(len(rr)), ln)
        k = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
        qi = rr[row_of, 1] + k
        ti = rr[row_of, 2] + k
        qs = qcodes[qi].astype(np.int32)
        ts = tcodes[ti].astype(np.int32)
        eq = (qs == ts).astype(np.int64)
        sc = submat[qs, ts].astype(np.int64)
        cand_of = rr[row_of, 0]
        np.add.at(nmatch_v, cand_of, eq)
        np.add.at(sub_v, cand_of, sc)
    records = []
    for ci, (ops, q0, t0, q1, t1, gap_cost) in enumerate(cands):
        score = int(sub_v[ci]) - gap_cost
        if score < cfg.extend.gapped_threshold:
            continue  # lastz gappedThresh equivalent: drop weak records
        if strand == "+":
            fq0, fq1 = q0, q1
        else:
            fq0, fq1 = qlen_full - q1, qlen_full - q0
        alnlen = sum(l for _o, l in ops)
        rec = PafRecord(qname=qname, qlen=qlen_full, qstart=fq0, qend=fq1,
                        strand=strand, tname=tname, tlen=tlen,
                        tstart=t0, tend=t1, nmatch=int(nmatch_v[ci]),
                        alnlen=alnlen, mapq=60)
        rec.cigar = ops
        rec.set_tag("AS", "i", score)
        records.append((cand_keys[ci], rec) if keyed else rec)
    return records


def _emit_single_runs(srows, ranks, qcodes, tcodes, qname, tname,
                      qlen_full, tlen, strand, cfg: BlastParams, submat):
    """Vectorized emit for single-run chains (the overwhelming bulk of
    extracted chains at genome scale — most die at gappedThresh, so no
    per-chain Python may run before the score filter).

    srows: (S,3) int64 (qstart, tstart, len); ranks: (S,) chain ranks.
    Returns ((rank, 0), record) pairs for survivors.
    """
    if not len(srows):
        return []
    ln = srows[:, 2]
    total = int(ln.sum())
    bounds = np.cumsum(ln) - ln
    row_of = np.repeat(np.arange(len(srows)), ln)
    k = np.arange(total, dtype=np.int64) - np.repeat(bounds, ln)
    qs = qcodes[srows[row_of, 0] + k].astype(np.int32)
    ts = tcodes[srows[row_of, 1] + k].astype(np.int32)
    sub_v = np.add.reduceat(submat[qs, ts].astype(np.int64), bounds)
    keep = np.flatnonzero(sub_v >= cfg.extend.gapped_threshold)
    if not len(keep):
        return []
    nm = np.add.reduceat((qs == ts).astype(np.int64), bounds)[keep]
    out = []
    for row, i in enumerate(keep):
        q0, t0, l = (int(srows[i, 0]), int(srows[i, 1]), int(srows[i, 2]))
        q1, t1 = q0 + l, t0 + l
        fq0, fq1 = ((q0, q1) if strand == "+"
                    else (qlen_full - q1, qlen_full - q0))
        rec = PafRecord(qname=qname, qlen=qlen_full, qstart=fq0, qend=fq1,
                        strand=strand, tname=tname, tlen=tlen,
                        tstart=t0, tend=t1, nmatch=int(nm[row]),
                        alnlen=l, mapq=60)
        rec.cigar = [("M", l)]
        rec.set_tag("AS", "i", int(sub_v[i]))
        out.append(((int(ranks[i]), 0), rec))
    return out


def chains_to_records(chains, qcodes, tcodes, qname, tname, qlen_full, tlen,
                      strand, cfg: BlastParams, submat, max_fill: int = 8192,
                      device=None):
    """Convert extracted chains into PafRecords with full cigars.

    qcodes are on the aligned strand ('-' = already reverse-complemented);
    coordinates are converted to forward-strand PAF at the end.
    """
    gap_params = GapParams(cfg.extend.gap_open, cfg.extend.gap_extend)
    layouts, pending = _chain_layouts(chains, cfg, max_fill=max_fill)
    filled = _fill_gaps_banded(pending, qcodes, tcodes, submat, gap_params,
                               device=device)
    return _emit_records(layouts, filled, qcodes, tcodes, qname, tname,
                         qlen_full, tlen, strand, cfg, submat)


@dataclass
class StrandTask:
    """One (query chunk, target chunk, strand) anchoring work unit —
    the grid cell the reference fans out as a Toil job
    (local_alignment.py:370-408); here the unit sharded over the mesh."""
    qname: str
    tname: str
    strand: str
    q: np.ndarray               # strand-adjusted query codes
    t: np.ndarray
    qlen_full: int
    tlen: int
    preset: str
    self_alignment: bool = False
    q_mask: np.ndarray | None = None
    t_mask: np.ndarray | None = None


def pair_tasks(qseq: Sequence, tseq: Sequence, qname: str, tname: str,
               cfg: BlastParams, preset: str = "one",
               self_alignment: bool = False) -> list[StrandTask]:
    """Both-strand tasks for one contig/chunk pair."""
    tasks = []
    t_mask = tseq.mask if tseq.mask is not None and tseq.mask.any() else None
    for strand in ("+", "-"):
        q = qseq.codes if strand == "+" else revcomp(qseq.codes)
        q_mask = None
        if qseq.mask is not None and qseq.mask.any():
            q_mask = qseq.mask if strand == "+" else qseq.mask[::-1]
        tasks.append(StrandTask(
            qname=qname, tname=tname, strand=strand, q=q, t=tseq.codes,
            qlen_full=len(qseq.codes), tlen=len(tseq.codes), preset=preset,
            self_alignment=self_alignment, q_mask=q_mask, t_mask=t_mask))
    return tasks


def _task_inputs(task: StrandTask):
    """Padded (codes, valid) device inputs for a task's seed join."""
    qp = _pad_pow2(task.q)
    tp = _pad_pow2(task.t)
    qv = np.ones(len(qp), dtype=bool)
    tv = np.ones(len(tp), dtype=bool)
    qv[len(task.q):] = False
    tv[len(task.t):] = False
    if task.q_mask is not None:
        qv[:len(task.q)] &= ~task.q_mask
    if task.t_mask is not None:
        tv[:len(task.t)] &= ~task.t_mask
    return qp, qv, tp, tv


def _warn_anchor_overflow(task: StrandTask, n: int, cap: int, log) -> None:
    if n >= cap:
        msg = (f"seed-join anchor table overflow: {task.qname}~{task.tname} "
               f"{task.strand} hit the {cap}-anchor cap — homology may be "
               f"dropped; raise seed.max_anchors or mask repeats")
        import warnings
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        if log:
            log(msg)


# Device-memory budget of one seed_join_batch launch set (a sub-batch of a
# shape bin).  The torch join's temporaries per task, in bytes, at their
# peak (ops/seeds.py::seed_join_batch):
#   inputs: codes + valid of both sides, 2 (lq + lt);
#   hashes: int32 hash and bool ok a side, plus one int32 base column
#     and its bool valid column while hashing, 10 (lq + lt);
#   target sort: sorted int32 hashes, int64 argsort indices, the sort's
#     own key + index workspace (as large again) and the gathered int32
#     positions, 4 + 8 + 12 + 4 = 28 lt;
#   query tables: int32 left, right, cnt and ends, 16 lq;
#   expand by rank over the capacity `cap` (at most: only the slots below
#     the bin's largest count are expanded): int32 slots, src, the start
#     index and one gathered operand, the bool mask, and the two int32
#     output tables, 4 * 4 + 1 + 8 = 25 cap (40 with the gathers' own
#     int32 results in flight).
# So per_task = 40 (lq + lt) + 40 cap bounds it (40 lt >= 2 + 10 + 28,
# 40 lq >= 2 + 10 + 16).  The budget is a fixed 16 GiB, a fifth of the
# H100's 80 GB, so that the other ancestor threads' kernels (a few GB at
# most on the paths chip_smoke.py runs) always fit beside it; it is not
# read from the free memory at run time, so that the batching, and the
# order of work, stays the same from run to run.  The JAX package caps a
# batch at 0.75 GB of a TPU's HBM with 18 (lq + lt) + 8 cap a task
# (cactus_tpu/phases/blast.py:452-459).
JOIN_BUDGET_BYTES = 16 << 30


def join_bytes_per_task(lq: int, lt: int, cap: int) -> int:
    """Device bytes one task of a seed_join_batch call takes at its peak
    (the derivation above JOIN_BUDGET_BYTES)."""
    return 40 * (lq + lt) + 40 * cap


def _device_join_batch(tasks, idxs, out, cfg: BlastParams, max_occ: int,
                       eff_cap, log, device, budget: int = JOIN_BUDGET_BYTES
                       ) -> None:
    """Batched device seed joins for big chunk pairs on one card.

    Tasks bin by (padded shapes, seed scheme); each bin is one
    seed_join_batch call per sub-batch of at most `budget` bytes
    (`join_bytes_per_task`).  Counts come to the host first (one sync),
    then each task copies back only its true count of anchors, never the
    full fixed-capacity table."""
    import torch

    sp = cfg.seed
    prepped = {i: _task_inputs(tasks[i]) for i in idxs}
    bins: dict[tuple, list[int]] = {}
    for i in idxs:
        t = tasks[i]
        qp, qv, tp, tv = prepped[i]
        ml = min(len(t.q), len(t.t))
        key = (len(qp), len(tp), sp.k_for(t.preset, ml),
               sp.step_for(t.preset), sp.pattern_for(t.preset, ml))
        bins.setdefault(key, []).append(i)
    for (lq, lt, k, step, pattern), grp in bins.items():
        cap = eff_cap(lq)
        b_max = max(1, budget // join_bytes_per_task(lq, lt, cap))
        for g0 in range(0, len(grp), b_max):
            sub = grp[g0:g0 + b_max]
            qc, qv, tc, tv = (
                torch.from_numpy(np.stack([prepped[i][f] for i in sub]))
                .to(device) for f in range(4))
            qpos, tpos, counts = seed_ops.seed_join_batch(
                qc, qv, tc, tv, k=k, step=step, max_occ=max_occ,
                max_anchors=cap, pattern=pattern, device=device)
            counts = counts.cpu().numpy()
            for row, i in enumerate(sub):
                n = int(counts[row])
                _warn_anchor_overflow(tasks[i], n, cap, log)
                out[i] = (qpos[row, :n].cpu().numpy(),
                          tpos[row, :n].cpu().numpy())


def anchors_for_tasks(tasks: list[StrandTask], cfg: BlastParams,
                      mesh=None, log=None, device=None) -> list:
    """Seed-join anchors per task.

    On a CUDA `device`, tasks at or past SeedParams.device_join_threshold
    (never, by default) take the batched device join; every other task,
    and every task on the CPU, takes the exact host numpy join (the same
    anchors).  With a multi-shard `mesh`, tasks are binned by padded shape
    + seed scheme and run D per dispatch through sharded_pair_seed_join
    on the mesh's shards; output per task is shard-count independent
    (bit-identical 1 vs N shards or processes).
    """
    sp = cfg.seed
    # fastga mode: adaptamer-style target-unique seed hits
    max_occ = 1 if cfg.aligner == "fastga" else sp.max_occurrences
    out: list = [None] * len(tasks)

    def eff_cap(qlen: int) -> int:
        """Anchor-table capacity adapted to the chunk size: ~2 anchor
        slots per query bp (pow2-binned so kernels reuse compiles),
        never below the configured cap, hard-bounded at 16M slots
        (128 MB of device table).  Oversized chunk pairs (e.g. the
        reference XML's 30 Mb) would otherwise overflow the fixed
        buffer and silently drop the genome tail's homology."""
        want = max(sp.max_anchors, 2 * qlen)
        want = 1 << (want - 1).bit_length()
        return min(want, 1 << 24)

    if mesh is None or len(mesh.devices.flat) <= 1:
        # single-device path: small tasks run the exact host-numpy join
        # (target hashed+sorted once per chunk, shared across strands/
        # tiers/queries; zero device round-trips); big chunk pairs go
        # to the card as one batched join per shape bin, as the JAX
        # package sends them to a TPU and joins on the host elsewhere
        from concurrent.futures import ThreadPoolExecutor

        from ..ops import resolve_device, seeds_host

        big = [i for i, t in enumerate(tasks)
               if len(t.q) + len(t.t) >= sp.device_join_threshold]
        device_set: set[int] = set()
        if big:
            dev = resolve_device(device)
            if dev.type == "cuda":
                device_set = set(big)
                _device_join_batch(tasks, big, out, cfg, max_occ, eff_cap,
                                   log, dev)
        host_idx = [i for i in range(len(tasks)) if i not in device_set]
        if not host_idx:
            return out

        def t_valid(task):
            if task.t_mask is None:
                return None
            return ~task.t_mask

        def task_min(task):
            return min(len(task.q), len(task.t))

        # minimap2 mode: contiguous k with (k, w) window-minimizer
        # sampling on both sides (reference `minimap2 -c -x asm20`,
        # local_alignment.py:99-118, config XML :94; asm20's k=19 is
        # traded for the join kernels' shared k<=15 hash budget — the
        # mode's defining behavior is the minimizer sampling + the same
        # chain/extend stack downstream)
        mm2_w = cfg.minimap2_window if cfg.aligner == "minimap2" else 0

        def eff_k(task):
            # length-adaptive seed weight (see SeedParams.k_for)
            return sp.k if mm2_w else sp.k_for(task.preset,
                                               task_min(task))

        def eff_pattern(task):
            # length-adaptive pattern (see SeedParams.pattern_for)
            return "" if mm2_w else sp.pattern_for(task.preset,
                                                   task_min(task))

        def eff_step(task):
            return 1 if mm2_w else sp.step_for(task.preset)

        # phase 1: build each unique target table once (dedup by identity)
        tgt_keys = {}
        for i in host_idx:
            task = tasks[i]
            pattern = eff_pattern(task)
            key = (id(task.t), None if task.t_mask is None
                   else id(task.t_mask), eff_k(task), pattern)
            tgt_keys.setdefault(key, (task.t, t_valid(task), pattern,
                                      eff_k(task)))
        tables: dict[tuple, seeds_host.HashedTarget] = {}
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = {key: pool.submit(seeds_host.hash_target, codes, valid,
                                     kk, pattern, mm2_w)
                    for key, (codes, valid, pattern, kk)
                    in tgt_keys.items()}
            for key, f in futs.items():
                tables[key] = f.result()

            # phase 2: per-task query hash + join, threaded
            def join_one(i):
                task = tasks[i]
                pattern = eff_pattern(task)
                key = (id(task.t), None if task.t_mask is None
                       else id(task.t_mask), eff_k(task), pattern)
                qv = None if task.q_mask is None else ~task.q_mask
                return seeds_host.seed_join_host(
                    task.q, qv, tables[key], k=eff_k(task),
                    step=eff_step(task), max_occ=max_occ,
                    pattern=pattern, minimizer_w=mm2_w)

            for i, res in zip(host_idx, pool.map(join_one, host_idx)):
                out[i] = res
        return out

    from ..parallel.mesh import sharded_pair_seed_join
    D = len(mesh.devices.flat)
    bins: dict[tuple, list[int]] = {}
    prepped = [_task_inputs(t) for t in tasks]
    for i, (qp, qv, tp, tv) in enumerate(prepped):
        key = (len(qp), len(tp), sp.step_for(tasks[i].preset),
               sp.pattern_for(tasks[i].preset))
        bins.setdefault(key, []).append(i)
    for (lq, lt, step, pattern), idxs in bins.items():
        cap = eff_cap(lq)
        for g0 in range(0, len(idxs), D):
            grp = idxs[g0:g0 + D]
            qc = np.zeros((D, lq), np.uint8)
            qv = np.zeros((D, lq), bool)
            tc = np.zeros((D, lt), np.uint8)
            tv = np.zeros((D, lt), bool)
            for row, i in enumerate(grp):
                a, b, c, d = prepped[i]
                qc[row], qv[row], tc[row], tv[row] = a, b, c, d
            qpos, tpos, counts = sharded_pair_seed_join(
                mesh, qc, qv, tc, tv, k=sp.k, step=step,
                max_occ=max_occ, max_anchors=cap,
                pattern=pattern)
            counts = counts.cpu().numpy()
            for row, i in enumerate(grp):
                n = int(counts[row])
                _warn_anchor_overflow(tasks[i], n, cap, log)
                # slice on the device: copy n anchors, not the table
                out[i] = (qpos[row, :n].cpu().numpy(),
                          tpos[row, :n].cpu().numpy())
    return out


def _task_runs(task: StrandTask, qpos: np.ndarray, tpos: np.ndarray,
               cfg: BlastParams, span: int | None = None) -> np.ndarray:
    """Anchors → merged diagonal runs for one task (host, vectorized)."""
    sp = cfg.seed
    if cfg.aligner == "minimap2":
        # contiguous-k minimizers: seed span is k; sampled seeds are
        # sparse on the diagonal, so allow merge gaps up to the window
        if span is None:
            span = sp.k
        step = cfg.minimap2_window
    else:
        if span is None:
            span = sp.span_for(task.preset, min(len(task.q), len(task.t)))
        step = sp.step_for(task.preset)
    if task.self_alignment and task.strand == "+":
        keep = qpos != tpos  # drop the trivial self-diagonal
        qpos, tpos = qpos[keep], tpos[keep]
    runs = seed_ops.merge_diagonal_runs(qpos, tpos, k=span, max_gap=step)
    if len(runs):
        # ungapped x-drop HSP filter (lastz hspThresh, config :131):
        # chance seed hits — L^2/2^bits of them on megabase tasks —
        # score nowhere near the threshold once extended along their
        # diagonal, while true seeds inside homologous context pass;
        # killing them here keeps the chaining sort linear in TRUE
        # anchors (the reference applies the same filter inside lastz)
        from ..native import build as native
        keep = native.dp_hsp_filter(
            task.q, task.t, runs, cfg.extend.match, cfg.extend.mismatch,
            cfg.extend.xdrop, cfg.extend.hsp_threshold)
        if keep is not None:
            runs = runs[keep]
    if cfg.aligner == "fastga" and len(runs):
        # adaptamer length floor: short (likely chance) unique matches
        # are dropped, leaving the long-exact-match anchor set
        runs = runs[runs[:, 2] >= cfg.fastga_min_match]
    return runs


def records_for_task(task: StrandTask, qpos: np.ndarray, tpos: np.ndarray,
                     cfg: BlastParams, submat, device=None) -> list[PafRecord]:
    """Anchors → diagonal runs → chains → gap-filled PAF records."""
    sp = cfg.seed
    min_chain = max(cfg.extend.hsp_threshold // cfg.extend.match,
                    sp.span_for(task.preset))
    runs = _task_runs(task, qpos, tpos, cfg)
    if len(runs) == 0:
        return []
    # seed-run-level chaining: gaps larger than max_fill split records
    # anyway, so cap max_gap there; the paffy-level chain constants
    # (chainGapOpen etc.) apply to record-level re-chaining.
    order, scores, preds = chain_ops.chain_anchors(runs, max_gap=8192)
    chains = chain_ops.extract_chains(runs, order, scores, preds,
                                      min_score=min_chain)
    return chains_to_records(
        chains, task.q, task.t, task.qname, task.tname, task.qlen_full,
        task.tlen, task.strand, cfg, submat, device=device)


def run_tasks(tasks: list[StrandTask], cfg: BlastParams,
              mesh=None, log=None, device=None) -> list[PafRecord]:
    """Anchor + chain + fill a task list; anchoring shards over `mesh`.

    Dispatch/collect structure: (1) all seed joins (mesh-sharded bins),
    (2) all chain-DP scans as pow2-binned vmapped batches, (3) ONE
    global gap-fill pass band-binned across every task, (4) host record
    assembly.  Output is identical to per-task processing; device
    round-trips drop from O(tasks) to O(shape bins).
    """
    import os as _os
    import time as _time
    _prof = _os.environ.get("CACTUS_BLAST_PROF")
    _t = _time.time()
    submat = score_matrix_6(PoaParams().sub_matrix)
    anchors = anchors_for_tasks(tasks, cfg, mesh=mesh, log=log,
                                device=device)
    if _prof:
        print(f"[blast-prof] anchors({len(tasks)} tasks): "
              f"{_time.time() - _t:.2f}s", flush=True)
        _t = _time.time()
    # run-merge span must match the k the anchoring path used: the
    # host path scales k by task size; the device/mesh path is pinned
    # at the int32-hash limit (k=15)
    def _span(t):
        if cfg.aligner == "minimap2":
            # minimizer hashing is pinned at k: a length-adaptive merge
            # span would extend seed runs past the hashed span (and off
            # the end of a query chunk shorter than the whole target)
            return cfg.seed.k
        if mesh is None or len(mesh.devices.flat) <= 1:
            return cfg.seed.span_for(t.preset, min(len(t.q), len(t.t)))
        return cfg.seed.span_for(t.preset)
    runs_list = [_task_runs(t, qp, tp, cfg, span=_span(t))
                 for t, (qp, tp) in zip(tasks, anchors)]
    chained = chain_ops.chain_anchors_batch(runs_list, max_gap=8192)
    if _prof:
        print(f"[blast-prof] chain({sum(len(r) for r in runs_list)} runs): "
              f"{_time.time() - _t:.2f}s", flush=True)
        _t = _time.time()

    sp = cfg.seed
    gap_params = GapParams(cfg.extend.gap_open, cfg.extend.gap_extend)
    # per task: sparse multi-run layouts (+their chain ranks) and the
    # bulk single-run chains as flat arrays for the vectorized emitter
    all_layouts: list = []       # (layouts, cids) per task
    all_singles: list = []       # (srows, ranks) per task
    all_pending: list[_PendingGap] = []
    max_fill = 8192
    for i, (task, runs, (order, scores, preds)) in enumerate(
            zip(tasks, runs_list, chained)):
        if len(runs) == 0:
            all_layouts.append(([], []))
            all_singles.append((np.zeros((0, 3), np.int64),
                                np.zeros(0, np.int64)))
            continue
        min_chain = max(cfg.extend.hsp_threshold // cfg.extend.match,
                        sp.span_for(task.preset))
        runs_flat, chain_off, _cs = _extract_trimmed(
            runs, order, scores, preds, min_chain)
        sizes = np.diff(chain_off)
        single = sizes == 1
        srows = runs_flat[chain_off[:-1][single]]
        all_singles.append((srows, np.flatnonzero(single)))
        layouts, cids = [], []
        for rank in np.flatnonzero(~single):
            ch_runs = runs_flat[chain_off[rank]:chain_off[rank + 1]]
            layouts.append(_layout_one(ch_runs, int(rank), i, max_fill,
                                       all_pending))
            cids.append(int(rank))
        all_layouts.append((layouts, cids))

    if _prof:
        print(f"[blast-prof] layouts: {_time.time() - _t:.2f}s", flush=True)
        _t = _time.time()
    filled = _fill_gaps_banded(all_pending,
                               [t.q for t in tasks], [t.t for t in tasks],
                               submat, gap_params, device=device)
    if _prof:
        _cells = sum((g.q1 - g.q0) for g in all_pending)
        print(f"[blast-prof] fill({len(all_pending)} gaps, {_cells} qbp): "
              f"{_time.time() - _t:.2f}s", flush=True)
        _t = _time.time()

    records: list[PafRecord] = []
    for i, task in enumerate(tasks):
        layouts, cids = all_layouts[i]
        srows, ranks = all_singles[i]
        keyed = _emit_records(
            layouts, filled, task.q, task.t, task.qname, task.tname,
            task.qlen_full, task.tlen, task.strand, cfg, submat, task=i,
            cids=cids, keyed=True)
        keyed += _emit_single_runs(
            srows, ranks, task.q, task.t, task.qname, task.tname,
            task.qlen_full, task.tlen, task.strand, cfg, submat)
        # restore the original per-task order: descending chain score,
        # segments in layout order (identical to the all-python path)
        keyed.sort(key=lambda kr: kr[0])
        records.extend(r for _k, r in keyed)
    if _prof:
        print(f"[blast-prof] emit({len(records)} records): "
              f"{_time.time() - _t:.2f}s", flush=True)
    return records


def align_contig_pair(qseq: Sequence, tseq: Sequence, qname: str, tname: str,
                      cfg: BlastParams, preset: str = "one",
                      self_alignment: bool = False,
                      device=None) -> list[PafRecord]:
    """Full anchoring of one contig pair, both strands → PAF records."""
    return run_tasks(pair_tasks(qseq, tseq, qname, tname, cfg, preset,
                                self_alignment), cfg, device=device)


def mark_primaries(records: list[PafRecord],
                   min_primary_score: int = 0) -> list[PafRecord]:
    """Primary/secondary selection by query-interval coverage.

    Mirrors the role of paffy tile/trim + minPrimaryChainScore
    (local_alignment.py:660-727): the best-scoring record covering a query
    region is primary; others become secondary (tp:A:S).  Selection is per
    (query, target genome): the reference chains ingroup and outgroup
    alignments separately (chain_alignments_splitting_ingroups_and_
    outgroups, local_alignment.py:556-595) — competing a close outgroup
    against a distant sibling would wrongly demote the sibling's records.
    """
    by_query: dict[tuple[str, str], list[PafRecord]] = {}
    for r in records:
        t_event = r.tname.split(".", 1)[0]
        by_query.setdefault((r.qname, t_event), []).append(r)
    for recs in by_query.values():
        recs.sort(key=lambda r: -r.score)
        covered: list[tuple[int, int]] = []   # kept sorted + merged
        for r in recs:
            ov = _overlap_len(covered, r.qstart, r.qend)
            if (ov < 0.5 * (r.qend - r.qstart)
                    and r.score >= min_primary_score):
                r.set_tag("tp", "A", "P")
                _insert_interval(covered, r.qstart, r.qend)
            else:
                r.set_tag("tp", "A", "S")
    return records


def _insert_interval(intervals: list, s: int, e: int) -> None:
    """Insert [s,e) into a sorted, disjoint interval list (merge)."""
    import bisect
    i = bisect.bisect_left(intervals, (s, e))
    # absorb neighbours that overlap
    if i > 0 and intervals[i - 1][1] >= s:
        i -= 1
        s = min(s, intervals[i][0])
    j = i
    while j < len(intervals) and intervals[j][0] <= e:
        e = max(e, intervals[j][1])
        s = min(s, intervals[j][0])
        j += 1
    intervals[i:j] = [(s, e)]


def _overlap_len(intervals, s, e) -> int:
    """Overlap of [s,e) with a SORTED disjoint interval list."""
    import bisect
    total = 0
    i = bisect.bisect_left(intervals, (s, -1))
    if i > 0:
        i -= 1
    while i < len(intervals) and intervals[i][0] < e:
        a, b = intervals[i]
        total += max(0, min(b, e) - max(a, s))
        i += 1
    return total


def align_genomes(q_genome: dict[str, Sequence], t_genome: dict[str, Sequence],
                  q_event: str, t_event: str, cfg: BlastParams,
                  preset: str = "one", device=None) -> list[PafRecord]:
    """All contig pairs between two genomes → PAF with tp:A tags."""
    records: list[PafRecord] = []
    for qn, qs in q_genome.items():
        if len(qs) < cfg.minimum_sequence_length:
            continue
        for tn, ts in t_genome.items():
            if len(ts) < cfg.minimum_sequence_length:
                continue
            self_aln = (q_event == t_event and qn == tn)
            records.extend(align_contig_pair(
                qs, ts, f"{q_event}.{qn}", f"{t_event}.{tn}", cfg, preset,
                self_alignment=self_aln, device=device))
    return finalize(records, cfg)


def filter_primary_chains(records: list[PafRecord], min_chain_score: int,
                          max_gap: int, gap_open: int = 5000,
                          gap_extend: int = 1,
                          drop: bool = False) -> list[PafRecord]:
    """Demote primaries whose re-assembled chain scores below
    minPrimaryChainScore (local_alignment.py:711-727: primaries are
    re-chained with `paffy chain`, chains under --minChainScore are
    filtered from the primary set and re-emitted as secondaries — or
    dropped entirely when secondaries are not output, :679-688).

    Cross-record chains: primary records on the same (query, target,
    strand) whose query order is colinear with target order within
    chainMaxGapLength on both axes sum their AS scores minus per-join
    gap costs (chainGapOpen + chainGapExtend * gap, config XML
    :108-110); a chain below the threshold demotes (or drops) all
    member records.
    """
    if min_chain_score <= 0:
        return records
    groups: dict[tuple, list[PafRecord]] = {}
    for r in records:
        if r.get_tag("tp") == "P":
            groups.setdefault((r.qname, r.tname, r.strand), []).append(r)
    doomed: set[int] = set()
    for (_q, _t, strand), recs in groups.items():
        recs.sort(key=lambda r: (r.qstart, r.qend))
        chains: list[list[PafRecord]] = []
        costs: list[int] = []
        cur = [recs[0]]
        cost = 0
        for prev, r in zip(recs, recs[1:]):
            qgap = r.qstart - prev.qend
            tgap = (r.tstart - prev.tend if strand == "+"
                    else prev.tstart - r.tend)
            if -64 <= qgap <= max_gap and -64 <= tgap <= max_gap:
                cur.append(r)
                cost += gap_open + gap_extend * max(qgap, tgap, 0)
            else:
                chains.append(cur)
                costs.append(cost)
                cur, cost = [r], 0
        chains.append(cur)
        costs.append(cost)
        for chain, cost in zip(chains, costs):
            if sum(r.score for r in chain) - cost < min_chain_score:
                for r in chain:
                    if drop:
                        doomed.add(id(r))
                    else:
                        r.set_tag("tp", "A", "S")
    if doomed:
        records = [r for r in records if id(r) not in doomed]
    return records


def finalize(records: list[PafRecord], cfg: BlastParams
             ) -> list[PafRecord]:
    """Primary/secondary selection + chain-score filtering, dispatching
    on cfg.primary_selection:

    - "coverage" (TPU-first default): mark_primaries query-coverage
      greedy + re-chain score filter.  Keeps overlapping evidence for
      the symmetric CAF anneal — measured best recall at high
      divergence with duplications.
    - "tile-trim": the reference's paffy chain→tile→trim→filter
      pipeline (finalize_records) — fewer records (each query base
      claimed once per target event), ~25% faster end-to-end, with a
      small recall cost on duplicated regions (measured -0.8% at
      0.2-divergence sims with duplication_rate 0.001).
    """
    if cfg.primary_selection == "tile-trim":
        return finalize_records(records, cfg)
    records = mark_primaries(records, min_primary_score=0)
    if not cfg.output_secondary_alignments:
        # outputSecondaryAlignments=0 drops coverage-demoted records
        # too, not only chain-score demotions (local_alignment.py:
        # 679-688 filters maxTileLevel>1 out entirely)
        records = [r for r in records if r.is_primary]
    return filter_primary_chains(
        records, cfg.min_primary_chain_score, cfg.chain_max_gap_length,
        gap_open=cfg.chain_gap_open, gap_extend=cfg.chain_gap_extend,
        drop=not cfg.output_secondary_alignments)


def finalize_records(records: list[PafRecord], cfg: BlastParams
                     ) -> list[PafRecord]:
    """Record-level post-processing of the dechunked PAF: the reference
    chain → tile → trim → filter → re-chain → filter pipeline
    (local_alignment.py:658-727), with ingroup and outgroup alignments
    never competing (chain_alignments_splitting_ingroups_and_outgroups,
    :556-595 — an outgroup must never demote a sibling's records).

    Knobs honored: pafTrimIdentity (trimmed pieces below this identity
    are discarded), outputSecondaryAlignments (tile level > 1 records
    and demoted sub-chain-score primaries are kept as tp:A:S or dropped),
    minPrimaryChainScore + chainGapOpen/Extend/MaxGapLength (re-chain
    scoring), chainTrimFraction (paffy chain --trimFraction: each
    chained record keeps its central fraction, applied before tiling —
    the reference's first chain step carries the flag,
    local_alignment.py:674).
    """
    from ..ops import paf_tools
    if cfg.chain_trim_fraction < 1.0:
        records = [t for t in
                   (paf_tools.trim_record_fraction(
                       r, cfg.chain_trim_fraction) for r in records)
                   if t is not None]

    # competition scope: per target EVENT (finer than the reference's
    # pooled-targets tile — a base may keep one primary per sibling
    # genome; measured better for the symmetric-evidence CAF here, and
    # an outgroup still can never demote a sibling's records)
    pools: dict[str, list[PafRecord]] = {}
    for r in records:
        pools.setdefault(r.tname.split(".", 1)[0], []).append(r)

    out: list[PafRecord] = []
    for pool in pools.values():
        paf_tools.tile(pool)
        primaries = [r for r in pool if r.get_tag("tl", 1) <= 1]
        secondaries = [r for r in pool if r.get_tag("tl", 1) > 1]
        primaries = paf_tools.trim(primaries)
        if cfg.paf_trim_identity > 0:
            primaries = [r for r in primaries
                         if r.alnlen and
                         r.nmatch / r.alnlen >= cfg.paf_trim_identity]
        for r in primaries:
            r.set_tag("tp", "A", "P")
        pool = primaries
        if cfg.output_secondary_alignments:
            for r in secondaries:
                r.set_tag("tp", "A", "S")
            pool = primaries + secondaries
        out.extend(filter_primary_chains(
            pool, cfg.min_primary_chain_score, cfg.chain_max_gap_length,
            gap_open=cfg.chain_gap_open, gap_extend=cfg.chain_gap_extend,
            drop=not cfg.output_secondary_alignments))
    return out


def trim_outgroup_sequences(records: list[PafRecord],
                            og_seqs: dict[str, "Sequence"],
                            flank: int = 2000,
                            ) -> tuple[list[PafRecord],
                                       dict[str, np.ndarray]]:
    """Outgroup-side trimming (reference trim_unaligned_sequences,
    local_alignment.py:861-904: paffy to_bed on the og side, faffy
    extract with --flank, paffy upconvert to rebase the PAF).

    Outgroup sequence without any alignment to an ingroup never reaches
    the ancestor — keeping it only inflates memory.  Covered og
    intervals (+flank, merged) become named fragments
    `name|og:<start>`; og-side record coordinates are rebased in place
    onto their fragment.  Returns (records, fragment codes dict) — the
    codes dict holds only the covered slices of each og genome.
    """
    covered: dict[str, list[tuple[int, int]]] = {}
    og_recs: list[tuple[PafRecord, bool]] = []   # (record, og-is-query)
    for r in records:
        if r.qname in og_seqs:
            covered.setdefault(r.qname, []).append((r.qstart, r.qend))
            og_recs.append((r, True))
        elif r.tname in og_seqs:
            covered.setdefault(r.tname, []).append((r.tstart, r.tend))
            og_recs.append((r, False))
    frags: dict[str, list[tuple[int, int]]] = {}
    og_codes: dict[str, np.ndarray] = {}
    for name, ivs in covered.items():
        L = len(og_seqs[name])
        ivs.sort()
        merged: list[list[int]] = []
        for s, e in ivs:
            s = max(0, s - flank)
            e = min(L, e + flank)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        frags[name] = [(s, e) for s, e in merged]
        codes = og_seqs[name].codes
        for s, e in merged:
            og_codes[f"{name}|og:{s}"] = codes[s:e]
    for r, og_is_q in og_recs:
        name = r.qname if og_is_q else r.tname
        lo = r.qstart if og_is_q else r.tstart
        fr = frags[name]
        import bisect
        i = bisect.bisect_right(fr, (lo, 1 << 62)) - 1
        s, e = fr[i]
        fname = f"{name}|og:{s}"
        if og_is_q:
            r.qname, r.qlen = fname, e - s
            r.qstart -= s
            r.qend -= s
        else:
            r.tname, r.tlen = fname, e - s
            r.tstart -= s
            r.tend -= s
    return records, og_codes
