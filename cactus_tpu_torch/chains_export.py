"""UCSC chain export (cactus-hal2chains equivalent).

Reference: maf/cactus_hal2chains.py shells out to hal2fasta + axtChain to
produce UCSC liftover chains between the reference genome and every
other genome.  Here chains come straight from the composed coordinate
maps: maximal collinear runs of (ref position ↔ query position) become
chain blocks, written in the standard chain format
(https://genome.ucsc.edu/goldenPath/help/chain.html):

    chain score tName tSize tStrand tStart tEnd qName qSize qStrand qStart qEnd id
    size dt dq
    ...
    size
"""

from __future__ import annotations

import numpy as np

from .progressive import ProgressiveResult, _lca, leaf_map_to_ancestor


def _joined_runs(result: ProgressiveResult, ref: str, query: str):
    """Collinear runs between two leaf genomes via their LCA.

    Yields (ref_seq, ref_start, q_seq, q_start, strand, length) with
    ref positions ascending within each run.
    """
    lca = _lca(result.tree, ref, query)
    mr = leaf_map_to_ancestor(result, ref, lca)
    mq = leaf_map_to_ancestor(result, query, lca)

    # index query by (anc_idx, anc_pos)
    q_entries = []
    for qname, m in mq.items():
        sel = np.flatnonzero(m.tgt_idx >= 0)
        key = m.tgt_idx[sel].astype(np.int64) << 40 | m.tgt_pos[sel]
        q_entries.append((qname, sel, key, m.strand[sel]))
    if not q_entries:
        return
    all_key = np.concatenate([k for _n, _s, k, _st in q_entries])
    order = np.argsort(all_key, kind="stable")
    name_idx = np.concatenate([np.full(len(k), i)
                               for i, (_n, _s, k, _st) in
                               enumerate(q_entries)])
    all_pos = np.concatenate([s for _n, s, _k, _st in q_entries])
    all_strand = np.concatenate([st for _n, _s, _k, st in q_entries])
    key_s = all_key[order]
    pos_s = all_pos[order]
    strand_s = all_strand[order]
    nidx_s = name_idx[order]

    for rname, m in mr.items():
        sel = np.flatnonzero(m.tgt_idx >= 0)
        if not len(sel):
            continue
        rkey = m.tgt_idx[sel].astype(np.int64) << 40 | m.tgt_pos[sel]
        left = np.searchsorted(key_s, rkey, side="left")
        right = np.searchsorted(key_s, rkey, side="right")
        hits = right > left
        # take the FIRST query hit per ref base (chains are 1-1)
        ridx = sel[hits]
        qslot = left[hits]
        qpos = pos_s[qslot]
        qstrand = strand_s[qslot] * m.strand[ridx]
        qname_i = nidx_s[qslot]
        if not len(ridx):
            continue
        # split into collinear runs
        brk = np.ones(len(ridx), dtype=bool)
        if len(ridx) > 1:
            step = qstrand[:-1].astype(np.int64)
            brk[1:] = ~((ridx[1:] == ridx[:-1] + 1)
                        & (qpos[1:] == qpos[:-1] + step)
                        & (qstrand[1:] == qstrand[:-1])
                        & (qname_i[1:] == qname_i[:-1]))
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], len(ridx))
        for s0, e0 in zip(starts, ends):
            n = e0 - s0
            qn = q_entries[int(qname_i[s0])][0]
            yield (rname, int(ridx[s0]), qn, int(qpos[s0]),
                   int(qstrand[s0]), int(n))


def write_chains(path_or_file, result: ProgressiveResult, ref: str,
                 query: str, max_gap: int = 100_000) -> int:
    """Write chains between two leaf genomes; returns the chain count."""
    own = not hasattr(path_or_file, "write")
    fh = open(path_or_file, "w") if own else path_or_file
    sizes_r = {n: len(s) for n, s in result.genomes[ref].items()}
    sizes_q = {n: len(s) for n, s in result.genomes[query].items()}
    try:
        runs = sorted(_joined_runs(result, ref, query))
        chain_id = 0
        i = 0
        while i < len(runs):
            # group runs into one chain while collinear within max_gap
            j = i + 1
            while j < len(runs):
                r0, rs0, q0, qs0, st0, n0 = runs[j - 1]
                r1, rs1, q1, qs1, st1, n1 = runs[j]
                if (r1 != r0 or q1 != q0 or st1 != st0):
                    break
                dr = rs1 - (rs0 + n0)
                dq = (qs1 - (qs0 + n0)) if st0 == 1 else (qs0 - (qs1 + n1))
                if dr < 0 or dq < 0 or dr > max_gap or dq > max_gap:
                    break
                j += 1
            group = runs[i:j]
            i = j
            chain_id += 1
            rname, rs, qn, qs, st, _n = group[0]
            r_end = group[-1][1] + group[-1][5]
            score = sum(g[5] for g in group) * 100
            tsize = sizes_r[rname]
            qsize = sizes_q[qn]
            if st == 1:
                q_start = group[0][3]
                q_end = group[-1][3] + group[-1][5]
                fh.write(f"chain {score} {rname} {tsize} + {rs} {r_end} "
                         f"{qn} {qsize} + {q_start} {q_end} {chain_id}\n")
            else:
                # '-' strand: chain q coords are on the reverse strand
                q_last = group[-1][3]
                q_first = group[0][3]
                q_start = qsize - (q_first + 1)
                q_end = qsize - (q_last - group[-1][5] + 1 + 1) + 1
                fh.write(f"chain {score} {rname} {tsize} + {rs} {r_end} "
                         f"{qn} {qsize} - {q_start} {q_end} {chain_id}\n")
            for k, g in enumerate(group):
                if k + 1 < len(group):
                    nxt = group[k + 1]
                    dt = nxt[1] - (g[1] + g[5])
                    dq = (nxt[3] - (g[3] + g[5]) if st == 1
                          else g[3] - g[5] - nxt[3])
                    fh.write(f"{g[5]} {dt} {dq}\n")
                else:
                    fh.write(f"{g[5]}\n")
            fh.write("\n")
        return chain_id
    finally:
        if own:
            fh.close()
