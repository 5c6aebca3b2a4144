"""Seed-table construction and k-mer join (lastz seeding equivalent).

The k-mer join is sort + searchsorted + a vectorized "expand by rank"
gather on fixed shapes, as in the JAX package: PyTorch ops on the device
(a stable `torch.sort`, `torch.searchsorted`, an int32 `torch.cumsum` and
gathers), no hand-written kernel.  `seed_join_batch` joins a (B, L) batch
of equally padded chunk pairs in one set of launches; the blast phase
sends the chunk pairs past SeedParams.device_join_threshold there
(phases/blast.py::_device_join_batch) and joins the others on the host
(ops/seeds_host.py, the same semantics), then merges the hits into
diagonal runs here (`merge_diagonal_runs`).

Outputs are fixed-capacity anchor tables (qpos, tpos) with a valid count,
the device-friendly analogue of lastz's variable-length seed-hit lists.
"""

from __future__ import annotations

import numpy as np

# Hashes are int32: 2 bits/base, k <= 15 → < 2^30.  Sentinels are distinct
# values outside the real hash range (invalid kmers must never join).
INVALID_Q = np.int32((1 << 31) - 1)  # sorts after all real hashes
INVALID_T = np.int32(-1)             # sorts before all real hashes
MAX_K = 15


def kmer_hashes(codes, valid, k: int, step: int, pattern: str = "",
                device=None):
    """Hash every (possibly spaced) seed at positions 0, step, 2*step, ...

    codes: (..., L) uint8 base codes; valid: (..., L) bool (False = N or
    masked).  pattern: '1' = full 2-bit care, 'T' = transition-tolerant
    1-bit care (purine/pyrimidine class, lastz's T seeds), '0' = skip,
    over a window of len(pattern) (empty = contiguous k-mer).  Returns
    (hashes (..., n) int32 with INVALID_Q for invalid seeds, positions
    (n,) int32) on `device` (None = the current CUDA device).
    """
    import torch

    from . import resolve_device
    care = ([(i, ch) for i, ch in enumerate(pattern) if ch in "1T"]
            if pattern else [(i, "1") for i in range(k)])
    span = len(pattern) if pattern else k
    bits = sum(2 if ch == "1" else 1 for _i, ch in care)
    if bits > 2 * MAX_K:
        raise ValueError(f"seed hash bits {bits} exceed {2 * MAX_K} "
                         "(int32 hash space)")
    dev = resolve_device(device)
    codes = torch.as_tensor(codes, dtype=torch.uint8, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    L = codes.shape[-1]
    n = max(0, (L - span) // step + 1)
    pos = torch.arange(n, dtype=torch.int32, device=dev) * step
    h = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int32, device=dev)
    ok = torch.ones_like(h, dtype=torch.bool)
    last = (n - 1) * step + 1
    for j, kind in care if n else ():
        # the seed starts' bases at offset j: a strided view, no gather
        cj = codes[..., j:j + last:step].to(torch.int32)
        ok &= valid[..., j:j + last:step] & (cj <= 3)
        cj = torch.where(cj > 3, 0, cj)
        if kind == "1":
            h = (h << 2) | cj
        else:
            h = (h << 1) | (cj & 1)
    return torch.where(ok, h, int(INVALID_Q)), pos


def seed_join(q_codes, q_valid, t_codes, t_valid,
              k: int = 15, step: int = 1, max_occ: int = 64,
              max_anchors: int = 1 << 20, pattern: str = "", device=None):
    """All matching (qpos, tpos) k-mer pairs between query and target.

    Per-query-kmer hits are capped at `max_occ` (repeat guard, mirroring
    lastzRepeatMask's seed-count limiting; config XML :36) over the
    stable-sorted target order, and the output is a fixed-capacity table.

    Returns (qpos (A,) int32, tpos (A,) int32, n_anchors () int32) where
    entries beyond n_anchors are -1.
    """
    import torch

    from . import resolve_device
    dev = resolve_device(device)
    qpos, tpos, n = seed_join_batch(
        *(torch.as_tensor(x, device=dev)[None]
          for x in (q_codes, q_valid, t_codes, t_valid)),
        k=k, step=step, max_occ=max_occ, max_anchors=max_anchors,
        pattern=pattern, device=dev)
    return qpos[0], tpos[0], n[0]


def seed_join_batch(q_codes, q_valid, t_codes, t_valid,
                    k: int = 15, step: int = 1, max_occ: int = 64,
                    max_anchors: int = 1 << 20, pattern: str = "",
                    device=None):
    """seed_join over a (B, L) task batch: one set of launches for a
    whole shape bin of chunk-pair tasks.

    Returns (qpos (B, A) int32, tpos (B, A) int32, n_anchors (B,) int32)
    on `device`, row by row equal to seed_join.
    """
    import torch

    from . import resolve_device
    dev = resolve_device(device)
    qh, qpos = kmer_hashes(q_codes, q_valid, k, step, pattern, device=dev)
    th, tpos = kmer_hashes(t_codes, t_valid, k, 1, pattern, device=dev)
    th = torch.where(th == int(INVALID_Q), int(INVALID_T), th)
    B, nq = qh.shape
    nt = th.shape[1]
    # stable, like jnp.argsort: which max_occ hits of a repeated k-mer
    # survive depends on the order of equal hashes
    th_s, order = torch.sort(th, dim=1, stable=True)
    del th
    tpos_s = tpos[order]
    del order
    left = torch.searchsorted(th_s, qh, out_int32=True)
    right = torch.searchsorted(th_s, qh, right=True, out_int32=True)
    del th_s
    cnt = torch.clamp_max(right - left, max_occ)
    del right
    cnt = torch.where(qh == int(INVALID_Q), 0, cnt)
    del qh
    # int32 sums: at most 2^24 query k-mers x max_occ 64 = 2^30
    ends = torch.cumsum(cnt, dim=1, dtype=torch.int32)      # inclusive
    total = (torch.clamp_max(ends[:, -1], max_anchors) if nq
             else torch.zeros(B, dtype=torch.int32, device=dev))
    if nq == 0 or nt == 0:
        none = torch.full((B, max_anchors), -1, dtype=torch.int32,
                          device=dev)
        return none, none.clone(), total
    # expand-by-rank: slot s belongs to query kmer src(s); its rank within
    # that kmer's hit list is s - (ends[src] - cnt[src]).  Only the slots
    # below the batch's largest count hold anchors, so only those are
    # expanded (one sync reads the count); the rest of the table is -1
    used = int(total.max()) if B else 0
    slots = torch.arange(used, dtype=torch.int32,
                         device=dev).expand(B, used).contiguous()
    src = torch.searchsorted(ends, slots, right=True, out_int32=True)
    src.clamp_(max=nq - 1)
    start = (torch.gather(ends, 1, src) - torch.gather(cnt, 1, src)).neg_()
    start += slots                                           # rank
    start += torch.gather(left, 1, src)
    start.clamp_(max=nt - 1)
    ok = slots < total[:, None]
    del slots
    out_q = torch.full((B, max_anchors), -1, dtype=torch.int32, device=dev)
    out_t = torch.full((B, max_anchors), -1, dtype=torch.int32, device=dev)
    out_q[:, :used] = torch.where(ok, qpos[src], -1)
    out_t[:, :used] = torch.where(ok, torch.gather(tpos_s, 1, start), -1)
    return out_q, out_t, total


def merge_diagonal_runs(qpos: np.ndarray, tpos: np.ndarray, k: int,
                        max_gap: int = 0) -> np.ndarray:
    """Collapse seed hits into maximal runs on each diagonal (host, numpy).

    Hits on the same diagonal within `max_gap` of each other merge into one
    run.  Returns (R, 3) int64 array of (qstart, tstart, length); runs cover
    [qstart, qstart+length) x [tstart, tstart+length).
    """
    if len(qpos) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    qpos = qpos.astype(np.int64)
    tpos = tpos.astype(np.int64)
    diag = tpos - qpos
    order = np.lexsort((qpos, diag))
    d, q = diag[order], qpos[order]
    new_run = np.ones(len(q), dtype=bool)
    new_run[1:] = (d[1:] != d[:-1]) | (q[1:] - q[:-1] > k + max_gap)
    starts = np.flatnonzero(new_run)
    ends = np.append(starts[1:], len(q)) - 1
    qstart = q[starts]
    qend = q[ends] + k
    dstart = d[starts]
    return np.stack([qstart, qstart + dstart, qend - qstart], axis=1)
