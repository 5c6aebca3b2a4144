"""Sharding of the alignment pipeline over devices and processes
(Toil-distribution analog).

The reference distributes work as independent Toil jobs over a cluster and
"merges" by concatenating files (reference: src/cactus/paf/local_alignment.py
:336-367 combine_chunks, :370-408 chunk-grid fan-out).  Here a `Mesh` lists
D shards in rank order over the processes of a `torch.distributed` group
(parallel/distributed.py; one process without a group): shard d belongs to
rank d // local and is that rank's local slot d % local, a CUDA card
(the current one and those after it) or, on the CPU, a logical shard.

 - the (query-chunk x target-chunk) anchoring grid is data-parallel over
   the shards: each shard seed-joins its own chunk pair;
 - banded-DP pair batches are sharded over the batch axis;
 - "file concatenation" merges become fixed-shape `all_gather`s of
   count-prefixed anchor tables, and global statistics `all_reduce`s.

Deterministic N-shard == 1-shard outputs: a shard's result does not
depend on where it ran, and every merged table is gathered in rank order
(the mesh order), mirroring the reference's file-order concatenation.
Under the gloo backend the collectives take host copies of their
tensors (gloo's all_gather takes CPU tensors only).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Shard(NamedTuple):
    index: int          # d, the shard's place in mesh order
    rank: int           # the process that holds it
    device: object      # its torch.device in that process


class Mesh:
    """D shards in rank order (`devices`, an array of Shard laid out on
    `axis_names`), the group's size and this process's rank."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 world: int = 1, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.world = world
        self.rank = rank
        self.local = [s for s in devices.flat if s.rank == rank]

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self):
        """This process's first shard's device: where merged tables land."""
        return self.local[0].device


def _rank_world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: int | None = None, axis: str = "d",
              device=None) -> Mesh:
    """A 1-D mesh of n_devices shards over the process group.

    device (None: the current CUDA device) says what a shard is: on CUDA
    a card, this process's slots taking the named card and those after
    it, and the default count one card a process in a group (torchrun's
    one process a card) or every card from the named one on alone; on
    the CPU a logical shard, one a process by default.  Raises when the
    shards do not split evenly over the processes, or when a process
    needs more CUDA cards than it has: it never falls back to the CPU."""
    import torch

    from ..ops import resolve_device
    rank, world = _rank_world()
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        base = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        have = torch.cuda.device_count() - base
        n = n_devices or world * (1 if world > 1 else have)
    else:
        n = n_devices or world
    if n % world:
        raise ValueError(f"{n} shards do not split over {world} processes")
    local = n // world
    if cuda and local > have:
        raise ValueError(f"need {n} devices ({local} CUDA cards in each of "
                         f"{world} processes), have {have} from "
                         f"cuda:{base} in this one")
    shards = np.empty(n, dtype=object)
    for d in range(n):
        r, slot = divmod(d, local)
        shards[d] = Shard(d, r, torch.device("cuda", base + slot) if cuda
                          else torch.device("cpu"))
    return Mesh(shards, (axis,), world, rank)


def pad_batch_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _host_copy() -> bool:
    import torch.distributed as dist
    return dist.get_backend() == "gloo"


def _gather_rows(mesh: Mesh, x):
    """This process's rows x (its shards' results, stacked in mesh order)
    -> every shard's rows, gathered in rank order on every process (on
    the host under gloo)."""
    import torch
    import torch.distributed as dist
    if not _in_group():
        return x
    # gloo's all_gather takes CPU tensors only: a host copy
    src = x.cpu() if _host_copy() else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    return torch.cat(parts)


def _sum_all(mesh: Mesh, x):
    """x summed over every process (all_reduce; a host copy under gloo)."""
    import torch.distributed as dist
    if not _in_group():
        return x
    dev = x.device
    x = x.cpu() if _host_copy() else x.clone()
    dist.all_reduce(x)
    return x.to(dev)


def put_global(mesh: Mesh, arr, sharded: bool = True) -> list:
    """Host array -> this process's shards' inputs, one tensor a local
    shard on its device: row d of arr for shard d (sharded), or the
    whole of arr (replicated).  Every process holds the same full host
    array (the driver's task grid is deterministic and replicated), so
    each feeds only its own shards."""
    import torch
    arr = np.asarray(arr)
    return [torch.from_numpy(np.ascontiguousarray(arr[s.index] if sharded
                                                  else arr)).to(s.device)
            for s in mesh.local]


def _rows(mesh: Mesh, arr) -> list:
    """Shard d's block of rows of a (P, ...) batch, P a multiple of D, for
    each local shard, on its device."""
    import torch
    arr = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr)
                          else arr)
    per = arr.shape[0] // mesh.size
    return [arr[s.index * per:(s.index + 1) * per].to(s.device)
            for s in mesh.local]


def sharded_banded_align(mesh: Mesh, q, t_shift, m_len, n_len, lo, submat,
                         *, band: int, gap_open: int, gap_extend: int):
    """banded_dp with the pair batch sharded over the mesh: shard d runs
    the port's banded_dp (the CUDA kernel on a card, its plain version on
    the CPU) on its block of rows, and (dirs, end_scores, end_mat) are
    concatenated in mesh order on every process.

    The caller pads the batch dim to a multiple of the mesh size
    (pad pairs have m_len == 0 and are ignored downstream).
    """
    import torch

    from ..ops.banded_cuda import banded_dp
    dtypes = (torch.uint8, torch.uint8, torch.int32, torch.int32,
              torch.int32)
    blocks = [_rows(mesh, x) for x in (q, t_shift, m_len, n_len, lo)]
    outs = []
    for j, s in enumerate(mesh.local):
        args = [b[j].to(dt) for b, dt in zip(blocks, dtypes)]
        sub = torch.as_tensor(np.asarray(submat), dtype=torch.int32,
                              device=s.device)
        outs.append(banded_dp(*args, sub, band=band, gap_open=gap_open,
                              gap_extend=gap_extend))
    return tuple(_gather_rows(mesh, torch.cat([o[f].to(mesh.home)
                                               for o in outs]))
                 for f in range(3))


def sharded_seed_join(mesh: Mesh, q_chunks, q_valid, t_codes, t_valid,
                      *, k: int, step: int, max_occ: int, max_anchors: int):
    """Each shard seed-joins its query chunk against the replicated target.

    q_chunks: (D, L) uint8 — one chunk per shard row.
    Returns (qpos, tpos, counts) of this process's shards, in mesh order
    ((D, A), (D, A), (D,) in one process), and the total over every shard
    (all_reduce), the collective replacing the reference's anchor-file
    concatenation count.
    """
    import torch

    from ..ops.seeds import seed_join
    qc, qv = put_global(mesh, q_chunks), put_global(mesh, q_valid)
    tc = put_global(mesh, t_codes, sharded=False)
    tv = put_global(mesh, t_valid, sharded=False)
    outs = [seed_join(qc[j], qv[j], tc[j], tv[j], k=k, step=step,
                      max_occ=max_occ, max_anchors=max_anchors,
                      device=s.device)
            for j, s in enumerate(mesh.local)]
    qpos, tpos, n = (torch.stack([o[f].to(mesh.home) for o in outs])
                     for f in range(3))
    return qpos, tpos, n, _sum_all(mesh, n.sum(dtype=torch.int32))


def sharded_pair_seed_join(mesh: Mesh, q_codes, q_valid, t_codes, t_valid,
                           *, k: int, step: int, max_occ: int,
                           max_anchors: int, pattern: str = ""):
    """Seed-join D independent (query, target) chunk pairs, one per shard.

    Unlike sharded_seed_join (one target replicated), BOTH sides are
    sharded: row d of q_codes (D, Lq) joins row d of t_codes (D, Lt).
    This is the driver's chunk-pair grid unit (the reference fans the
    same grid out as Toil jobs, local_alignment.py:370-408).  Results
    are independent of shard placement, so N-shard == 1-shard output
    is bit-identical by construction.

    Multi-process: every process holds the same full host arrays, joins
    its own shards' rows, and the count-prefixed tables come back to
    every process by all_gathers in rank order — the collectives
    replacing the reference's anchor-file concatenation: first the
    counts, then the tables cut to the largest count (a fixed shape on
    every process; past a row's count its slots are -1 as the join
    leaves them).

    Returns (qpos (D, A), tpos (D, A), counts (D,)) int32 tensors.
    """
    import torch

    from ..ops.seeds import seed_join_batch
    ins = [put_global(mesh, a) for a in (q_codes, q_valid, t_codes, t_valid)]
    outs = []
    for j, s in enumerate(mesh.local):
        outs.append(seed_join_batch(
            *(x[j][None] for x in ins), k=k, step=step, max_occ=max_occ,
            max_anchors=max_anchors, pattern=pattern, device=s.device))
    counts = _gather_rows(mesh, torch.cat([o[2].to(mesh.home)
                                           for o in outs]))
    w = int(counts.max())
    tables = []
    for f in range(2):
        cut = _gather_rows(mesh, torch.cat([o[f][:, :w].to(mesh.home)
                                            for o in outs]))
        tables.append(torch.nn.functional.pad(cut, (0, max_anchors - w),
                                              value=-1))
    return tables[0], tables[1], counts


def full_pipeline_step(mesh: Mesh, q_chunks, q_valid, t_codes, t_valid,
                       q_dp, t_dp, m_len, n_len, lo, submat,
                       *, k: int, step: int, max_occ: int, max_anchors: int,
                       band: int, gap_open: int, gap_extend: int):
    """One step of the production alignment pipeline over the mesh:

      seed-join (sharded over query chunks) → anchor-count all_reduce →
      banded DP (sharded over the pair batch) → end-score all_gather.

    Returns (total anchors, every pair's end scores (P, 3) in mesh order,
    this process's shards' dirs).  This is the multi-device path the
    dry run drives; the real progressive driver calls the two stages
    separately with host-side chaining between them (anchors → chains →
    DP gap-fill).
    """
    import torch

    from ..ops.banded_cuda import banded_dp
    _qpos, _tpos, _n, total = sharded_seed_join(
        mesh, q_chunks, q_valid, t_codes, t_valid, k=k, step=step,
        max_occ=max_occ, max_anchors=max_anchors)
    dtypes = (torch.uint8, torch.uint8, torch.int32, torch.int32,
              torch.int32)
    blocks = [_rows(mesh, x) for x in (q_dp, t_dp, m_len, n_len, lo)]
    dirs, scores = [], []
    for j, s in enumerate(mesh.local):
        sub = torch.as_tensor(np.asarray(submat), dtype=torch.int32,
                              device=s.device)
        d, sc, _m = banded_dp(*(b[j].to(dt) for b, dt in zip(blocks, dtypes)),
                              sub, band=band, gap_open=gap_open,
                              gap_extend=gap_extend)
        dirs.append(d.to(mesh.home))
        scores.append(sc.to(mesh.home))
    all_scores = _gather_rows(mesh, torch.cat(scores))
    return total, all_scores, torch.cat(dirs)
