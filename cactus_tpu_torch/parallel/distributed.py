"""Multi-process runtime initialization (the Toil leader/worker analog).

The reference distributes phases as Toil jobs over a shared jobstore
(SURVEY §2.4, §5); here the runtime is one program run by every process
of a `torch.distributed` group (as `torchrun` starts them): `initialize`
joins the group, after which parallel/mesh.py's meshes list every
rank's shards in rank order, and the sharded steps gather their results
in that order on every rank.

The backend follows the device: `nccl` for CUDA, `gloo` for the CPU.
NCCL refuses two ranks on one card, so ranks that share a card name
`gloo` (the `backend` argument, or CACTUS_DIST_BACKEND=gloo in the
environment); their collectives then go through host copies.

Single-process runs (tests, one-card runs) need no initialization;
every entry point here degrades to a no-op in that case.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import Mesh, make_mesh

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None,
               log=lambda m: None) -> bool:
    """Join the process group if configured; else no-op.

    Configuration comes from the arguments or the environment `torchrun`
    sets (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).
    coordinator_address is "host:port" of rank 0.  backend: "nccl" or
    "gloo"; default CACTUS_DIST_BACKEND, else nccl when `device` (None:
    the current CUDA device) is a CUDA device and gloo on the CPU.  Under
    nccl each rank takes the card LOCAL_RANK (default: rank modulo the
    cards).  Returns True when running in a process group."""
    import torch
    import torch.distributed as dist

    from ..ops import resolve_device
    global _initialized
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if _initialized:
        return True
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("RANK", "0")))
    backend = backend or os.environ.get("CACTUS_DIST_BACKEND")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    log(f"torch.distributed: process {dist.get_rank()}/"
        f"{dist.get_world_size()}, backend {backend}")
    return True


def shutdown() -> None:
    """Leave the process group `initialize` joined (no-op otherwise)."""
    import torch.distributed as dist
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that does file I/O / logging (rank 0)."""
    return _rank_world()[0] == 0


def process_count() -> int:
    return _rank_world()[1]


def global_mesh(axis: str = "d", device=None) -> Mesh:
    """1-D mesh over every shard of every process (data-parallel axis for
    the chunk-pair grid): `make_mesh` with its default count."""
    return make_mesh(None, axis, device=device)


def host_device_mesh(host_axis: str = "h", device_axis: str = "d",
                     device=None) -> Mesh:
    """2-D (processes × local shards) mesh: shard coarse work (ancestors,
    chromosome batches) over `h` across processes, fine work (pair
    batches) over `d` within one — the scaling-book hybrid-mesh recipe."""
    flat = make_mesh(None, device_axis, device=device)
    n_proc = flat.world
    per_host = len(flat.devices.flat) // n_proc
    return Mesh(flat.devices.reshape(n_proc, per_host),
                (host_axis, device_axis), flat.world, flat.rank)


def scaling_report(mesh: Mesh, t_one: float, t_mesh: float) -> dict:
    """Scaling-efficiency record for the BASELINE north-star
    (≥0.8 efficiency at 2 hosts): efficiency = t_one / (N * t_mesh)."""
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    eff = t_one / (n * t_mesh) if t_mesh > 0 else 0.0
    return dict(n_devices=n, t_one_s=t_one, t_mesh_s=t_mesh,
                efficiency=round(float(eff), 4))
