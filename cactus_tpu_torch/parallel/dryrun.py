"""Entry points for a single-card check and a multi-device dry run.

    [torchrun --nproc-per-node P] python -m cactus_tpu_torch.parallel.dryrun
        [N] [--device cpu]

entry() exposes the flagship compute kernel (batched banded affine DP —
the lastz/cPecan replacement, ops/banded_cuda.py) as a function with
example arguments on the device.

dryrun_multichip(n) runs one step of the sharded pipeline (seed join and
banded DP over an n-shard mesh, with all_reduce / all_gather merges) on
tiny shapes, then one ancestor step of the progressive driver with its
blast chunk-pair grid sharded over the same mesh, and holds it bit for
bit to the one-device run.  These are the counterparts of the JAX
package's __graft_entry__.py.  Launched by torchrun (or with MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK set), `main` first joins the process
group (parallel/distributed.py), and the dry run's merges go through its
collectives.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def entry(device=None):
    """(fn, args): banded_dp with its keyword arguments bound, and eight
    random pairs packed at band 128 on `device` (None: the current CUDA
    device)."""
    import torch

    from ..config import PoaParams
    from ..ops import resolve_device
    from ..ops.banded import pack_band_batch, score_matrix_6
    from ..ops.banded_cuda import banded_dp

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 4, 192).astype(np.uint8),
              rng.integers(0, 4, 200).astype(np.uint8)) for _ in range(8)]
    band = 128
    packed = pack_band_batch(pairs, band)
    submat = score_matrix_6(PoaParams().sub_matrix)
    args = tuple(torch.as_tensor(packed[k], dtype=dt, device=dev)
                 for k, dt in (("q", torch.uint8), ("t_shift", torch.uint8),
                               ("m_len", torch.int32), ("n_len", torch.int32),
                               ("lo", torch.int32)))
    args += (torch.as_tensor(submat, dtype=torch.int32, device=dev),)
    fn = partial(banded_dp, band=band, gap_open=400, gap_extend=30)
    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded pipeline step and one sharded ancestor step over an
    n-shard mesh (`make_mesh(n_devices, device=device)`, which raises
    when the process lacks the cards); raises AssertionError when a
    check fails."""
    from ..config import PoaParams
    from ..ops import resolve_device
    from ..ops.banded import pack_band_batch, score_matrix_6
    from .mesh import full_pipeline_step, make_mesh

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, device=dev)
    rng = np.random.default_rng(0)

    # seed stage: one tiny query chunk per shard + replicated target;
    # chunks are rotations of the target so the join finds real anchors
    L, k = 256, 11
    t_codes = rng.integers(0, 4, L).astype(np.uint8)
    t_valid = np.ones(L, dtype=bool)
    q_chunks = np.stack([np.roll(t_codes, 7 * d) for d in range(n_devices)])
    q_valid = np.ones((n_devices, L), dtype=bool)

    # DP stage: pair batch sharded over shards
    pairs = [(rng.integers(0, 4, 48).astype(np.uint8),
              rng.integers(0, 4, 52).astype(np.uint8))
             for _ in range(2 * n_devices)]
    band = 128
    packed = pack_band_batch(pairs, band)
    # pad batch to a multiple of the mesh
    P_total = -(-packed["q"].shape[0] // n_devices) * n_devices
    pad = P_total - packed["q"].shape[0]
    if pad:
        for key in ("q", "t_shift"):
            packed[key] = np.pad(packed[key], ((0, pad), (0, 0)),
                                 constant_values=5)
        for key in ("m_len", "n_len", "lo"):
            packed[key] = np.pad(packed[key], (0, pad))
    submat = score_matrix_6(PoaParams().sub_matrix)

    total, all_scores, _dirs = full_pipeline_step(
        mesh, q_chunks, q_valid, t_codes, t_valid,
        packed["q"], packed["t_shift"], packed["m_len"], packed["n_len"],
        packed["lo"], submat,
        k=k, step=1, max_occ=16, max_anchors=1 << 12,
        band=band, gap_open=400, gap_extend=30)
    assert int(total) > 0, "seed join found no anchors on the dry run"
    assert all_scores.shape[0] == P_total

    # full training-step equivalent: one ancestor step of the progressive
    # driver with its blast chunk-pair grid sharded over the same mesh
    from .. import progressive
    from ..config import Config
    from ..io.fasta import Sequence
    from ..testutil import evolver
    from ..utils.trees import parse_newick

    tree = parse_newick("(a:0.02,b:0.02)root;")
    sim = evolver.simulate(tree, root_len=1500, seed=3)
    genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in ["a", "b"]}
    cfg = Config.default()
    cfg.blast.chunk_size = 1024
    cfg.blast.overlap_size = 128
    result = progressive.ProgressiveAligner(
        tree, genomes, config=cfg, min_chain_override=64,
        n_devices=n_devices, device=dev).run()
    assert int(result.steps["root"].caf.alive.sum()) > 0, \
        "multichip ancestor step produced no blocks"

    # strong check: the n-shard step is BIT-IDENTICAL to one device
    # (deterministic mesh-order merges)
    base = progressive.ProgressiveAligner(
        tree, genomes, config=cfg, min_chain_override=64,
        n_devices=None, device=dev).run()
    s1, sn = base.steps["root"], result.steps["root"]
    np.testing.assert_array_equal(s1.caf.alive, sn.caf.alive)
    for f in ("seg_block", "seg_seq", "seg_start", "seg_len",
              "seg_strand"):
        np.testing.assert_array_equal(getattr(s1.caf.blocks, f),
                                      getattr(sn.caf.blocks, f))
    for name, m1 in s1.maps.items():
        mn = sn.maps[name]
        np.testing.assert_array_equal(m1.tgt_idx, mn.tgt_idx)
        np.testing.assert_array_equal(m1.tgt_pos, mn.tgt_pos)
        np.testing.assert_array_equal(m1.strand, mn.strand)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="banded_dp on the device, "
                                 "then the sharded dry run")
    ap.add_argument("n", type=int, nargs="?", default=1,
                    help="mesh size (default 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    opts = ap.parse_args(argv)
    from . import distributed
    grouped = distributed.initialize(device=opts.device, log=print)
    try:
        fn, args = entry(opts.device)
        fn(*args)
        dryrun_multichip(opts.n, device=opts.device)
    finally:
        distributed.shutdown()
    print(f"dry run on {opts.n} shard(s) "
          f"{'in a process group' if grouped else 'in one process'}: ok",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
