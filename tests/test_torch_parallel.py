"""The port's multi-device runtime (parallel/*) on the CPU.

The mirror of tests/test_parallel.py on a mesh of 8 logical CPU shards
(what the JAX tests get from --xla_force_host_platform_device_count=8),
the multi-chip driver workload of tests/test_multichip_driver.py on 1
and 8 shards against the JAX package's MAF, and the two-process run of
tests/test_multihost.py::test_two_process_full_pipeline over gloo.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops.banded import (banded_align_batch, pack_band_batch,
                                         score_matrix_6)
from cactus_tpu_torch.parallel import distributed as dist
from cactus_tpu_torch.parallel.mesh import (make_mesh, sharded_banded_align,
                                            sharded_pair_seed_join,
                                            sharded_seed_join)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEWICK = "((a:0.03,b:0.03)ab:0.02,c:0.05)root;"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


def _packed(seed, n=16):
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 4, 60).astype(np.uint8),
              rng.integers(0, 4, 64).astype(np.uint8)) for _ in range(n)]
    packed = pack_band_batch(pairs, 128)
    args = [torch.as_tensor(packed[k], dtype=dt) for k, dt in
            (("q", torch.uint8), ("t_shift", torch.uint8),
             ("m_len", torch.int32), ("n_len", torch.int32),
             ("lo", torch.int32))]
    submat = torch.as_tensor(score_matrix_6(PoaParams().sub_matrix),
                             dtype=torch.int32)
    return pairs, args, submat


def test_mesh_lists_shards_in_rank_order(mesh):
    assert len(mesh.devices.flat) == 8 and mesh.shape == {"d": 8}
    assert [s.index for s in mesh.devices.flat] == list(range(8))
    assert all(s.rank == 0 and s.device == torch.device("cpu")
               for s in mesh.local)


def test_sharded_banded_matches_single_device(mesh):
    from cactus_tpu.ops.banded import GapParams, align_affine_np
    pairs, args, submat = _packed(0)
    d1, s1, m1 = banded_align_batch(*args, submat, band=128, gap_open=400,
                                    gap_extend=30)
    d8, s8, m8 = sharded_banded_align(mesh, *args, submat, band=128,
                                      gap_open=400, gap_extend=30)
    assert torch.equal(s1, s8) and torch.equal(d1, d8)
    assert torch.equal(m1, m8)
    # and the scores are correct vs the JAX package's numpy oracle
    for p in (0, 7, 15):
        want, _ = align_affine_np(pairs[p][0], pairs[p][1], submat.numpy(),
                                  GapParams(400, 30))
        assert int(s8[p, int(m8[p])]) == want


def test_sharded_seed_join_counts(mesh):
    rng = np.random.default_rng(1)
    t = rng.integers(0, 4, 256).astype(np.uint8)
    # every shard's chunk is a copy of the target → many anchors
    q = np.stack([t] * 8)
    qpos, tpos, counts, total = sharded_seed_join(
        mesh, q, np.ones_like(q, dtype=bool), t, np.ones(256, dtype=bool),
        k=11, step=1, max_occ=16, max_anchors=1 << 12)
    assert counts.shape == (8,) and qpos.shape == (8, 1 << 12)
    assert int(total) == int(counts.sum())
    assert int(total) >= 8 * (256 - 11 + 1)  # at least the true diagonal


def test_sharded_pair_seed_join_equals_the_batch(mesh):
    from cactus_tpu_torch.ops.seeds import seed_join_batch
    rng = np.random.default_rng(2)
    q = rng.integers(0, 4, (8, 300)).astype(np.uint8)
    t = np.stack([np.roll(r, 5 * i) for i, r in enumerate(q)])
    v = np.ones((8, 300), bool)
    v[3, 40:90] = False
    got = sharded_pair_seed_join(mesh, q, v, t, v, k=11, step=1,
                                 max_occ=16, max_anchors=1 << 10)
    want = seed_join_batch(q, v, t, v, k=11, step=1, max_occ=16,
                           max_anchors=1 << 10, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_full_pipeline_step_runs():
    from cactus_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu")


def test_entry_runs():
    from cactus_tpu_torch.parallel.dryrun import entry
    fn, args = entry("cpu")
    dirs, scores, mat = fn(*args)
    assert dirs.shape[0] == scores.shape[0] == mat.shape[0] == 8


def test_make_mesh_never_falls_back_to_the_cpu():
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(2)
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(2, device="cuda")
    from cactus_tpu_torch.progressive import ProgressiveAligner
    from cactus_tpu_torch.utils.trees import parse_newick
    with pytest.raises((RuntimeError, ValueError)):
        ProgressiveAligner(parse_newick("(a:0.1,b:0.1)r;"), {}, n_devices=2)


def test_distributed_noop_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert dist.initialize() is False
    assert dist.is_primary()
    assert dist.process_count() == 1


def test_host_device_mesh_cpu():
    mesh = dist.host_device_mesh(device="cpu")
    assert mesh.shape["h"] * mesh.shape["d"] == dist.process_count()
    assert dist.global_mesh(device="cpu").shape["d"] == dist.process_count()


def test_scaling_report(mesh):
    rep = dist.scaling_report(mesh, t_one=10.0, t_mesh=10.0 / 8)
    assert rep["efficiency"] == 1.0
    rep = dist.scaling_report(mesh, t_one=10.0, t_mesh=12.5 / 8)
    assert abs(rep["efficiency"] - 0.8) < 1e-6


def _workload(pkg):
    """The multi-chip driver workload (6 kb, chunk_size 2048) through the
    named package's modules."""
    mods = {}
    for m in ("progressive", "config", "io.fasta", "phases.hal",
              "testutil.evolver", "utils.trees"):
        mods[m] = __import__(f"{pkg}.{m}", fromlist=["x"])
    tree = mods["utils.trees"].parse_newick(NEWICK)
    sim = mods["testutil.evolver"].simulate(tree, root_len=6000, seed=11)
    Seq = mods["io.fasta"].Sequence
    genomes = {ev: {f"{ev}.c": Seq(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in ["a", "b", "c"]}
    cfg = mods["config"].Config.default()
    cfg.blast.chunk_size = 2048
    cfg.blast.overlap_size = 256
    return mods, tree, genomes, cfg


def _maf(pkg, path, **kw):
    mods, tree, genomes, cfg = _workload(pkg)
    result = mods["progressive"].ProgressiveAligner(
        tree, genomes, config=cfg, min_chain_override=64, **kw).run()
    mods["phases.hal"].write_hal2maf(str(path), result)
    return result, open(path, "rb").read()


@pytest.fixture(scope="module")
def jax_maf(tmp_path_factory):
    _r, maf = _maf("cactus_tpu", tmp_path_factory.mktemp("mc") / "jax.maf")
    assert maf.count(b"\ns ") > 0
    return maf


def test_full_step_identical_1_vs_8_shards_and_to_jax(tmp_path, jax_maf):
    r1, maf1 = _maf("cactus_tpu_torch", tmp_path / "d1.maf", device="cpu")
    r8, maf8 = _maf("cactus_tpu_torch", tmp_path / "d8.maf", device="cpu",
                    n_devices=8)
    assert maf1 == maf8 == jax_maf
    s1, s8 = r1.steps["root"], r8.steps["root"]
    np.testing.assert_array_equal(s1.caf.alive, s8.caf.alive)
    for f in ("seg_block", "seg_seq", "seg_start", "seg_len", "seg_strand"):
        np.testing.assert_array_equal(getattr(s1.caf.blocks, f),
                                      getattr(s8.caf.blocks, f))
    assert int(s1.caf.alive.sum()) > 0


_PIPELINE_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[4])
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
from cactus_tpu_torch.parallel import distributed as dist
ok = dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid, backend="gloo",
                     device="cpu")
assert ok and dist.process_count() == 2 and dist.is_primary() == (pid == 0)
import test_torch_parallel as t
result, _maf = t._maf("cactus_tpu_torch", out, device="cpu", n_devices=2)
dist.shutdown()
"""


def test_two_process_full_pipeline(tmp_path, jax_maf):
    """The complete ancestor pipeline under 2 gloo ranks, one shard each:
    every rank's MAF equals the one-process (and the JAX package's)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    wpath = tmp_path / "pipeline_worker.py"
    wpath.write_text(_PIPELINE_WORKER)
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"pipe{pid}.maf"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(wpath), str(pid), str(port), str(out),
             os.path.join(REPO, "tests")], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-4000:]
    for out in outs:
        assert out.read_bytes() == jax_maf
