"""The port's seed join (ops/seeds.py and the blast phase's batched device
join) against the JAX package's, on the CPU.

The same seeded inputs go through cactus_tpu's jitted XLA functions and
cactus_tpu_torch's PyTorch ops with device="cpu": hashes, anchor tables
and counts must be equal (integers, bit for bit), and the batched device
join's anchors must equal the host numpy join's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cactus_tpu.config import Config as JConfig
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.ops import seeds as jseeds
from cactus_tpu.phases import blast as jblast
from cactus_tpu_torch.config import SEED_12_OF_19, SEED_MIXED_19BIT
from cactus_tpu_torch.config import Config as TConfig
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.ops import seeds as tseeds
from cactus_tpu_torch.phases import blast as tblast

# at most 1 << 14 anchor slots: the JAX join compiles once per capacity
CAP = 1 << 12


def _inputs(seed, L, n_frac=0.03, mask_frac=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.random(L) < n_frac] = 4
    valid = rng.random(L) >= mask_frac
    return codes, valid


def _related(seed, L, rep=True):
    """A query with a repeat family and a target sharing most of it."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, L).astype(np.uint8)
    if rep:
        unit = rng.integers(0, 4, 40).astype(np.uint8)
        for at in range(64, L - 40, 200):
            q[at:at + 40] = unit
    t = q.copy()
    sub = rng.random(L) < 0.08
    t[sub] = rng.integers(0, 4, int(sub.sum()))
    t[L // 3:L // 3 + 50] = 4
    qv = np.ones(L, bool)
    tv = np.ones(L, bool)
    qv[10:30] = False
    tv[L // 2:L // 2 + 25] = False
    return q, qv, t, tv


@pytest.mark.parametrize("k,pattern,step", [
    (11, "", 1), (12, "", 1), (13, "", 3), (14, "", 1), (15, "", 1),
    (15, "", 3), (15, SEED_12_OF_19, 1), (15, SEED_12_OF_19, 3),
    (15, SEED_MIXED_19BIT, 1), (15, SEED_MIXED_19BIT, 3)])
def test_kmer_hashes_equal_jax(k, pattern, step):
    codes, valid = _inputs(k * 7 + step, 777)
    jh, jp = jseeds.kmer_hashes(codes, valid, k, step, pattern)
    th, tp = tseeds.kmer_hashes(codes, valid, k, step, pattern,
                                device="cpu")
    assert th.dtype == torch.int32 and tp.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert (th.numpy() == tseeds.INVALID_Q).any()
    assert (th.numpy() != tseeds.INVALID_Q).any()


def test_kmer_hashes_refuse_more_than_30_bits():
    codes, valid = _inputs(1, 64)
    with pytest.raises(ValueError, match="exceed 30"):
        tseeds.kmer_hashes(codes, valid, 16, 1, device="cpu")


@pytest.mark.parametrize("max_occ,max_anchors,pattern,step", [
    (1, CAP, "", 1), (64, CAP, "", 1), (64, CAP, SEED_12_OF_19, 3),
    (64, 300, "", 1)])
def test_seed_join_equals_jax(max_occ, max_anchors, pattern, step):
    q, qv, t, tv = _related(max_occ + max_anchors, 1024)
    j = jseeds.seed_join(q, qv, t, tv, k=11, step=step, max_occ=max_occ,
                         max_anchors=max_anchors, pattern=pattern)
    t_ = tseeds.seed_join(q, qv, t, tv, k=11, step=step, max_occ=max_occ,
                          max_anchors=max_anchors, pattern=pattern,
                          device="cpu")
    for a, b in zip(j, t_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = int(t_[2])
    assert n > 0
    if max_anchors == 300:
        assert n == 300           # the table overflowed at its capacity
    else:
        assert n < max_anchors and (t_[0][n:] == -1).all()


@pytest.mark.parametrize("what", ["all_invalid", "no_hits", "n_only"])
def test_seed_join_empty_inputs_equal_jax(what):
    L = 512
    q, qv, t, tv = _related(5, L, rep=False)
    if what == "all_invalid":
        qv[:] = False
    elif what == "no_hits":
        t = (q + 1) % 4
    else:
        t[:] = 4
    j = jseeds.seed_join(q, qv, t, tv, k=13, max_occ=64, max_anchors=256)
    t_ = tseeds.seed_join(q, qv, t, tv, k=13, max_occ=64, max_anchors=256,
                          device="cpu")
    for a, b in zip(j, t_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(t_[2]) == 0


@pytest.mark.parametrize("max_occ,max_anchors", [(1, CAP), (64, CAP),
                                                 (64, 512)])
def test_seed_join_batch_equals_jax(max_occ, max_anchors):
    rows = [_related(s, 1024) for s in range(3)]
    qc, qv, tc, tv = (np.stack([r[f] for r in rows]) for f in range(4))
    j = jseeds.seed_join_batch(qc, qv, tc, tv, k=12, step=1,
                               max_occ=max_occ, max_anchors=max_anchors)
    t_ = tseeds.seed_join_batch(qc, qv, tc, tv, k=12, step=1,
                                max_occ=max_occ, max_anchors=max_anchors,
                                device="cpu")
    for a, b in zip(j, t_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for row in range(3):
        one = tseeds.seed_join(qc[row], qv[row], tc[row], tv[row], k=12,
                               max_occ=max_occ, max_anchors=max_anchors,
                               device="cpu")
        np.testing.assert_array_equal(one[0].numpy(), t_[0][row].numpy())


def _tasks(pkg_blast, Sequence, cfg):
    """Both strands of three chunk pairs: two bins (1024 and 2048 padded
    targets), one query masked, one pair of unrelated sequences."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, 1500).astype(np.uint8)
    b = a.copy()
    sub = rng.random(1500) < 0.1
    b[sub] = rng.integers(0, 4, int(sub.sum()))
    mask = np.zeros(1500, bool)
    mask[200:400] = True
    c = rng.integers(0, 4, 1000).astype(np.uint8)
    tasks = []
    tasks += pkg_blast.pair_tasks(Sequence("q", a, mask=mask),
                                  Sequence("t", b), "q", "t", cfg,
                                  preset="default")
    tasks += pkg_blast.pair_tasks(Sequence("q2", a[:900]), Sequence("t", b),
                                  "q2", "t", cfg, preset="one")
    tasks += pkg_blast.pair_tasks(Sequence("u", c), Sequence("v", a[:1000]),
                                  "u", "v", cfg, preset="default")
    return tasks


@pytest.mark.parametrize("aligner", ["lastz", "fastga"])
def test_device_join_batch_equals_jax_and_the_host_join(aligner):
    jcfg = dataclasses.replace(JConfig.default().blast, aligner=aligner)
    tcfg = dataclasses.replace(TConfig.default().blast, aligner=aligner)
    jt = _tasks(jblast, JSequence, jcfg)
    tt = _tasks(tblast, TSequence, tcfg)
    idxs = list(range(len(tt)))
    max_occ = 1 if aligner == "fastga" else 64
    jout, tout = [None] * len(jt), [None] * len(tt)
    jblast._device_join_batch(jt, idxs, jout, jcfg, max_occ,
                              lambda lq: CAP, None)
    # a budget of one task's bytes splits every bin into sub-batches of 1
    budget = tblast.join_bytes_per_task(2048, 2048, CAP)
    batches = []
    real = tseeds.seed_join_batch

    def spy(qc, *a, **kw):
        batches.append(qc.shape[0])
        return real(qc, *a, **kw)

    tseeds.seed_join_batch = spy
    try:
        tblast._device_join_batch(tt, idxs, tout, tcfg, max_occ,
                                  lambda lq: CAP, None, "cpu", budget=budget)
    finally:
        tseeds.seed_join_batch = real
    assert batches and max(batches) == 1 and len(batches) == len(tt)
    host = tblast.anchors_for_tasks(tt, tcfg, device="cpu")
    for i, ((jq, jp), (tq, tp), (hq, hp)) in enumerate(zip(jout, tout,
                                                           host)):
        assert tq.dtype == np.int32
        np.testing.assert_array_equal(np.asarray(jq), tq)
        np.testing.assert_array_equal(np.asarray(jp), tp)
        np.testing.assert_array_equal(hq, tq)
        np.testing.assert_array_equal(hp, tp)
    assert sum(len(x[0]) for x in tout) > 0
    # one call with the whole budget: one launch set a bin, same anchors
    whole = [None] * len(tt)
    tblast._device_join_batch(tt, idxs, whole, tcfg, max_occ,
                              lambda lq: CAP, None, "cpu")
    for (a, b), (c, d) in zip(whole, tout):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_device_join_warns_on_overflow():
    tcfg = TConfig.default().blast
    tt = _tasks(tblast, TSequence, tcfg)[:1]
    out, logged = [None], []
    with pytest.warns(RuntimeWarning, match="anchor table overflow"):
        tblast._device_join_batch(tt, [0], out, tcfg, 64, lambda lq: 64,
                                  logged.append, "cpu")
    assert len(out[0][0]) == 64 and logged


def test_anchors_on_the_cpu_take_the_host_join(monkeypatch):
    tcfg = TConfig.default().blast
    tcfg = dataclasses.replace(
        tcfg, seed=dataclasses.replace(tcfg.seed, device_join_threshold=1))
    tt = _tasks(tblast, TSequence, tcfg)

    def refuse(*a, **kw):
        raise AssertionError("the device join ran on the CPU")

    monkeypatch.setattr(tblast, "_device_join_batch", refuse)
    got = tblast.anchors_for_tasks(tt, tcfg, device="cpu")
    assert all(g is not None for g in got)
    if not torch.cuda.is_available():
        # the default device is CUDA: past the threshold it must raise,
        # not fall back to the host join
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tblast.anchors_for_tasks(tt, tcfg)
