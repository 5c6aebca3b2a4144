"""The PyTorch port's partial-order alignment and poa BAR engine against
the JAX package (CPU).

The same numpy inputs go through cactus_tpu.ops.poa (its XLA scans,
which tests/test_poa_pallas.py holds equal to the Pallas kernels in
interpret mode) and cactus_tpu_torch.ops.poa (the plain PyTorch versions
that the CUDA kernels are held to on the card).  The integer DPs must be
bit-identical on every cell, pad nodes and columns past a problem's query
included; the graphs built from them, the poa engine's BAR blocks and a
whole progressive run on a star tree (which runs round 2 of the
progressive POA) must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cactus_tpu import progressive as jprog
from cactus_tpu.config import BarParams as JBarParams
from cactus_tpu.config import BlastParams as JBlastParams
from cactus_tpu.config import CafParams as JCafParams
from cactus_tpu.config import Config as JConfig
from cactus_tpu.config import PoaParams as JPoaParams
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.ops import poa as jpoa
from cactus_tpu.ops.banded import score_matrix_6
from cactus_tpu.ops.poa_pallas import _chain_check_np
from cactus_tpu.phases import bar as jbar
from cactus_tpu.phases import blast as jblast
from cactus_tpu.phases import caf as jcaf
from cactus_tpu.phases import hal as jhal
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import progressive as tprog
from cactus_tpu_torch.config import (BarParams, BlastParams, CafParams,
                                     PoaParams, config_from_numpy)
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.ops import poa as tpoa
from cactus_tpu_torch.ops import poa_cuda
from cactus_tpu_torch.phases import bar as tbar
from cactus_tpu_torch.phases import blast as tblast
from cactus_tpu_torch.phases import caf as tcaf
from cactus_tpu_torch.phases import hal as thal
from cactus_tpu_torch.utils.trees import parse_newick as tparse_newick
from test_torch_pecan import _assert_blocks_equal

MP = jpoa.MAX_PREDS
SUB = score_matrix_6(JPoaParams().sub_matrix).astype(np.int32)
GAPS = dict(o1=400, e1=30, o2=1200, e2=1)


def _random_dag(rng, n, branchy=0.3, forward=0):
    """Mostly a chain with bubbles; `forward` predecessors point at
    higher node indices, as add_alignment can make them."""
    bases = rng.integers(0, 4, n).astype(np.uint8)
    preds = np.full((n, MP), -1, np.int32)
    for v in range(1, n):
        preds[v, 0] = v - 1
        k = 1
        while k < MP and v > 2 and rng.random() < branchy:
            preds[v, k] = int(rng.integers(0, v - 1))
            k += 1
    for _ in range(forward):
        v = int(rng.integers(1, n - 2))
        free = np.flatnonzero(preds[v] < 0)
        if len(free):
            preds[v, free[0]] = int(rng.integers(v + 1, n))
    return bases, preds


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,n,l,forward", [
    (0, 40, 33, 0), (1, 96, 70, 3), (2, 64, 128, 0), (3, 24, 40, 2),
    (4, 1, 17, 0)])
def test_poa_align_scan_identical(seed, n, l, forward):
    rng = np.random.default_rng(seed)
    bases, preds = _random_dag(rng, n, forward=forward)
    q = rng.integers(0, 4, l).astype(np.uint8)
    kw = dict(gap=30, match=10, mismatch=-15)
    jout = jpoa.poa_align_scan(jnp.asarray(bases), jnp.asarray(preds),
                               jnp.asarray(q), **kw)
    tout = tpoa.poa_align_scan(*_tensors(bases, preds, q), **kw)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the CPU wrapper is the plain version
    for a, b in zip(tout, poa_cuda.poa_linear(*_tensors(bases, preds, q),
                                              **kw)):
        assert torch.equal(a, b)


def _affine_batch(rng, P, n, l, band, chain=False, big_steps=False):
    """P problems of ragged query length (l, l-7, ...) padded to l+1
    codes, with bubbled DAGs (forward preds included) or chains followed
    by source pad nodes, and monotone band offsets when band < L+1."""
    bases = np.zeros((P, n), np.uint8)
    preds = np.full((P, n, MP), -1, np.int32)
    off = np.zeros((P, n), np.int32)
    q_ext = np.full((P, l + 1), 5, np.uint8)
    l_len = np.zeros(P, np.int32)
    for i in range(P):
        li = max(1, l - 7 * i)
        if chain:
            real = max(1, n - 5 * i)
            bases[i, :real] = rng.integers(0, 4, real)
            preds[i, 1:real, 0] = np.arange(real - 1)
        else:
            bases[i], preds[i] = _random_dag(rng, n, forward=2)
        q_ext[i, 1:li + 1] = rng.integers(0, 4, li)
        l_len[i] = li
        if band < li + 1:
            steps = rng.integers(0, 4 if big_steps else 2, n)
            steps[0] = 0
            off[i] = np.minimum(np.cumsum(steps), li + 1 - band)
    return bases, preds, off, q_ext, l_len


def _jax_affine(bases, preds, off, q_ext, l_len, band):
    """The JAX package's batch route off the TPU (poa_msa_batch :705-710):
    the XLA scan vmapped over problems."""
    sm = jnp.asarray(SUB)
    run = jax.vmap(lambda b, pr, of, qe, ll: jpoa.poa_align_scan_affine(
        b, pr, of, qe, sm, band=band, l_len=ll, **GAPS))
    return [np.asarray(x) for x in run(*(jnp.asarray(a) for a in (
        bases, preds, off, q_ext, l_len)))]


@pytest.mark.parametrize("seed,P,n,l,band,big_steps", [
    (0, 3, 40, 33, 64, False),     # full width (B >= L+1)
    (1, 3, 80, 200, 64, True),     # banded, offset jumps up to 3
    (2, 2, 64, 100, 128, False),   # banded, B < Bp-style widths
    (3, 4, 17, 40, 64, False)])
def test_poa_align_scan_affine_identical(seed, P, n, l, band, big_steps):
    rng = np.random.default_rng(seed)
    inputs = _affine_batch(rng, P, n, l, band, big_steps=big_steps)
    H, dirs, ends = tpoa.poa_align_scan_affine(
        *_tensors(*inputs), torch.from_numpy(SUB), band=band, **GAPS)
    jH, jd, je = _jax_affine(*inputs, band)
    np.testing.assert_array_equal(jH, H.numpy())
    np.testing.assert_array_equal(jd.astype(np.int32),
                                  dirs.numpy().astype(np.int32))
    np.testing.assert_array_equal(je, ends.numpy())
    assert dirs.dtype == torch.int16 and int(dirs.max()) < 1 << 13


@pytest.mark.parametrize("seed,P,n,l,band", [
    (3, 3, 40, 48, 64), (4, 2, 24, 40, 128), (5, 4, 24, 150, 64)])
def test_chain_batches_identical(seed, P, n, l, band):
    """Chains followed by source pad nodes (the round-1 bins): the port's
    certificate admits them, the JAX package's does not."""
    rng = np.random.default_rng(seed)
    inputs = _affine_batch(rng, P, n, l, band, chain=True)
    bases, preds, off, q_ext, l_len = inputs
    assert poa_cuda.chain_certified(preds, off)
    assert not _chain_check_np(preds, off)
    sub = torch.from_numpy(SUB)
    got = poa_cuda.poa_chain(*_tensors(*inputs), sub, band=band, **GAPS)
    ref = _jax_affine(*inputs, band)
    np.testing.assert_array_equal(ref[0], got[0].numpy())
    np.testing.assert_array_equal(ref[1].astype(np.int32),
                                  got[1].numpy().astype(np.int32))
    np.testing.assert_array_equal(ref[2], got[2].numpy())


def test_chain_certificate():
    preds = np.full((2, 6, MP), -1, np.int32)
    preds[:, 1:4, 0] = np.arange(3)          # chain of 4, 2 pad sources
    off = np.zeros((2, 6), np.int32)
    off[:, 1:4] = [1, 1, 2]
    assert poa_cuda.chain_certified(preds, off)
    jump = off.copy()
    jump[1, 2] = 3                           # a step of 2 on a linked node
    assert not poa_cuda.chain_certified(preds, jump)
    skip = preds.copy()
    skip[0, 3, 0] = 1                        # a predecessor other than v-1
    assert not poa_cuda.chain_certified(skip, off)
    two = preds.copy()
    two[1, 2, 1] = 0                         # a second predecessor
    assert not poa_cuda.chain_certified(two, off)
    # a step after a source node does not matter
    src = off.copy()
    src[:, 4:] = 9
    assert poa_cuda.chain_certified(preds, src)


def test_chunked_bin_equals_single_launch():
    rng = np.random.default_rng(9)
    for chain in (True, False):
        inputs = _affine_batch(rng, 5, 16, 20, 64, chain=chain)
        stack = dict(zip(("bases", "preds", "off", "q_ext"), inputs[:4]))
        one = poa_cuda.align_bin(stack, inputs[4], SUB, 64, *GAPS.values(),
                                 device="cpu")
        per_problem = 16 * 64 * poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL
        chunked = poa_cuda.align_bin(stack, inputs[4], SUB, 64,
                                     *GAPS.values(), device="cpu",
                                     max_launch_bytes=2 * per_problem + 1)
        for a, b in zip(one, chunked):
            np.testing.assert_array_equal(a, b)


def _assert_same_graph(jg, tg):
    assert jg.bases == tg.bases
    assert jg.preds == tg.preds
    assert jg.group_of == tg.group_of
    assert jg.n_groups == tg.n_groups
    assert jg.depth == tg.depth
    assert len(jg.walks) == len(tg.walks)
    for a, b in zip(jg.walks, tg.walks):
        np.testing.assert_array_equal(a, b)


def _groups(seed, n_groups, lo=2, hi=5):
    """Groups of lo..hi related sequences with substitutions and indels."""
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(n_groups):
        base = rng.integers(0, 4, int(rng.integers(40, 260))).astype(np.uint8)
        seqs = []
        for _m in range(int(rng.integers(lo, hi + 1))):
            s = base.copy()
            idx = rng.random(len(s)) < 0.06
            s[idx] = (s[idx] + 1) % 4
            if rng.random() < 0.6 and len(s) > 40:
                a = int(rng.integers(5, len(s) - 30))
                s = np.concatenate([s[:a], s[a + int(rng.integers(2, 15)):]])
            if rng.random() < 0.4:
                a = int(rng.integers(0, len(s)))
                s = np.insert(s, a,
                              rng.integers(0, 4, int(rng.integers(1, 9))))
            seqs.append(s.astype(np.uint8))
        groups.append(seqs)
    return groups


def test_poa_align_and_affine_ops_identical():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 4, 120).astype(np.uint8)
    t = np.concatenate([s[:30], s[45:90], rng.integers(0, 4, 6), s[90:]])
    t[10] = (t[10] + 1) % 4
    jg, tg = jpoa.PoaGraph.from_sequence(s), tpoa.PoaGraph.from_sequence(s)
    assert (jpoa.poa_align(jg, t)
            == tpoa.poa_align(tg, t, device="cpu"))
    sub = score_matrix_6(JPoaParams().sub_matrix)
    assert (jpoa.poa_align_affine(jg, t, submat=sub)
            == tpoa.poa_align_affine(tg, t, submat=sub, device="cpu"))


@pytest.mark.parametrize("with_params", [False, True])
def test_poa_msa_identical(with_params):
    for seqs in _groups(7 + with_params, 3, lo=3, hi=5):
        jg = jpoa.poa_msa(seqs, params=JPoaParams() if with_params else None)
        tg = tpoa.poa_msa(seqs, params=PoaParams() if with_params else None,
                          device="cpu")
        _assert_same_graph(jg, tg)


def test_poa_msa_batch_identical(monkeypatch):
    """Mixed shape bins over rounds 1-4: chain bins take poa_chain, the
    bubbled graphs of later rounds poa_affine (the CPU wrappers run the
    plain version)."""
    calls = {"poa_chain": 0, "poa_affine": 0}
    for name in calls:
        def spy(*args, _fn=getattr(poa_cuda, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(poa_cuda, name, spy)
    groups = _groups(11, 6)
    jgs = jpoa.poa_msa_batch(groups, JPoaParams())
    tgs = tpoa.poa_msa_batch(groups, PoaParams(), device="cpu")
    for jg, tg in zip(jgs, tgs):
        _assert_same_graph(jg, tg)
    assert calls["poa_chain"] > 0 and calls["poa_affine"] > 0


def test_poa_run_bar_blocks_identical(monkeypatch):
    """tests/test_bar.py's poa engine case: a 2-genome 6 kb sim, seed 20,
    anchored and CAF-ed by each package."""
    sim = evolver.simulate(parse_newick("(a:0.05,b:0.05)root;"),
                           root_len=6_000, seed=20)
    codes = {g: sim.genomes[g].codes for g in ("a", "b")}
    lengths = {f"{g}.c": len(c) for g, c in codes.items()}
    jrecs = jblast.align_contig_pair(
        JSequence("c", codes["a"]), JSequence("c", codes["b"]), "a.c", "b.c",
        JBlastParams())
    trecs = tblast.align_contig_pair(
        TSequence("c", codes["a"]), TSequence("c", codes["b"]), "a.c", "b.c",
        BlastParams(), device="cpu")
    jc = jcaf.run_caf(jrecs, lengths, JCafParams(), preset="one",
                      min_chain_override=64)
    tc = tcaf.run_caf(trecs, lengths, CafParams(), preset="one",
                      min_chain_override=64)
    _assert_blocks_equal(jc, tc)
    jseqs = {f"{g}.c": JSequence(f"{g}.c", c) for g, c in codes.items()}
    tseqs = {f"{g}.c": TSequence(f"{g}.c", c) for g, c in codes.items()}
    groups = []

    def spy(g, params, device=None, _fn=tpoa.poa_msa_batch):
        assert device == "cpu"
        groups.extend(g)
        return _fn(g, params, device=device)

    monkeypatch.setattr(tpoa, "poa_msa_batch", spy)
    jout = jbar.run_bar(jc, jseqs, JBarParams(msa_engine="poa"))
    tout = tbar.run_bar(tc, tseqs, BarParams(msa_engine="poa"),
                        device="cpu")
    _assert_blocks_equal(jout, tout)
    assert len(groups) > 0
    # BAR evidence raised the blocks' support over CAF's
    assert int(jout.blocks.support.sum()) > int(jc.blocks.support.sum())


STAR = ("(a:0.06,b:0.08,c:0.1)root;", 5_000, 41)


def test_poa_progressive_star_identical(tmp_path, monkeypatch):
    """A 3-leaf star: each end gathers three members, so progressive
    round 2 aligns against bubbled graphs (poa_affine)."""
    calls = {"poa_chain": 0, "poa_affine": 0}
    for name in calls:
        def spy(*args, _fn=getattr(poa_cuda, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(poa_cuda, name, spy)
    nwk, root_len, seed = STAR
    sim = evolver.simulate(parse_newick(nwk), root_len=root_len, seed=seed)
    cfg = JConfig.default()
    cfg.bar.msa_engine = "poa"
    leaves = sim.tree.leaf_names()
    jres = jprog.ProgressiveAligner(
        parse_newick(nwk),
        {ev: {f"{ev}.c": JSequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in leaves},
        config=cfg, min_chain_override=64).run()
    tres = tprog.ProgressiveAligner(
        tparse_newick(nwk),
        {ev: {f"{ev}.c": TSequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in leaves},
        config=config_from_numpy(dataclasses.asdict(cfg)),
        min_chain_override=64, device="cpu").run()
    assert calls["poa_chain"] > 0 and calls["poa_affine"] > 0
    assert sorted(jres.steps) == sorted(tres.steps)
    for ev, js in jres.steps.items():
        ts = tres.steps[ev]
        _assert_blocks_equal(js.caf, ts.caf)
        assert sorted(js.maps) == sorted(ts.maps)
        for seq, mp in js.maps.items():
            for f in ("tgt_idx", "tgt_pos", "strand"):
                np.testing.assert_array_equal(getattr(mp, f),
                                              getattr(ts.maps[seq], f))
        for seq, s in js.ref.sequences.items():
            np.testing.assert_array_equal(s.codes,
                                          ts.ref.sequences[seq].codes)
    a, b = str(tmp_path / "jax.maf"), str(tmp_path / "torch.maf")
    jhal.write_hal2maf(a, jres, None)
    thal.write_hal2maf(b, tres, None)
    text = open(a).read()
    assert text == open(b).read() and text.count("\ns ") >= 3
