"""The PyTorch port's pecan BAR engine and HAL archive against the JAX
package (CPU).

The pecan engine (partialOrderAlignment="0") picks member pairs by
edge-disjoint spanning trees, splits big matrices at MUM anchors, and
aligns each piece by 5-state pair-HMM posteriors.  The same CAF result,
simulated genomes and configuration go through both packages: the pair
selection, the divergence estimate, the refined BAR blocks, a whole
progressive run (CAF blocks, maps, ancestors, MAF) and the `align
--config <pecan xml> --hal` archive must be identical.  The archive
stores nothing run-specific (no time, path or host), so the two files are
compared byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest

from cactus_tpu import cli as jcli
from cactus_tpu import progressive as jprog
from cactus_tpu.config import BarParams as JBarParams
from cactus_tpu.config import BlastParams as JBlastParams
from cactus_tpu.config import CafParams as JCafParams
from cactus_tpu.config import Config as JConfig
from cactus_tpu.hal_archive import HalArchive as JHalArchive
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.phases import bar as jbar
from cactus_tpu.phases import blast as jblast
from cactus_tpu.phases import caf as jcaf
from cactus_tpu.phases import hal as jhal
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch import progressive as tprog
from cactus_tpu_torch.config import (BarParams, BlastParams, CafParams,
                                     config_from_numpy)
from cactus_tpu_torch.hal_archive import HalArchive
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm5 as tp5
from cactus_tpu_torch.phases import bar as tbar
from cactus_tpu_torch.phases import blast as tblast
from cactus_tpu_torch.phases import caf as tcaf
from cactus_tpu_torch.phases import hal as thal
from cactus_tpu_torch.utils.trees import parse_newick as tparse_newick
from test_torch_slice import BLOCK_FIELDS, SIMS

PECAN_XML = """<cactusWorkflowConfig>
  <bar partialOrderAlignment="0"/>
</cactusWorkflowConfig>
"""


def _assert_blocks_equal(a, b):
    np.testing.assert_array_equal(a.alive, b.alive)
    for f in BLOCK_FIELDS:
        np.testing.assert_array_equal(getattr(a.blocks, f),
                                      getattr(b.blocks, f))


@pytest.fixture(scope="module")
def cafs():
    """A 2-genome 6 kb sim (tests/test_bar.py's pecan case), anchored and
    CAF-ed by each package."""
    sim = evolver.simulate(parse_newick("(a:0.05,b:0.05)root;"),
                           root_len=6_000, seed=19)
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
    return jc, tc, jseqs, tseqs


@pytest.mark.parametrize("five_state", [True, False])
def test_pecan_run_bar_blocks_identical(cafs, monkeypatch, five_state):
    jc, tc, jseqs, tseqs = cafs
    calls = {"pairhmm5": 0, "pairhmm": 0}
    for mod, name, key in ((tp5, "posterior_pairs_banded5", "pairhmm5"),
                           (tp, "posterior_pairs_banded", "pairhmm")):
        def spy(*args, _fn=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            assert kw["device"] == "cpu"
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    jcfg = JBarParams(partial_order_alignment=False)
    jcfg.pecan.five_state = five_state
    tcfg = BarParams(partial_order_alignment=False)
    tcfg.pecan.five_state = five_state
    jout = jbar.run_bar(jc, jseqs, jcfg)
    tout = tbar.run_bar(tc, tseqs, tcfg, device="cpu")
    _assert_blocks_equal(jout, tout)
    assert jout.alive.sum() > jc.alive.sum()
    assert calls["pairhmm5" if five_state else "pairhmm"] > 0
    assert calls["pairhmm" if five_state else "pairhmm5"] == 0


def test_estimate_block_identity_identical(cafs):
    jc, tc, jseqs, tseqs = cafs
    jg = jbar.global_codes(jc.table, jseqs)
    tg = tbar.global_codes(tc.table, tseqs)
    np.testing.assert_array_equal(jg, tg)
    ident = tbar.estimate_block_identity(tc, tg)
    assert ident == jbar.estimate_block_identity(jc, jg)
    assert 0.8 < ident < 1.0
    assert (tbar.estimate_block_identity(tc, tg, max_bases=500)
            == jbar.estimate_block_identity(jc, jg, max_bases=500))


@pytest.mark.parametrize("m,n_trees,progressive",
                         [(3, 5, True), (8, 2, True), (14, 3, True),
                          (14, 3, False), (20, 1, True)])
def test_spanning_tree_pairs_identical(m, n_trees, progressive):
    rng = np.random.default_rng(m * 10 + n_trees)
    root = rng.integers(0, 4, 400).astype(np.uint8)
    codes = []
    for k in range(m):
        if k % 5 == 4:
            # members shorter than the minhash k-mer get sentinel sketches
            codes.append(rng.integers(0, 4, int(rng.integers(1, 12)))
                         .astype(np.uint8))
            continue
        a = int(rng.integers(0, 100))
        c = root[a:a + int(rng.integers(150, 300))].copy()
        flip = rng.random(len(c)) < 0.02 * (k % 4 + 1)
        c[flip] = rng.integers(0, 4, int(flip.sum()))
        codes.append(c)
    got = tbar.spanning_tree_pairs(codes, n_trees, progressive=progressive)
    assert got == jbar.spanning_tree_pairs(codes, n_trees,
                                           progressive=progressive)
    assert len(got) >= m - 1
    np.testing.assert_array_equal(tbar._minhash_sim(codes),
                                  jbar._minhash_sim(codes))


def test_pecan_progressive_run_identical(tmp_path, monkeypatch):
    """The slice test's 2-genome step with the pecan engine selected."""
    calls = [0]

    def spy(*args, _fn=tp5.posterior_pairs_banded5, **kw):
        calls[0] += 1
        return _fn(*args, **kw)

    monkeypatch.setattr(tp5, "posterior_pairs_banded5", spy)
    nwk, root_len, seed, chunk, overlap = SIMS["pair"]
    sim = evolver.simulate(parse_newick(nwk), root_len=root_len, seed=seed)
    cfg = JConfig.default()
    cfg.blast.chunk_size = chunk
    cfg.blast.overlap_size = overlap
    cfg.bar.partial_order_alignment = False
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
    assert calls[0] > 0
    assert sorted(jres.steps) == sorted(tres.steps)
    for ev, js in jres.steps.items():
        ts = tres.steps[ev]
        _assert_blocks_equal(js.caf, ts.caf)
        assert sorted(js.maps) == sorted(ts.maps)
        for seq, mp in js.maps.items():
            for f in ("tgt_idx", "tgt_pos", "strand"):
                np.testing.assert_array_equal(getattr(mp, f),
                                              getattr(ts.maps[seq], f))
        assert js.anc_seq_names == ts.anc_seq_names
        for seq, s in js.ref.sequences.items():
            np.testing.assert_array_equal(s.codes,
                                          ts.ref.sequences[seq].codes)
    a, b = str(tmp_path / "jax.maf"), str(tmp_path / "torch.maf")
    jhal.write_hal2maf(a, jres, None)
    thal.write_hal2maf(b, tres, None)
    text = open(a).read()
    assert text == open(b).read() and text.count("\ns ") >= 2


def test_cli_pecan_config_hal_identical(tmp_path):
    sim = evolver.simulate(parse_newick("(a:0.05,b:0.06)root;"),
                           root_len=4_000, seed=23)
    seqfile = evolver.write_seqfile(sim, str(tmp_path / "sim"))
    xml = tmp_path / "pecan.xml"
    xml.write_text(PECAN_XML)
    outs = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("torch", tcli.main, ["--device", "cpu"])):
        hal = str(tmp_path / f"{pkg}.hal")
        maf = str(tmp_path / f"{pkg}.maf")
        assert main(["align", seqfile, str(tmp_path / pkg), "--config",
                     str(xml), "--hal", hal, "--maf", maf, "--min-chain",
                     "64"] + extra) == 0
        outs[pkg] = (hal, maf)
    (jhal_path, jmaf), (thal_path, tmaf) = outs["jax"], outs["torch"]
    assert open(jmaf).read() == open(tmaf).read()
    with open(jhal_path, "rb") as a, open(thal_path, "rb") as b:
        assert a.read() == b.read()
    arc = HalArchive.open(thal_path)
    assert sorted(arc.genomes()) == sorted(JHalArchive.open(
        jhal_path).genomes()) == ["a", "b", "root"]
    assert arc.validate() == []
    assert arc.stats() == JHalArchive.open(jhal_path).stats()
