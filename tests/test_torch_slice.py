"""The PyTorch port's default `align` slice against the JAX package (CPU).

The same simulated genomes, configuration and tree go through both
packages' ProgressiveAligner (the port with device="cpu"): CAF blocks,
child->ancestor maps, ancestral sequences and the MAF text must be
bit-identical.  The CLI `align` verb and the alignment store are checked
across the packages too.
"""

import dataclasses
import os

import numpy as np
import pytest

from cactus_tpu import cli as jcli
from cactus_tpu import progressive as jprog
from cactus_tpu.config import Config as JConfig
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.phases import hal as jhal
from cactus_tpu.store import AlignmentStore as JStore
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch import progressive as tprog
from cactus_tpu_torch.config import config_from_numpy
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.phases import hal as thal
from cactus_tpu_torch.store import AlignmentStore as TStore
from cactus_tpu_torch.utils.trees import parse_newick as tparse_newick

SIMS = {
    # the two-genome step of __graft_entry__.py:102-111
    "pair": ("(a:0.02,b:0.02)root;", 1500, 3, 1024, 128),
    # three genomes: the ab step has c as its outgroup
    "trio": ("((a:0.04,b:0.05)ab:0.04,c:0.09)root;", 12_000, 41, None,
             None),
}
BLOCK_FIELDS = ("seg_block", "seg_seq", "seg_start", "seg_len", "seg_strand")


def _run_both(name):
    nwk, root_len, seed, chunk, overlap = SIMS[name]
    tree = parse_newick(nwk)
    sim = evolver.simulate(tree, root_len=root_len, seed=seed)
    cfg = JConfig.default()
    if chunk:
        cfg.blast.chunk_size = chunk
        cfg.blast.overlap_size = overlap
    leaves = tree.leaf_names()
    jres = jprog.ProgressiveAligner(
        tree, {ev: {f"{ev}.c": JSequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in leaves},
        config=cfg, min_chain_override=64).run()
    tres = tprog.ProgressiveAligner(
        tparse_newick(nwk),
        {ev: {f"{ev}.c": TSequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in leaves},
        config=config_from_numpy(dataclasses.asdict(cfg)),
        min_chain_override=64, device="cpu").run()
    return jres, tres


@pytest.fixture(scope="module", params=sorted(SIMS))
def both(request):
    return request.param, _run_both(request.param)


def test_caf_blocks_maps_and_ancestors_identical(both):
    name, (jres, tres) = both
    assert sorted(jres.steps) == sorted(tres.steps)
    n_blocks = 0
    for ev, js in jres.steps.items():
        ts = tres.steps[ev]
        np.testing.assert_array_equal(js.caf.alive, ts.caf.alive)
        for f in BLOCK_FIELDS:
            np.testing.assert_array_equal(getattr(js.caf.blocks, f),
                                          getattr(ts.caf.blocks, f))
        assert sorted(js.maps) == sorted(ts.maps)
        for seq, m in js.maps.items():
            for f in ("tgt_idx", "tgt_pos", "strand"):
                np.testing.assert_array_equal(getattr(m, f),
                                              getattr(ts.maps[seq], f))
        assert js.anc_seq_names == ts.anc_seq_names
        for seq, s in js.ref.sequences.items():
            np.testing.assert_array_equal(s.codes, ts.ref.sequences[seq].codes)
        assert js.ref.block_coord == ts.ref.block_coord
        assert js.outgroup_events == ts.outgroup_events
        n_blocks += int(js.caf.alive.sum())
    assert n_blocks > 0
    if name == "trio":
        assert jres.steps["ab"].outgroup_events == {"c"}


def test_maf_text_identical(both, tmp_path):
    _name, (jres, tres) = both
    a, b = str(tmp_path / "jax.maf"), str(tmp_path / "torch.maf")
    jhal.write_hal2maf(a, jres, None)
    thal.write_hal2maf(b, tres, None)
    text = open(a).read()
    assert text == open(b).read()
    assert text.count("\ns ") >= 2


@pytest.fixture(scope="module")
def seqfile(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("sim")
    tree = parse_newick("((a:0.04,b:0.04)ab:0.04,c:0.08)root;")
    sim = evolver.simulate(tree, root_len=6_000, seed=41)
    return evolver.write_seqfile(sim, str(outdir))


def test_cli_align_identical_across_packages(seqfile, tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmaf, tmaf = str(tmp_path / "jax.maf"), str(tmp_path / "torch.maf")
    assert jcli.main(["align", seqfile, jout, "--maf", jmaf,
                      "--min-chain", "64"]) == 0
    assert tcli.main(["align", seqfile, tout, "--maf", tmaf,
                      "--min-chain", "64", "--device", "cpu"]) == 0
    assert open(jmaf).read() == open(tmaf).read()
    assert os.path.getsize(tmaf) > 0
    assert open(jout + "/stats.json").read() == \
        open(tout + "/stats.json").read()
    # hal2maf off the store the port wrote
    maf2 = str(tmp_path / "again.maf")
    assert tcli.main(["hal2maf", tout, maf2]) == 0
    assert open(maf2).read() == open(tmaf).read()


def _verbs(main, capsys):
    """The verbs a CLI's parser offers, read from its usage message."""
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main([])
    usage = capsys.readouterr().err
    return set(usage[usage.index("{") + 1:usage.index("}")].split(","))


def test_cli_unported_verbs_and_options_exit_clearly(seqfile, tmp_path,
                                                     capsys):
    """Every verb of the JAX package's CLI is in the port's, and a verb or
    option neither offers exits with a usage error in both."""
    assert _verbs(jcli.main, capsys) <= _verbs(tcli.main, capsys)
    for argv in (["update", "frobnicate", str(tmp_path / "s"), "a"],
                 ["conservation", str(tmp_path / "s"),
                  str(tmp_path / "c.wig"), "--method", "GERP"],
                 ["phyloFit", str(tmp_path / "s")]):
        for main in (jcli.main, tcli.main):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 2
        assert "invalid choice" in capsys.readouterr().err


def test_store_written_by_jax_package_loads_in_port(seqfile, tmp_path):
    out = str(tmp_path / "aln")
    assert jcli.main(["align", seqfile, out, "--min-chain", "64"]) == 0
    jres = JStore(out).load_result()
    tres = TStore(out).load_result()
    assert sorted(jres.steps) == sorted(tres.steps)
    for ev, js in jres.steps.items():
        ts = tres.steps[ev]
        np.testing.assert_array_equal(js.caf.alive, ts.caf.alive)
        for f in BLOCK_FIELDS:
            np.testing.assert_array_equal(getattr(js.caf.blocks, f),
                                          getattr(ts.caf.blocks, f))
        for seq, s in js.ref.sequences.items():
            np.testing.assert_array_equal(s.codes, ts.ref.sequences[seq].codes)
    a, b = str(tmp_path / "a.maf"), str(tmp_path / "b.maf")
    jhal.write_hal2maf(a, jres, None)
    thal.write_hal2maf(b, tres, None)
    assert open(a).read() == open(b).read()
