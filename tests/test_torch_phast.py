"""The port's Felsenstein pass and conservation scores against the JAX
package's, on the CPU.

Both packages run the same float32 message pass (cactus_tpu/phast.py in
XLA, cactus_tpu_torch/phast.py in PyTorch); XLA's CPU code fuses
multiply-adds and has its own log, so the per-column log-likelihoods
differ by a few ulps, and what is built on them by what those ulps become
(`JAX_PLATFORMS=cpu python tests/phast_gap_report.py --seeds 8` prints
the readings each tolerance below is taken from).  One JAX-written store
serves the module: a 3-genome alignment at 6 kb, seed 61, the seed of the
report's largest scale gap.
"""

import json
import os

import numpy as np
import pytest

from chip_smoke import PHAST_TOL, phast_gff
from cactus_tpu import cli as jcli
from cactus_tpu import phast as jp
from cactus_tpu.phases import hal as jhal
from cactus_tpu.store import AlignmentStore as JStore
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch import phast as tp
from cactus_tpu_torch.io.bigwig import read_bigwig
from cactus_tpu_torch.phases import hal as thal
from cactus_tpu_torch.store import AlignmentStore as TStore

NEWICK = "((a:0.04,b:0.04)ab:0.04,c:0.08)root;"
# column log-likelihoods: ulps of the column's largest |ll| over its rows
# (the report reads at most 3 over 10 inputs)
LL_ULPS = 4
# phylo_fit's scale: the golden section (tol 1e-3) takes the other branch
# where two evaluations tie within those ulps; the report reads up to
# 2.55e-3 (seed 3; 1.7e-3 at this module's seed 61)
FIT_ATOL = 5e-3
# phylo_p's scores at one fixed neutral scale, |port - JAX| <= tol
# max(1, |JAX|) (SCORE_TOL[method], atol = rtol): chip_smoke.py's
# PHAST_TOL, which holds the card to the port's CPU run with the same
# tolerances (their derivation from the report is there)
SCORE_TOL = PHAST_TOL
# the conservation verb's tracks (LRT): each package fits its own scale
# (within FIT_ATOL), which moves the scores by up to 1.16e-3 max(1, |JAX|)
# in the report (seed 3; 9.1e-4 at seed 61), and the .wig prints 4
# decimals
VERB_TOL = 5e-3


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A JAX-written store: (store dir, JAX blocks and tree, the port's
    blocks and tree read from the same store)."""
    root = tmp_path_factory.mktemp("phast")
    sim = evolver.simulate(parse_newick(NEWICK), root_len=6_000, seed=61)
    seqfile = evolver.write_seqfile(sim, str(root / "in"))
    out = str(root / "aln")
    assert jcli.main(["align", seqfile, out, "--min-chain", "64"]) == 0
    jres = JStore(out).load_result()
    tres = TStore(out).load_result()
    return {"dir": out,
            "jax": (jhal.hal2maf(jres, None, include_ancestor=False),
                    jres.tree),
            "torch": (thal.hal2maf(tres, None, include_ancestor=False),
                      tres.tree),
            "a_seqs": tres.genomes["a"]}


@pytest.fixture(scope="module")
def obs(store):
    blocks, tree = store["jax"]
    got, meta = jp.columns_from_maf(blocks, tree)
    want, tmeta = tp.columns_from_maf(*store["torch"])
    np.testing.assert_array_equal(got, want)
    assert meta == tmeta and len(got) > 5000
    return got


@pytest.fixture(scope="module")
def scales(store):
    """(JAX scale, port scale) of phylo_fit on the store's MAF."""
    return (jp.phylo_fit(*store["jax"]),
            tp.phylo_fit(*store["torch"], device="cpu"))


def _within_ulps(got, want, ulps):
    want2, got2 = np.atleast_2d(want), np.atleast_2d(got)
    scale = np.spacing(np.abs(want2).max(axis=0).astype(np.float32))
    worst = float((np.abs(got2 - want2) / scale).max())
    assert worst <= ulps, f"{worst} ulps"


def _grid(tree, name, scale=1.0):
    nE = sum(1 for n in tree.postorder() if n.parent is not None)
    rhos = {"ratio": np.array([1.0, 0.3]),
            "LRT": np.concatenate([np.logspace(np.log10(1 / 16), 0.0, 16,
                                               endpoint=False), [1.0],
                                   np.logspace(0.0, np.log10(16.0), 17)[1:]]),
            "SCORE": np.array([0.95, 1.0, 1.05])}[name]
    return np.full((len(rhos), nE), scale) * rhos[:, None]


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_column_log_likelihoods_match_jax(store, obs, scale):
    want = jp.column_log_likelihoods(obs, store["jax"][1], scale)
    got = tp.column_log_likelihoods(obs, store["torch"][1], scale,
                                    device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    _within_ulps(got, want, LL_ULPS)


@pytest.mark.parametrize("grid", ["ratio", "LRT", "SCORE"])
def test_column_ll_multi_matches_jax(store, obs, grid):
    sc = _grid(store["jax"][1], grid)
    want = jp.column_ll_multi(obs, store["jax"][1], sc)
    got = tp.column_ll_multi(obs, store["torch"][1], sc, device="cpu")
    assert got.shape == want.shape == (len(sc), len(obs))
    _within_ulps(got, want, LL_ULPS)


def test_chunked_pass_equals_one_chunk(store, obs):
    tree = store["torch"][1]
    sc = _grid(tree, "LRT")
    E = obs.shape[1]
    whole = tp.column_ll_multi(obs, tree, sc, device="cpu",
                               budget=1 << 40)
    per_col = tp.felsenstein_bytes_per_column(len(sc), E)
    for cols in (1, 7, 1000):
        got = tp.column_ll_multi(obs, tree, sc, device="cpu",
                                 budget=cols * per_col)
        np.testing.assert_array_equal(got, whole)
    assert tp.FELSENSTEIN_BUDGET_BYTES // per_col < len(obs) * 1000


def test_phylo_fit_scale_matches_jax(scales):
    js, ts = scales
    assert 0.05 < js < 8.0
    assert abs(js - ts) <= FIT_ATOL, (js, ts)


def test_phylo_fit_on_4d_sites_matches_jax(store, tmp_path):
    """phyloFit on the 4d sites of a seeded annotation of leaf a (the MAF's
    columns whose first row is a's), as tests/test_chains_phast.py fits."""
    gff = phast_gff(str(tmp_path / "genes.gff"), store["a_seqs"])
    sites = tp.four_d_sites(store["a_seqs"], tp.gff_cds_transcripts(gff))
    want = jp.four_d_sites(store["a_seqs"], jp.gff_cds_transcripts(gff))
    assert sorted(sites) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sites[k], want[k])
    obs, meta = tp.columns_from_maf(*store["torch"])
    kept, _m = tp.filter_columns_to_sites(obs, meta, sites)
    assert 100 < len(kept) < len(obs)
    js = jp.phylo_fit(*store["jax"], sites=sites)
    ts = tp.phylo_fit(*store["torch"], sites=sites, device="cpu")
    assert abs(js - ts) <= FIT_ATOL, (js, ts)


@pytest.mark.parametrize("mode", ["CONACC", "CON", "ACC", "NNEUT"])
@pytest.mark.parametrize("method", ["ratio", "LRT", "SCORE"])
def test_phylo_p_matches_jax(store, scales, method, mode):
    js = scales[0]
    want, wmeta = jp.phylo_p(*store["jax"], neutral_scale=js, method=method,
                             mode=mode)
    got, gmeta = tp.phylo_p(*store["torch"], neutral_scale=js,
                            method=method, mode=mode, device="cpu")
    assert gmeta == wmeta
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = SCORE_TOL[method]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("method", ["LRT", "SCORE"])
def test_phylo_p_subtree_tracks_match_jax(method):
    """--subtree tracks on the 4-leaf conserved-run input of
    tests/test_chains_phast.py (a and b identical on [400, 800))."""
    from cactus_tpu.io.maf import MafBlock, MafRow
    from cactus_tpu_torch.utils.trees import parse_newick as tnewick
    newick = "((a:0.1,b:0.1)ab:0.1,(c:0.1,d:0.1)cd:0.1)root;"
    sim = evolver.simulate(parse_newick(newick), root_len=1200, seed=9,
                           indel_rate=0.0)
    codes = {g: sim.genomes[g].codes.copy() for g in "abcd"}
    codes["b"][400:800] = codes["a"][400:800]
    blocks = [MafBlock(rows=[MafRow(f"{g}.c", 0, 1200, "+", 1200,
                                    "".join("ACGT"[c] for c in codes[g]))
                             for g in "abcd"])]
    tol = SCORE_TOL[method]
    for sub in ("ab", "cd"):
        want, wmeta = jp.phylo_p(blocks, parse_newick(newick),
                                 neutral_scale=1.0, method=method,
                                 subtree=sub)
        got, gmeta = tp.phylo_p(blocks, tnewick(newick), neutral_scale=1.0,
                                method=method, subtree=sub, device="cpu")
        assert gmeta == wmeta
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    with pytest.raises(ValueError):
        tp.phylo_p(blocks, tnewick(newick), subtree="nope", device="cpu")


def _wig(path):
    """{(chrom, pos): value} and the ordered keys of a variableStep wig."""
    out, keys, chrom = {}, [], None
    for line in open(path):
        if line.startswith("variableStep"):
            chrom = line.split("chrom=")[1].strip()
            continue
        pos, val = line.split()
        keys.append((chrom, int(pos)))
        out[(chrom, int(pos))] = float(val)
    return out, keys


@pytest.mark.parametrize("annotation", [False, True])
def test_conservation_verb_matches_jax(store, tmp_path, annotation):
    argv = ["conservation", store["dir"], None, "--subtree", "ab", "root",
            "--bigwig"]
    if annotation:
        gff = phast_gff(str(tmp_path / "genes.gff"), store["a_seqs"])
        argv += ["--annotation", gff]
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.wig")
        argv[2] = out
        assert main([*argv, *extra]) == 0
        outs[name] = out
    j, t = outs["jax"], outs["torch"]
    tol = VERB_TOL
    for suffix in ("", ".ab.wig"):
        want, wkeys = _wig(j + suffix)
        got, gkeys = _wig(t + suffix)
        assert gkeys == wkeys and len(wkeys) > 5000
        np.testing.assert_allclose([got[k] for k in gkeys],
                                   [want[k] for k in wkeys],
                                   atol=tol, rtol=tol)
        wbw, wsizes = read_bigwig(j + suffix + ".bw")
        gbw, gsizes = read_bigwig(t + suffix + ".bw")
        assert gsizes == wsizes and sorted(gbw) == sorted(wbw)
        for chrom in wbw:
            np.testing.assert_array_equal(gbw[chrom][0], wbw[chrom][0])
            np.testing.assert_allclose(gbw[chrom][1], wbw[chrom][1],
                                       atol=tol, rtol=tol)
    jm = json.load(open(j + ".mod.json"))
    tm = json.load(open(t + ".mod.json"))
    assert abs(jm.pop("rate_scale") - tm.pop("rate_scale")) <= FIT_ATOL
    assert jm == tm
    names = sorted(os.listdir(tmp_path))
    assert [p for p in names if p.startswith("torch")] == [
        p.replace("jax", "torch") for p in names if p.startswith("jax")]
