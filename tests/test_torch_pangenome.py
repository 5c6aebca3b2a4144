"""The PyTorch port's pangenome builder against the JAX package (CPU).

The same simulated haplotypes go through both packages' pangenome
drivers and verbs (the port with device="cpu"): every artifact a run
writes must be byte-identical, except the 2D layout's `.lay.tsv` and
`.draw.png`, whose SGD draws come from another generator; those are held
by layout_stress instead (below 0.5, and its mean over 40 seeds at most
1.10x the JAX package's on the same graph).  The layout's update rule is
held to a numpy restatement of the JAX body (layout2d.py:101-130) on
fixed draws, within 1e-5, and layout_2d and sgd_sort to the JAX
package's functions run on the port's draws
(tests/pangenome_digest_report.py::port_draws).
"""

import os

import numpy as np
import pytest

from cactus_tpu import cli as jcli
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.pangenome import driver as jdrv
from cactus_tpu.pangenome import layout2d as jlay
from cactus_tpu.pangenome import vcf as jvcf
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.pangenome import driver as tdrv
from cactus_tpu_torch.pangenome import graph as tgraph
from cactus_tpu_torch.pangenome import layout2d as tlay
from cactus_tpu_torch.pangenome import vcf as tvcf

LAYOUT_FILES = ("pangenome.lay.tsv", "pangenome.draw.png")
# the layout's stress may exceed the JAX package's by this factor: the
# draws differ, so the two SGD runs end in different (equally good) states
STRESS_RATIO = 1.10
# every file run_pangenome writes with the default tiers
STAR_FILES = (
    "clipped.bed", "exclusions.tsv", "exclusions.tsv.json",
    "filtered.bed", "graph_stats.json", "pangenome.bub.vcf",
    "pangenome.clip.gfa", "pangenome.clip.viz.png", "pangenome.dist",
    "pangenome.filter.gfa", "pangenome.gbz", "pangenome.gfa",
    "pangenome.min", "pangenome.vcf", "pangenome.viz.png",
    "pangenome.wave.vcf", "snarls.json")
GRAPH_FILES = ("pangenome.gfa", "pangenome.clip.gfa", "pangenome.vcf",
               "pangenome.bub.vcf", "pangenome.wave.vcf")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _genomes(nwk, root_len, seed, Sequence):
    sim = evolver.simulate(parse_newick(nwk), root_len=root_len, seed=seed)
    return {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
            for ev in parse_newick(nwk).leaf_names()}


# the small_graph input of tests/test_pangenome.py:35
STAR = ("(a:0.02,b:0.02,c:0.02)root;", 6000, 17)


@pytest.fixture(scope="module")
def star_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("star")
    jdir, tdir = str(out / "jax"), str(out / "torch")
    jdrv.run_pangenome(_genomes(*STAR, JSequence), "a", jdir)
    tdrv.run_pangenome(_genomes(*STAR, TSequence), "a", tdir, device="cpu")
    return jdir, tdir


def test_star_run_writes_the_same_files(star_runs):
    jdir, tdir = star_runs
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == sorted(
        STAR_FILES + LAYOUT_FILES)


@pytest.mark.parametrize("name", STAR_FILES)
def test_star_artifact_identical(star_runs, name):
    jdir, tdir = star_runs
    assert _read(os.path.join(jdir, name)) == _read(os.path.join(tdir, name))


def _stress_of_run(outdir):
    g = tgraph.read_gfa(os.path.join(outdir, "pangenome.gfa"))
    ref = sorted(n for n in g.walks if n.startswith("a."))[0]
    X = tlay.read_lay(os.path.join(outdir, "pangenome.lay.tsv"))
    return tlay.layout_stress(g, X, ref_name=ref)


def test_star_layout_written_and_below_half(star_runs):
    _jdir, tdir = star_runs
    assert _stress_of_run(tdir) < 0.5
    assert _read(os.path.join(tdir, "pangenome.draw.png"))[:8] == \
        b"\x89PNG\r\n\x1a\n"


# sv and refmap modes at root_len 3000
SMALL = ("(a:0.02,b:0.02,c:0.02)root;", 3000, 23)


@pytest.fixture(scope="module")
def sv_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sv")
    runs = {"jax": str(out / "jax"), "torch": str(out / "torch"),
            "staged": str(out / "staged")}
    jdrv.run_pangenome_sv(_genomes(*SMALL, JSequence), "a", runs["jax"])
    tdrv.run_pangenome_sv(_genomes(*SMALL, TSequence), "a", runs["torch"],
                          device="cpu")
    for stage in tdrv.SV_STAGES:
        tdrv.run_pangenome_sv(_genomes(*SMALL, TSequence), "a",
                              runs["staged"], stages=(stage,), device="cpu")
    return runs


@pytest.mark.parametrize("run", ["torch", "staged"])
@pytest.mark.parametrize("name", GRAPH_FILES + (
    "sv_graph.rgfa", "graphmap.paf", "pangenome.raw.gfa",
    "graph_stats.json"))
def test_sv_mode_identical(sv_runs, run, name):
    assert _read(os.path.join(sv_runs["jax"], name)) == \
        _read(os.path.join(sv_runs[run], name))


@pytest.mark.parametrize("name", GRAPH_FILES + ("graph_stats.json",))
def test_refmap_mode_identical(tmp_path, name):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jdrv.run_pangenome_refmap(_genomes(*SMALL, JSequence), "a", jdir,
                              viz=False)
    tdrv.run_pangenome_refmap(_genomes(*SMALL, TSequence), "a", tdir,
                              viz=False, device="cpu")
    assert _read(os.path.join(jdir, name)) == _read(os.path.join(tdir, name))


def test_split_by_chromosome_identical(tmp_path):
    import chip_smoke
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _sf, jgen = chip_smoke.pan_inputs(str(tmp_path / "ji"), evolver,
                                      parse_newick, JSequence)
    jdrv.run_pangenome_split(jgen, "ref", jdir)
    from cactus_tpu_torch.testutil import evolver as tevolver
    from cactus_tpu_torch.utils.trees import parse_newick as tparse
    _sf, tgen = chip_smoke.pan_inputs(str(tmp_path / "ti"), tevolver,
                                      tparse, TSequence)
    tdrv.run_pangenome_split(tgen, "ref", tdir, device="cpu")
    names = ["contig_assignment.tsv", "pangenome_stats.json"]
    for chrom in ("ref.chr1", "ref.chr2"):
        names += [os.path.join(chrom, f) for f in GRAPH_FILES]
    for name in names:
        assert _read(os.path.join(jdir, name)) == \
            _read(os.path.join(tdir, name)), name
    assign = dict(line.split("\t") for line in
                  open(os.path.join(tdir, "contig_assignment.tsv"))
                  .read().splitlines())
    assert assign["s1.tig1"] == "ref.chr1"


# the complex sites of tests/test_pangenome.py's test_vcfwave_* cases
WAVE_CASES = {
    "complex": [("ref", 10, "ACGTACGT", ["ACCTACT"],
                 {"h1": 1, "h2": 0, "h3": None})],
    "multiallelic": [("ref", 20, "AGCGG", ["TGCGG", "TGGGG"],
                      {"s1": 1, "s2": 2})],
    "primitives": [("ref", 5, "A", ["G"], {"s": 1}),
                   ("ref", 9, "T", ["TAC"], {"s": 1})],
    "mixed": [("ref", 3, "ACGTTGCA", ["AGGTTCA", "ACGTTGCAAAT"],
               {"x": 1, "y": 2, "z": 0}),
              ("ref", 40, "GATTACA", ["GACA"], {"x": 0, "y": 1, "z": 1})],
}


def _rec_tuple(r):
    return (r.chrom, r.pos, r.ref, tuple(r.alts), dict(r.genotypes), r.lv)


@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_vcfwave_records_identical(case):
    jrecs = [jvcf.VcfRecord(*a) for a in WAVE_CASES[case]]
    trecs = [tvcf.VcfRecord(*a) for a in WAVE_CASES[case]]
    jout = [_rec_tuple(r) for r in jvcf.vcfwave(jrecs)]
    tout = [_rec_tuple(r) for r in tvcf.vcfwave(trecs, device="cpu")]
    assert jout == tout and tout


# ------------------------------------------------------------- the layout

def _numpy_step(X, a, u, s, eta, pts, pos, pstart, plen, path_of):
    """The JAX body of layout_2d / sgd_sort (layout2d.py:101-130 and
    :270-284) in float32 numpy, with the draws given."""
    f32 = np.float32
    pid = path_of[a]
    lo, ln = pstart[pid], plen[pid]
    mag = np.exp(u * np.log(np.maximum(ln.astype(f32), f32(2.0))))
    sgn = np.where(s < 0.5, f32(-1.0), f32(1.0))
    b = np.clip(a + (sgn * mag).astype(np.int32), lo, lo + ln - 1)
    d = np.maximum(np.abs(pos[a] - pos[b]), f32(1.0))
    ia, ib = pts[a], pts[b]
    mu = np.where(ia == ib, f32(0.0), np.minimum(eta / (d * d), f32(1.0)))
    diff = X[ia] - X[ib]
    if X.ndim == 2:
        dist = np.sqrt(np.sum(diff * diff, axis=1) + f32(1e-9))
        r = ((dist - d) / (f32(2.0) * dist) * mu)[:, None] * diff
    else:
        dist = np.abs(diff) + f32(1e-9)
        r = (dist - d) / (f32(2.0) * dist) * mu * diff
    acc = np.zeros_like(X)
    np.add.at(acc, ia, -r)
    np.add.at(acc, ib, r)
    cnt = np.zeros(X.shape[0], f32)
    np.add.at(cnt, ia, f32(1.0))
    np.add.at(cnt, ib, f32(1.0))
    cnt = np.maximum(cnt, f32(1.0))
    return X + acc / (cnt[:, None] if X.ndim == 2 else cnt)


@pytest.fixture(scope="module")
def small_graph():
    """tests/test_pangenome.py's small_graph, built by the port."""
    from cactus_tpu_torch.progressive import ProgressiveAligner
    from cactus_tpu_torch.utils.trees import Tree
    genomes = _genomes(*STAR, TSequence)
    root = Tree("_pan_root_")
    for ev in genomes:
        root.add_child(Tree(ev, 0.05))
    res = ProgressiveAligner(root, genomes, min_chain_override=64,
                             device="cpu").run()
    seqs = {n: s for g in genomes.values() for n, s in g.items()}
    return tgraph.build_graph(res.steps["_pan_root_"].caf, seqs, chop=True)


@pytest.mark.parametrize("dim", [2, 1])
@pytest.mark.parametrize("t", [0, 150])
def test_sgd_step_matches_numpy_restatement(small_graph, dim, t):
    import torch
    ep, pos, pstart, plen = tlay._step_termini(small_graph, "a.c")
    path_of = np.repeat(np.arange(len(pstart), dtype=np.int32), plen)
    pts = ep if dim == 2 else ep // 2
    n_pts = 2 * small_graph.n_nodes if dim == 2 else small_graph.n_nodes
    rng = np.random.default_rng(11 + t)
    X = (rng.standard_normal((n_pts, 2) if dim == 2 else n_pts) * 300
         ).astype(np.float32)
    batch = 1024
    a = rng.integers(0, len(ep), batch)
    u = rng.random(batch, dtype=np.float32)
    s = rng.random(batch, dtype=np.float32)
    eta_max = max(float(pos.max()) ** 2, 1.0)
    lam = np.log(eta_max / 0.01) / 199
    eta = np.float32(eta_max) * np.exp(np.float32(-lam) * np.float32(t))
    want = _numpy_step(X, a, u, s, eta, pts, pos, pstart, plen, path_of)
    T = torch.as_tensor
    got = tlay.sgd_step(
        T(X), T(a), T(u), T(s), T(np.float32(eta)), T(pts.astype(np.int64)),
        T(pos), T(pstart.astype(np.int64)), T(plen.astype(np.int64)),
        T(path_of.astype(np.int64))).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    assert not np.array_equal(want, X)


def test_layout_2d_deterministic(small_graph):
    X = tlay.layout_2d(small_graph, ref_name="a.c", iters=200, batch=1024,
                       seed=3, device="cpu")
    assert X.shape == (2 * small_graph.n_nodes, 2) and np.isfinite(X).all()
    X2 = tlay.layout_2d(small_graph, ref_name="a.c", iters=200, batch=1024,
                        seed=3, device="cpu")
    np.testing.assert_array_equal(X, X2)
    assert tlay.layout_stress(small_graph, X, ref_name="a.c") < 0.5


# a layout's stress is a random variable of its draws: over seeds 0-39 the
# JAX package's reading on this graph spreads with a standard deviation of
# 7% of its mean, so two packages with different generators are compared
# by their means over these seeds
LAYOUT_SEEDS = range(40)


def test_layout_2d_stress_within_jax(small_graph):
    ts = [tlay.layout_stress(small_graph, tlay.layout_2d(
        small_graph, ref_name="a.c", seed=seed, device="cpu"),
        ref_name="a.c") for seed in LAYOUT_SEEDS]
    js = [tlay.layout_stress(small_graph, jlay.layout_2d(
        small_graph, ref_name="a.c", seed=seed), ref_name="a.c")
        for seed in LAYOUT_SEEDS]
    assert max(ts) < 0.5
    assert np.mean(ts) <= STRESS_RATIO * np.mean(js), (np.mean(ts),
                                                       np.mean(js))


def test_layout_2d_equals_jax_on_the_same_draws(small_graph):
    """The JAX package's layout_2d, fed the port's draws, lays the graph
    out as the port does (the two differ only in float rounding)."""
    import pangenome_digest_report as pdr
    g = small_graph
    n_ep = len(tlay._step_termini(g, "a.c")[0])
    for seed in (0, 3):
        with pdr.port_draws(n_ep, 200, 1024, seed):
            want = jlay.layout_2d(g, ref_name="a.c", seed=seed)
        got = tlay.layout_2d(g, ref_name="a.c", seed=seed, device="cpu")
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(
            tlay.layout_stress(g, got, ref_name="a.c"),
            jlay.layout_stress(g, want, ref_name="a.c"), rtol=1e-5)
    assert pdr.jax_layout_on_port_draws(g, "a.c").shape == got.shape


def test_sgd_sort_equals_jax_on_the_same_draws(small_graph):
    import pangenome_digest_report as pdr
    g = small_graph
    n_ep = len(tlay._step_termini(g, "a.c")[0])
    iters = min(2000, max(600, 4 * g.n_nodes))
    with pdr.port_draws(n_ep, iters, 1024, 0):
        want = jlay.sgd_sort(g, ref_name="a.c", seed=0)
    np.testing.assert_array_equal(
        tlay.sgd_sort(g, ref_name="a.c", seed=0, device="cpu"), want)


def test_sgd_sort_is_a_permutation_tracking_the_reference(small_graph):
    g = small_graph
    order = tlay.sgd_sort(g, ref_name="a.c", seed=0, device="cpu")
    np.testing.assert_array_equal(
        order, tlay.sgd_sort(g, ref_name="a.c", seed=0, device="cpu"))
    assert sorted(order.tolist()) == list(range(g.n_nodes))
    rank = np.empty(g.n_nodes)
    rank[order] = np.arange(g.n_nodes)
    seen: set[int] = set()
    visit = [v for v, _o in g.walks["a.c"]
             if not (v in seen or seen.add(v))]
    r = np.corrcoef(np.arange(len(visit)), rank[visit])[0, 1]
    assert abs(r) > 0.8, r


def test_layout_needs_a_device_or_cpu(small_graph):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlay.layout_2d(small_graph, ref_name="a.c")


# ------------------------------------------------------------ twins, CLI

def test_chunked_alignment_twin_identical():
    from cactus_tpu.config import BlastParams as JBlast
    from cactus_tpu.phases import chunking as jchunk
    from cactus_tpu_torch.config import BlastParams as TBlast
    from cactus_tpu_torch.phases import chunking as tchunk
    js = _genomes("(a:0.05,b:0.05)r;", 5000, 4, JSequence)
    ts = _genomes("(a:0.05,b:0.05)r;", 5000, 4, TSequence)
    kw = dict(preset="one", chunk_size=2048, overlap=256)
    jrec = jchunk.align_genomes_chunked(js["a"], js["b"], JBlast(), **kw)
    trec = tchunk.align_genomes_chunked(ts["a"], ts["b"], TBlast(), **kw,
                                        device="cpu")
    assert [r.to_line() for r in jrec] == [r.to_line() for r in trec]
    assert trec


def test_global_codes_identical_across_packages():
    from cactus_tpu.phases.bar import global_codes as jgc
    from cactus_tpu.graph.columns import SeqTable as JTable
    from cactus_tpu_torch.phases.bar import global_codes as tgc
    from cactus_tpu_torch.graph.columns import SeqTable as TTable
    rng = np.random.default_rng(3)
    lens = {"a.c": 700, "b.x": 31, "c.y": 1200}
    codes = {n: rng.integers(0, 5, L).astype(np.uint8)
             for n, L in lens.items()}
    j = jgc(JTable.build(lens), {n: JSequence(n, c) for n, c in codes.items()})
    t = tgc(TTable.build(lens), {n: TSequence(n, c) for n, c in codes.items()})
    np.testing.assert_array_equal(j, t)
    assert j.dtype == t.dtype and len(t) == sum(lens.values())


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The pangenome verb (star mode), then gfa index|vcf|viz and patch on
    its GFA, through both packages' CLIs (the port's with `--device cpu`
    on the verbs that reach a device: pangenome and gfa viz)."""
    work = tmp_path_factory.mktemp("cli")
    tree = parse_newick("(a:0.02,b:0.02,c:0.02)root;")
    sim = evolver.simulate(tree, root_len=5000, seed=5)
    seqfile = evolver.write_seqfile(sim, str(work / "in"))
    out = {}
    for pkg, main, dev in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        d = str(work / pkg)
        gfa = os.path.join(d, "pan", "pangenome.gfa")
        os.makedirs(os.path.join(d, "viz"))
        for argv in (["pangenome", seqfile, os.path.join(d, "pan"),
                      "--reference", "a", *dev],
                     ["gfa", "index", gfa, os.path.join(d, "index")],
                     ["gfa", "vcf", gfa, os.path.join(d, "graph.vcf")],
                     ["gfa", "viz", gfa, os.path.join(d, "viz", "g.png"),
                      *dev],
                     ["patch", gfa, "b", os.path.join(d, "patch"),
                      "--donors", "a,c"]):
            assert main(argv) == 0
        out[pkg] = d
    return out


CLI_FILES = (
    [os.path.join("pan", f) for f in STAR_FILES]
    + [os.path.join("index", f) for f in ("graph.gbz", "graph.min",
                                          "graph.dist", "snarls.json",
                                          "stats.json")]
    + ["graph.vcf", os.path.join("viz", "g.png"),
       os.path.join("patch", "b.patched.fa"),
       os.path.join("patch", "patch_report.json")])


@pytest.mark.parametrize("name", CLI_FILES)
def test_cli_verbs_identical(cli_runs, name):
    assert _read(os.path.join(cli_runs["jax"], name)) == \
        _read(os.path.join(cli_runs["torch"], name))


def test_cli_verbs_need_a_device_or_cpu(cli_runs, tmp_path):
    """The verbs that reach a device raise through resolve_device without
    a GPU unless given --device cpu; patch and gfa index|vcf do host work
    only and run without it (patch takes no --device; gfa's is its viz
    tool's)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gfa = os.path.join(cli_runs["torch"], "pan", "pangenome.gfa")
    for argv in (["gfa", "viz", gfa, str(tmp_path / "g.png")],
                 ["pangenome", gfa, str(tmp_path / "d")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    host = (["gfa", "vcf", gfa, str(tmp_path / "g.vcf")],
            ["gfa", "index", gfa, str(tmp_path / "index")],
            ["patch", gfa, "b", str(tmp_path / "p"), "--donors", "a"])
    for argv in host:
        assert tcli.main(argv) == 0
    with pytest.raises(SystemExit):
        tcli.main(host[-1] + ["--device", "cpu"])
    assert _read(str(tmp_path / "g.vcf")) == \
        _read(os.path.join(cli_runs["torch"], "graph.vcf"))
    # every verb of the JAX package's CLI is ported: no list of refused
    # verbs is left
    assert not hasattr(tcli, "NOT_PORTED_VERBS")
