"""The port's repeat masking and the `preprocess` verb against the JAX
package's, on the CPU.

The k-mer count of preprocessor/masking.py runs as PyTorch ops in the
port (device="cpu" here) and as a jitted XLA sort in cactus_tpu; the
sampled self-alignment masker runs the port's blast stack.  Masks, BED
rows and every file the CLI verbs write must be identical.
"""

import os

import numpy as np
import pytest

from cactus_tpu import cli as jcli
from cactus_tpu.config import Config as JConfig
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.preprocessor import masking as jmask
from cactus_tpu.preprocessor import variants as jvar
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch.config import Config as TConfig
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.preprocessor import masking as tmask
from cactus_tpu_torch.preprocessor import variants as tvar


def plant_repeats(codes, rng, copies=24):
    """A 300 bp interspersed family (`copies` copies, 3% diverged), a 40
    bp tandem array and an alpha-satellite-like array (171 bp x 8)."""
    codes = codes.copy()
    L = len(codes)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for at in rng.choice(np.arange(0, L - 300, 300), copies, replace=False):
        copy = unit.copy()
        sub = rng.random(300) < 0.03
        copy[sub] = rng.integers(0, 4, int(sub.sum()))
        codes[at:at + 300] = copy
    at = L // 4
    codes[at:at + 400] = np.tile(rng.integers(0, 4, 40).astype(np.uint8), 10)
    at = L // 2
    codes[at:at + 171 * 8] = np.tile(
        rng.integers(0, 4, 171).astype(np.uint8), 8)
    return codes


def repeat_genome(Sequence, seed, n=2, L=30_000):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        codes = plant_repeats(rng.integers(0, 4, L).astype(np.uint8), rng)
        codes[100:160] = 4
        mask = np.zeros(L, bool)
        mask[500:520] = True
        out[f"g.c{i}"] = Sequence(f"g.c{i}", codes, mask=mask)
    return out


@pytest.fixture(scope="module")
def seqfile(tmp_path_factory):
    """Three related 24 kb genomes with repeats planted in each (contigs
    past the masker's 20 kb floor; 12 copies of the family, enough to
    mask and few enough to keep the nested refinement's seedless pieces
    cheap on the CPU)."""
    out = tmp_path_factory.mktemp("rep")
    sim = evolver.simulate(parse_newick("((a:0.03,b:0.03)ab:0.02,c:0.05)r;"),
                           root_len=24_000, seed=17)
    rng = np.random.default_rng(17)
    for g in sim.genomes.values():
        g.codes = plant_repeats(g.codes, rng, copies=12)
    return evolver.write_seqfile(sim, str(out))


def _same(a, b):
    assert list(a) == list(b)
    for name in a:
        np.testing.assert_array_equal(a[name].codes, b[name].codes)
        np.testing.assert_array_equal(a[name].mask, b[name].mask)


@pytest.mark.parametrize("k,max_count,dilate", [(13, 8, 10), (11, 3, 0),
                                                (15, 2, 25)])
def test_kmer_counts_mask_equals_jax(k, max_count, dilate):
    g = repeat_genome(JSequence, k)["g.c0"]
    j = jmask.kmer_counts_mask(g.codes, k=k, max_count=max_count,
                               dilate=dilate)
    t = tmask.kmer_counts_mask(g.codes, k=k, max_count=max_count,
                               dilate=dilate, device="cpu")
    np.testing.assert_array_equal(j, t)
    assert 0 < t.mean() < 0.8


def test_kmer_counts_mask_short_input():
    codes = np.zeros(10, np.uint8)
    np.testing.assert_array_equal(
        jmask.kmer_counts_mask(codes, k=13),
        tmask.kmer_counts_mask(codes, k=13, device="cpu"))


@pytest.mark.parametrize("min_length,gc_skew_limit", [(0, 1.0),
                                                      (20_000, 0.98),
                                                      (40_000, 1.0),
                                                      (0, 0.2)])
def test_mask_genome_equals_jax(min_length, gc_skew_limit):
    kw = dict(min_length=min_length, gc_skew_limit=gc_skew_limit)
    j = jmask.mask_genome(repeat_genome(JSequence, 3), **kw)
    t = tmask.mask_genome(repeat_genome(TSequence, 3), device="cpu", **kw)
    _same(j, t)


def test_lastz_repeat_mask_equals_jax():
    jg = repeat_genome(JSequence, 8, n=1, L=20_000)
    tg = repeat_genome(TSequence, 8, n=1, L=20_000)
    j = jvar.lastz_repeat_mask(jg, JConfig.default().blast, proportion=0.5,
                               period=4)
    t = tvar.lastz_repeat_mask(tg, TConfig.default().blast, proportion=0.5,
                               period=4, device="cpu")
    _same(j, t)
    assert t["g.c0"].mask.sum() > jg["g.c0"].mask.sum()


@pytest.mark.parametrize("action", ["softmask", "hardmask", "clip"])
def test_tandem_satellite_and_apply_bed_equal_jax(action):
    jg = repeat_genome(JSequence, 5)
    tg = repeat_genome(TSequence, 5)
    _same(jvar.tandem_mask_genome(jg), tvar.tandem_mask_genome(tg))
    jbed, tbed = jvar.satellite_bed(jg), tvar.satellite_bed(tg)
    assert jbed == tbed and tbed
    _same(jvar.apply_bed(jg, jbed, action), tvar.apply_bed(tg, tbed, action))


def _tree_files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("opts", [
    [], ["--no-mask"], ["--tandem-mask"], ["--lastz-mask"],
    ["--satellite", "softmask"], ["--satellite", "hardmask"],
    ["--satellite", "clip"],
    ["--lastz-mask", "--tandem-mask", "--satellite", "softmask"]])
def test_cli_preprocess_identical_across_packages(seqfile, tmp_path, opts):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jcli.main(["preprocess", seqfile, jout, *opts]) == 0
    assert tcli.main(["preprocess", seqfile, tout, *opts,
                      "--device", "cpu"]) == 0
    j, t = _tree_files(jout), _tree_files(tout)
    assert sorted(j) == sorted(t) and len(t) >= 3
    for name in j:
        assert j[name] == t[name], name
    if "--no-mask" not in opts:
        # the masker soft-masked the planted repeats (lower case)
        assert any(c in t["a.fa"] for c in b"acgt")


def test_cli_align_mask_identical_across_packages(seqfile, tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmaf, tmaf = str(tmp_path / "jax.maf"), str(tmp_path / "torch.maf")
    assert jcli.main(["align", seqfile, jout, "--mask", "--maf", jmaf]) == 0
    assert tcli.main(["align", seqfile, tout, "--mask", "--maf", tmaf,
                      "--device", "cpu"]) == 0
    assert open(jmaf).read() == open(tmaf).read()
    assert open(jout + "/stats.json").read() == \
        open(tout + "/stats.json").read()
    assert os.path.getsize(tmaf) > 0
