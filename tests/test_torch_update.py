"""The port's update flows against the JAX package's, on the CPU.

Every flow of tests/test_update_maftools.py (add, add to a branch,
replace, remove, remove a root child, the `update --hal` refresh) runs
in both packages on copies of one store, written by either package (the
port's store equal to the JAX package's): the stores' step files and
genomes, the MAF and the HAL archive after the update must be equal.
A step's .npz is a zip whose entries carry the time they were written,
so its arrays are compared (chip_smoke.store_digests), every other file
byte for byte.
"""

import os
import shutil

import numpy as np
import pytest

from chip_smoke import store_digests
from cactus_tpu import cli as jcli
from cactus_tpu import update as jupdate
from cactus_tpu.hal_archive import HalArchive as JHal
from cactus_tpu.io.fasta import Sequence as JSequence
from cactus_tpu.phases import hal as jhal
from cactus_tpu.store import AlignmentStore as JStore
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli
from cactus_tpu_torch import update as tupdate
from cactus_tpu_torch.hal_archive import HalArchive as THal
from cactus_tpu_torch.io.fasta import Sequence as TSequence
from cactus_tpu_torch.phases import hal as thal
from cactus_tpu_torch.store import AlignmentStore as TStore
from cactus_tpu_torch.utils.trees import parse_newick as tparse_newick

NEWICK = "((a:0.04,b:0.04)ab:0.04,c:0.08)root;"


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{writer: store dir} of the 3-genome alignment of
    tests/test_update_maftools.py, aligned by each package, and the sim."""
    from cactus_tpu import progressive as jprog
    from cactus_tpu_torch import progressive as tprog
    root = tmp_path_factory.mktemp("update")
    sim = evolver.simulate(parse_newick(NEWICK), root_len=5_000, seed=61)
    out = {"sim": sim}
    for name, prog, Seq, Store, parse, kw in (
            ("jax", jprog, JSequence, JStore, parse_newick, {}),
            ("torch", tprog, TSequence, TStore, tparse_newick,
             {"device": "cpu"})):
        genomes = {ev: {f"{ev}.c": Seq(f"{ev}.c", sim.genomes[ev].codes)}
                   for ev in ["a", "b", "c"]}
        d = str(root / name)
        prog.ProgressiveAligner(parse(NEWICK), genomes,
                                min_chain_override=64, store=Store(d),
                                **kw).run()
        out[name] = d
    assert store_digests(out["jax"]) == store_digests(out["torch"])
    return out


def _mutated(sim, event, seed, rate):
    rng = np.random.default_rng(seed)
    codes = sim.genomes[event].codes.copy()
    idx = rng.random(len(codes)) < rate
    codes[idx] = (codes[idx] + 1) % 4
    return codes


# flow: (function name, positional arguments after the store, keywords);
# a genome argument is ("genome", event, codes of (source, seed, rate))
FLOWS = {
    "add": ("add_genome", ("cnew", ("genome", "cnew", ("c", 0, 0.02)),
                           "root"), {"branch_length": 0.02}),
    "add_branch": ("add_genome_to_branch",
                   ("cnew", ("genome", "cnew", ("c", 2, 0.02)), "c"),
                   {"branch_length": 0.02}),
    "replace": ("replace_genome", ("b", ("genome", "b", ("b", 1, 0.01))),
                {}),
    "remove": ("remove_genome", ("b",), {}),
    "remove_root_child": ("remove_genome", ("c",), {}),
}


def _run_flow(pkg, Seq, store_dir, flow, sim, kw_extra):
    fn, args, kw = FLOWS[flow]
    real = []
    for a in args:
        if isinstance(a, tuple):
            _tag, ev, (src, seed, rate) = a
            a = {f"{ev}.c": Seq(f"{ev}.c", _mutated(sim, src, seed, rate))}
        real.append(a)
    Store = JStore if pkg is jupdate else TStore
    return getattr(pkg, fn)(Store(store_dir), *real, min_chain_override=64,
                            **kw, **kw_extra)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_update_flow_identical_to_jax(stores, tmp_path, flow, writer):
    runs = {}
    for name, pkg, Seq, hal_mod, Hal, kw in (
            ("jax", jupdate, JSequence, jhal, JHal, {}),
            ("torch", tupdate, TSequence, thal, THal, {"device": "cpu"})):
        d = str(tmp_path / name)
        shutil.copytree(stores[writer], d)
        res = _run_flow(pkg, Seq, d, flow, stores["sim"], kw)
        maf = str(tmp_path / f"{name}.maf")
        hal_mod.write_hal2maf(maf, res, None)
        hal = str(tmp_path / f"{name}.hal")
        pkg.refresh_archive(hal, res)
        assert Hal.open(hal).validate() == []
        runs[name] = (store_digests(d), open(maf, "rb").read(),
                      open(hal, "rb").read(), sorted(res.tree.leaf_names()))
    assert runs["torch"] == runs["jax"]
    digests, maf, _hal, leaves = runs["torch"]
    assert maf.count(b"\ns ") > 0
    if flow.startswith("add"):
        assert "cnew" in leaves
    if flow == "remove_root_child":
        assert leaves == ["a", "b"]
        with pytest.raises(ValueError):
            tupdate.remove_genome(TStore(str(tmp_path / "torch")), "a",
                                  min_chain_override=64, device="cpu")


def test_update_verb_refreshes_archive_identically(tmp_path):
    """`update add --hal` through each package's CLI on a store the JAX
    package's `align --hal` wrote (tests/test_update_maftools.py::
    test_update_refreshes_archive): the HAL, MAF and store equal."""
    from cactus_tpu.io.fasta import write_fasta
    sim = evolver.simulate(parse_newick("((a:0.03,b:0.03)ab:0.03,c:0.06)"
                                        "root;"), root_len=4_000, seed=61)
    pa, pb, pc = (str(tmp_path / f"{e}.fa") for e in "abc")
    for e, p in zip("abc", (pa, pb, pc)):
        write_fasta(p, {e: JSequence(e, sim.genomes[e].codes)})
    seqfile = str(tmp_path / "seqfile.txt")
    with open(seqfile, "w") as fh:
        fh.write(f"(a:0.03,b:0.03)root;\na {pa}\nb {pb}\n")
    base = str(tmp_path / "aln")
    assert jcli.main(["align", seqfile, base, "--hal", base + ".hal",
                      "--min-chain", "64"]) == 0
    runs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d, hal = str(tmp_path / name), str(tmp_path / f"{name}.hal")
        shutil.copytree(base, d)
        shutil.copy(base + ".hal", hal)
        assert main(["update", "add", d, "c", "--fasta", pc, "--parent",
                     "root", "--min-chain", "64", "--hal", hal,
                     *extra]) == 0
        maf = str(tmp_path / f"{name}.maf")
        assert main(["hal2maf", d, maf]) == 0
        runs[name] = (store_digests(d), open(hal, "rb").read(),
                      open(maf, "rb").read())
    assert runs["torch"] == runs["jax"]
    arc = THal.open(str(tmp_path / "torch.hal"))
    assert "c" in arc.genomes() and arc.validate() == []
