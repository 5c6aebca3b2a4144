"""The port's host verbs and the `blast` verb against the JAX package's
CLI, on the CPU.

Each verb runs through `cactus_tpu.cli.main` and `cactus_tpu_torch.cli.main`
on the same inputs: a store and HAL archive written by each package from
the same seqfile (identical, as tests/test_torch_slice.py holds), and
every file and line the verbs write must be byte-identical.  `prepare`'s
plan differs only in the program its commands run.
"""

import os
import shutil

import pytest

from cactus_tpu import cli as jcli
from cactus_tpu.testutil import evolver
from cactus_tpu.utils.trees import parse_newick
from cactus_tpu_torch import cli as tcli

NEWICK = "((a:0.04,b:0.04)ab:0.04,c:0.08)root;"


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """{"seqfile": path, "jax"/"torch": (store dir, HAL, MAF)} from each
    package's `align --hal --maf` of one seqfile."""
    root = tmp_path_factory.mktemp("verbs")
    sim = evolver.simulate(parse_newick(NEWICK), root_len=6_000, seed=41)
    seqfile = evolver.write_seqfile(sim, str(root / "in"))
    out = {"seqfile": seqfile}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = str(root / name)
        hal, maf = d + ".hal", d + ".maf"
        assert main(["align", seqfile, d, "--hal", hal, "--maf", maf,
                     "--min-chain", "64", *extra]) == 0
        out[name] = (d, hal, maf)
    with open(out["jax"][2], "rb") as a, open(out["torch"][2], "rb") as b:
        assert a.read() == b.read()
    return out


def _files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run(main, argv, capsys, work):
    """(exit code, standard output, {file: bytes} written under work),
    with `work` in the arguments read as the run's own directory."""
    os.makedirs(work, exist_ok=True)
    capsys.readouterr()
    rc = main([a.replace("{work}", work) for a in argv])
    text = capsys.readouterr().out.replace(work, "{work}")
    files = {k: v.replace(work.encode(), b"{work}")
             for k, v in _files(work).items()}
    return rc, text, files


def _both(argv_of, capsys, tmp_path, setup=None):
    """Run the verb with each CLI on each package's store / archive
    (`argv_of(package, what setup(package, work) made)`); every run's
    output must be equal."""
    runs = {}
    for src in ("jax", "torch"):
        for cli_name, main in (("jax", jcli.main), ("torch", tcli.main)):
            work = str(tmp_path / f"{src}_{cli_name}")
            os.makedirs(work)
            paths = setup(src, work) if setup else None
            runs[(src, cli_name)] = _run(main, argv_of(src, paths), capsys,
                                         work)
    first = runs[("jax", "jax")]
    for key, got in runs.items():
        assert got == first, key
    return first


def test_not_ported_verbs_are_update_and_conservation(aligned, tmp_path):
    """`update` and `conservation`, the last verbs to be ported, run
    through the port's CLI on either package's store: `update remove
    --hal` writes what the JAX package's writes, and `conservation
    --method ratio` the same positions (its values are held by
    tests/test_torch_phast.py)."""
    assert not hasattr(tcli, "NOT_PORTED_VERBS")
    for src in ("jax", "torch"):
        runs = []
        for name, main, extra in (("jax", jcli.main, []),
                                  ("torch", tcli.main, ["--device", "cpu"])):
            d = str(tmp_path / f"{src}_{name}")
            shutil.copytree(aligned[src][0], d)
            assert main(["update", "remove", d, "b", "--min-chain", "64",
                         "--hal", d + ".hal", *extra]) == 0
            assert main(["hal2maf", d, d + ".maf"]) == 0
            runs.append([open(d + x, "rb").read() for x in (".hal", ".maf")])
        assert runs[0] == runs[1]
        wig = str(tmp_path / f"{src}.wig")
        assert tcli.main(["conservation", aligned[src][0], wig, "--method",
                          "ratio", "--device", "cpu"]) == 0
        assert jcli.main(["conservation", aligned[src][0], wig + ".j.wig",
                          "--method", "ratio"]) == 0
        pos = [ln.split()[0] for ln in open(wig)]
        assert pos == [ln.split()[0] for ln in open(wig + ".j.wig")]
        assert len(pos) > 5000


@pytest.mark.parametrize("mode", [[], ["--fastga"], ["--minimap2"],
                                  ["--events", "a,c", "--preset", "one"]])
def test_blast_paf_identical(aligned, tmp_path, mode):
    sf = aligned["seqfile"]
    j, t = str(tmp_path / "j.paf"), str(tmp_path / "t.paf")
    assert jcli.main(["blast", sf, j, *mode]) == 0
    assert tcli.main(["blast", sf, t, *mode, "--device", "cpu"]) == 0
    with open(j, "rb") as a, open(t, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.count(b"\ttp:A:P") >= 1


@pytest.mark.parametrize("form", ["print", "script", "wdl"])
def test_prepare_plan_names_the_port(aligned, tmp_path, capsys, form):
    sf = aligned["seqfile"]
    texts = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        argv = ["prepare", sf, "OUT"]
        path = str(tmp_path / f"{name}.{form}")
        if form != "print":
            argv += [f"--{form}", path]
        capsys.readouterr()
        assert main(argv) == 0
        out = capsys.readouterr().out
        texts[name] = out if form == "print" else open(path).read()
    want = texts["jax"].replace("python -m cactus_tpu ",
                                "python -m cactus_tpu_torch ")
    want = want.replace("## cactus-tpu plan", "## cactus-tpu-torch plan")
    assert texts["torch"] == want
    assert "python -m cactus_tpu_torch align" in texts["torch"]
    assert "python -m cactus_tpu " not in texts["torch"]


@pytest.mark.parametrize("verb", ["stats", "hal2seqfile",
                                  "hal2seqfile_events", "maf2bigmaf",
                                  "chains"])
def test_store_verbs_identical(aligned, tmp_path, capsys, verb):
    def argv(src, _paths):
        store, _hal, maf = aligned[src]
        return {
            "stats": ["stats", store],
            "hal2seqfile": ["hal2seqfile", store, "{work}/sf",
                            "--leaves-only"],
            "hal2seqfile_events": ["hal2seqfile", store, "{work}/sf",
                                   "--events", "root,a",
                                   "--out", "{work}/my.txt"],
            "maf2bigmaf": ["maf2bigmaf", maf, "{work}/o.bigmaf",
                           "--ref-genome", "root"],
            "chains": ["chains", store, "a", "b", "{work}/a_b.chain"],
        }[verb]

    rc, text, files = _both(argv, capsys, tmp_path)
    assert rc == 0 and (text or files)


def _bed(src, work, aligned):
    from cactus_tpu_torch.hal_archive import HalArchive
    names = sorted(HalArchive.open(aligned[src][1]).dna("a"))
    bed = os.path.join(work, "in.bed")
    with open(bed, "w") as fh:
        fh.write(f"{names[0]}\t100\t900\n{names[0]}\t2000\t2600\n")
    return bed


HAL_TOOLS = {
    "stats": ["stats"],
    "fasta": ["fasta", "--genome", "a", "--out", "{work}/a.fa"],
    "fasta_stdout": ["fasta", "--genome", "b"],
    "maf": ["maf", "--genome", "root", "--out", "{work}/r.maf"],
    "maf_region": ["maf", "--genome", "ab", "--start", "200", "--end",
                   "3000", "--out", "{work}/ab.maf"],
    "validate": ["validate"],
    "mutations": ["mutations"],
    "snps": ["snps", "--genome", "a", "--target", "b", "--out",
             "{work}/snps.tsv"],
    "liftover": ["liftover", "--genome", "a", "--target", "c", "--bed",
                 "{work}/in.bed", "--out", "{work}/lifted.bed"],
    "metadata": ["metadata"],
}


@pytest.mark.parametrize("tool", sorted(HAL_TOOLS))
def test_hal_read_tools_identical(aligned, tmp_path, capsys, tool):
    def setup(src, work):
        if tool == "liftover":
            _bed(src, work, aligned)

    def argv(src, _paths):
        opts = HAL_TOOLS[tool]
        return ["hal", opts[0], aligned[src][1], *opts[1:]]

    rc, text, files = _both(argv, capsys, tmp_path, setup)
    assert rc == 0 and (text or files or tool == "validate")


@pytest.mark.parametrize("tool", ["removeDupes", "metadata_set", "append",
                                  "export-hdf5", "import-hdf5"])
def test_hal_write_tools_identical(aligned, tmp_path, capsys, tool):
    pytest.importorskip("h5py")

    def setup(src, work):
        hal = os.path.join(work, "x.hal")
        if tool == "append":
            from cactus_tpu_torch.hal_archive import HalArchive
            from cactus_tpu_torch.store import AlignmentStore
            res = AlignmentStore(aligned[src][0]).load_result()
            HalArchive.create(hal, newick=res.tree.to_newick())
        elif tool == "import-hdf5":
            # the source container, from the same package's export
            jcli.main(["hal", "export-hdf5", aligned[src][1], "--out",
                       os.path.join(work, "src.h5")])
        else:
            shutil.copy(aligned[src][1], hal)
        return hal

    def argv(src, hal):
        work = os.path.dirname(hal)
        return {
            "removeDupes": ["hal", "removeDupes", hal, "--genome", "a"],
            "metadata_set": ["hal", "metadata", hal, "--set", "k=v"],
            "append": ["hal", "append", hal, "--store", aligned[src][0],
                       "--genome", "ab"],
            "export-hdf5": ["hal", "export-hdf5", aligned[src][1], "--out",
                            os.path.join(work, "out.h5")],
            "import-hdf5": ["hal", "import-hdf5", hal, "--hdf5",
                            os.path.join(work, "src.h5")],
        }[tool]

    rc, _text, files = _both(argv, capsys, tmp_path, setup)
    assert rc == 0 and files
