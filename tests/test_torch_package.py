"""Package rules of the PyTorch port, and its host-side twins (CPU).

cactus_tpu_torch imports torch and never jax, imports nothing of
cactus_tpu, carries byte-identical copies of the JAX package's jax-free
modules, refuses to fall back to the CPU silently, and vendors the
blossom matching the reference phase needs.
"""

import ast
import dataclasses
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cactus_tpu_torch")

# modules carried byte for byte from cactus_tpu (relative imports resolve
# inside the port); config.py, native/build.py and phases/chunking.py
# became twins
VERBATIM = [
    "config_xml.py", "io/fasta.py", "io/paf.py", "io/maf.py",
    "io/seqfile.py", "io/taf.py", "utils/trees.py", "utils/intervals.py",
    "utils/outgroups.py", "utils/decomposition.py", "utils/pairs.py",
    "graph/columns.py", "graph/cactus.py", "graph/chains.py",
    "graph/pinch.py", "native/dp.cpp", "native/graphops.cpp",
    "native/pinchgraph.cpp", "ops/anchors.py", "ops/seeds_host.py",
    "ops/paf_tools.py", "phases/caf.py",
    "phases/hal.py", "phases/maf_export.py", "store.py", "maf_tools.py",
    "preprocessor/headers.py", "testutil/evolver.py",
    "testutil/comparator.py", "hal_archive.py",
    "pangenome/__init__.py", "pangenome/graph.py", "pangenome/normalize.py",
    "pangenome/exclusions.py", "pangenome/viz.py", "pangenome/indexes.py",
    "pangenome/giraffe.py", "pangenome/patch.py",
    "preprocessor/stats.py", "prepare.py", "utils/resources.py",
    "chains_export.py", "io/hal_hdf5.py", "io/bigwig.py",
    "graph/flowers.py", "ops/train.py", "parallel/__init__.py",
]

# the Pallas modules' counterparts: a CUDA wrapper module and its source
PALLAS_COUNTERPARTS = {
    "ops/banded_pallas.py": ("ops/banded_cuda.py", "csrc/banded.cu"),
    "ops/pairhmm_pallas.py": ("ops/pairhmm_cuda.py", "csrc/pairhmm.cu"),
    "ops/pairhmm5_pallas.py": ("ops/pairhmm5_cuda.py", "csrc/pairhmm5.cu"),
    "ops/poa_pallas.py": ("ops/poa_cuda.py", "csrc/poa.cu"),
}


def test_import_leaves_jax_and_cactus_tpu_out():
    code = ("import sys\n"
            "import cactus_tpu_torch, cactus_tpu_torch.cli, "
            "cactus_tpu_torch.progressive\n"
            "import cactus_tpu_torch.ops.banded_cuda, "
            "cactus_tpu_torch.ops.pairhmm_cuda, "
            "cactus_tpu_torch.ops.pairhmm5_cuda, "
            "cactus_tpu_torch.ops.poa, cactus_tpu_torch.ops.poa_cuda, "
            "cactus_tpu_torch.hal_archive, cactus_tpu_torch.phases.bar\n"
            "import cactus_tpu_torch.pangenome.driver, "
            "cactus_tpu_torch.pangenome.layout2d, "
            "cactus_tpu_torch.pangenome.minigraph, "
            "cactus_tpu_torch.pangenome.split, "
            "cactus_tpu_torch.pangenome.vcf, "
            "cactus_tpu_torch.pangenome.patch, "
            "cactus_tpu_torch.pangenome.giraffe, "
            "cactus_tpu_torch.pangenome.indexes\n"
            "import cactus_tpu_torch.ops.seeds, "
            "cactus_tpu_torch.preprocessor.masking, "
            "cactus_tpu_torch.preprocessor.variants, "
            "cactus_tpu_torch.preprocessor.stats, "
            "cactus_tpu_torch.phases.blast, cactus_tpu_torch.prepare, "
            "cactus_tpu_torch.chains_export, cactus_tpu_torch.io.hal_hdf5, "
            "cactus_tpu_torch.io.bigwig, cactus_tpu_torch.graph.flowers, "
            "cactus_tpu_torch.ops.train, cactus_tpu_torch.utils.resources\n"
            "import cactus_tpu_torch.phast, cactus_tpu_torch.update, "
            "cactus_tpu_torch.parallel, cactus_tpu_torch.parallel.mesh, "
            "cactus_tpu_torch.parallel.distributed, "
            "cactus_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cactus_tpu' or "
            "m.startswith('cactus_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_every_module_of_the_jax_package_has_a_counterpart():
    missing = []
    src = os.path.join(REPO, "cactus_tpu")
    for root, _dirs, files in os.walk(src):
        for f in files:
            if not f.endswith((".py", ".cpp")):
                continue
            rel = os.path.relpath(os.path.join(root, f), src)
            want = PALLAS_COUNTERPARTS.get(rel, (rel,))
            missing += [w for w in want
                        if not os.path.exists(os.path.join(PORT, w))]
    assert not missing, missing


def _port_files(suffix=".py"):
    for root, _dirs, files in os.walk(PORT):
        if "_build" in root:
            continue
        for f in files:
            if f.endswith(suffix):
                yield os.path.join(root, f)


def test_no_jax_or_cactus_tpu_import_in_the_port():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "cactus_tpu", "networkx"):
                    bad.append((os.path.relpath(path, REPO), n))
    assert not bad, bad


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_are_byte_identical(rel):
    with open(os.path.join(REPO, "cactus_tpu", rel), "rb") as a, \
            open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read(), rel


def test_resolve_device_refuses_a_silent_cpu_fallback():
    from cactus_tpu_torch.ops import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    from cactus_tpu_torch.progressive import ProgressiveAligner
    from cactus_tpu_torch.utils.trees import parse_newick
    with pytest.raises(RuntimeError):
        ProgressiveAligner(parse_newick("(a:0.1,b:0.1)r;"), {})


@pytest.mark.parametrize("seed", range(6))
def test_vendored_matching_equals_networkx(seed):
    nx = pytest.importorskip("networkx")
    from cactus_tpu_torch.utils.matching import Graph, max_weight_matching
    rng = random.Random(seed)
    for _ in range(25):
        n = rng.randint(2, 40)
        edges, seen = [], set()
        for _e in range(rng.randint(1, 120)):
            u, v = rng.sample(range(n), 2)
            if (u, v) in seen or (v, u) in seen:
                continue
            seen.add((u, v))
            w = rng.random() * 10 if seed % 2 else rng.randint(1, 9)
            edges.append((u, v, w))
        g, h = nx.Graph(), Graph()
        g.add_weighted_edges_from(edges)
        h.add_weighted_edges_from(edges)
        for card in (False, True):
            assert (nx.max_weight_matching(g, maxcardinality=card)
                    == max_weight_matching(h, maxcardinality=card))


def test_match_ends_identical_to_jax_package():
    from cactus_tpu.phases import reference as jref
    from cactus_tpu_torch.phases import reference as tref
    rng = np.random.default_rng(5)
    live = list(range(30))
    weights = {}
    for _ in range(150):
        u, v = (int(x) for x in rng.integers(0, 60, 2))
        if u // 2 != v // 2:
            weights[(min(u, v), max(u, v))] = float(rng.random())
    for algo in ("blossom5", "maxCardinality", "greedy"):
        assert (jref.match_ends(live, weights, algo)
                == tref.match_ends(live, weights, algo))


def test_chain_scan_plain_version_matches_jax():
    from cactus_tpu.ops import chain as jchain
    from cactus_tpu_torch.ops import chain as tchain
    rng = np.random.default_rng(2)
    sets = []
    for n in (5, 40, 17):
        q = np.sort(rng.integers(0, 3000, n))
        t = q + rng.integers(-40, 40, n)
        t[n // 2:] += 500
        runs = np.stack([q, np.maximum(t, 0), rng.integers(8, 60, n)], 1)
        sets.append(tchain._pad_sorted_runs(
            runs[np.lexsort((runs[:, 1], runs[:, 0]))].astype(np.int32)))
    L = max(len(s) for s in sets)
    sets = [tchain._pad_sorted_runs(s, min_len=L) for s in sets]
    stack = np.stack(sets)
    ts_, tp_ = tchain._scan_padded(stack, 20, 1, 8192, 8)
    for row, s in enumerate(sets):
        js, jp = jchain._chain_scan(s[:, 0], s[:, 1], s[:, 2], 20, 1, 8192,
                                    8)
        np.testing.assert_array_equal(np.asarray(js), ts_[row])
        np.testing.assert_array_equal(np.asarray(jp), tp_[row])
    assert (tp_ >= 0).any()


def test_felsenstein_device_branch_matches_numpy_branch():
    from cactus_tpu_torch.phases.reference import felsenstein_ml
    from cactus_tpu_torch.utils.trees import parse_newick
    tree = parse_newick("((a:0.1,b:0.2)x:0.05,c:0.3)r;")
    names = [n.name for n in tree.preorder()]
    rng = np.random.default_rng(9)
    obs = rng.random((500, len(names), 4)).astype(np.float32)
    counts = np.ones((500, len(names)), np.int64)
    host = felsenstein_ml(obs, counts, tree, names)
    dev = felsenstein_ml(obs, counts, tree, names, device="cpu",
                         device_min_elements=0)
    np.testing.assert_array_equal(host, dev)


def test_config_from_numpy_rebuilds_the_jax_config():
    from cactus_tpu.config import Config as JConfig
    from cactus_tpu_torch.config import Config, config_from_numpy
    j = JConfig.default()
    j.blast.chunk_size = 4096
    d = dataclasses.asdict(j)
    d["bar"]["poa"]["sub_matrix"] = np.asarray(d["bar"]["poa"]["sub_matrix"])
    c = config_from_numpy(d)
    assert isinstance(c, Config)
    assert dataclasses.asdict(c) == dataclasses.asdict(j)
    assert c.blast.chunk_size == 4096

