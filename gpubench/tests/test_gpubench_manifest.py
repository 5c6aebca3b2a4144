"""BENCHMARK.json against the contract's schema; cells, drivers and
metrics found by name; the import guard."""

import json
import os
import subprocess
import sys

import gpubench_small  # noqa: F401  (puts the repo root on sys.path)
import pytest

from gpubench import guard, manifest


def test_manifest_meets_the_schema():
    assert manifest.problems(manifest.load()) == []
    # and with the retired cells put back
    assert manifest.problems(gpubench_small.with_retired(
        manifest.load())) == []


def test_schema_catches_bad_names_units_and_bounds():
    bench = manifest.load()
    bad = json.loads(json.dumps(bench))
    bad["end_to_end"][0]["unit"] = "bases per s"
    bad["end_to_end"][1]["bound"] = 0.5
    bad["workloads"][0]["name"] = "has space"
    bad["per_layer"][0]["moves"] = "nothing"
    found = " ".join(manifest.problems(bad))
    for what in ("unit/better", "bound", "workload name", "moves"):
        assert what in found


@pytest.mark.parametrize("key", ["variants", "sample_pairs"])
def test_schema_catches_a_traffic_file_without_a_key(tmp_path, key):
    root = gpubench_small.small_root(tmp_path)
    traffic = manifest.load(root)["workloads"][0]["traffic"]
    path = os.path.join(root, "gpubench", "workloads", f"{traffic}.json")
    with open(path) as fh:
        data = json.load(fh)
    del data[key]
    with open(path, "w") as fh:
        json.dump(data, fh)
    found = manifest.problems(manifest.load(root), root)
    assert f"traffic {traffic} lacks {key}" in found
    assert not [p for p in found if p.startswith("traffic")
                and p != f"traffic {traffic} lacks {key}"]


@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cells_are_found_by_name(name):
    entry, config, traffic = manifest.cell(name)
    assert config["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    drv = manifest.driver(traffic).Driver
    assert set(drv.checks) <= set(traffic["checks"])
    assert traffic["calls"] and all(c["pairs"] for c in traffic["calls"])
    for m in manifest.metrics_of(manifest.load(), name, trace=True):
        assert callable(manifest.reader(m["name"]))


def test_every_metric_file_is_named_in_the_manifest():
    """In BENCHMARK.json, or among a retired cell's own metrics."""
    names = {m["name"] for m in manifest.load()["per_layer"]} | {
        m["name"] for cell in gpubench_small.retired()
        for m in cell["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(manifest.HERE,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == names


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(
        ["cactus_tpu_torch", "cactus_tpu_torch.ops", "jaxtyping",
         "numpy"]) == []
    assert guard.forbidden_modules(
        ["cactus_tpu.ops.banded", "jax", "jaxlib.xla", "flax"]) == [
        "cactus_tpu.ops.banded", "flax", "jax", "jaxlib.xla"]


def test_the_harness_and_the_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.harness, gpubench.readings, gpubench.record; "
            "import gpubench.drivers.banded, gpubench.drivers.pairhmm, "
            "gpubench.drivers.pairhmm5; from gpubench import guard; "
            "print(guard.forbidden_modules())" % manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    """gpubench/reference/ imports no module of the port, of JAX or of the
    JAX package (its own modules and numpy / torch only)."""
    import ast
    ref = os.path.join(manifest.HERE, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("numpy", "torch",
                                             "__future__"), (name, mod)


def test_run_exits_without_a_result_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and gpubench/ has no program:
    the run fails and prints no result line."""
    import shutil
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mammals-gapfill",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
