"""chip_smoke.py's untimed phases in child processes, on the CPU.

The script runs the phases that feed no time of its kernels line (2, 5,
6, 9, 10 and 11) in child processes of itself, a group each, all at
once (`CHILD_GROUPS`, `run_children`).  These tests hold that every such
phase runs in exactly one group, that the timed phases stay out of the
groups, and that a child that fails or outlasts its time fails the wait
with every child stopped and its work directory removed.
"""

from __future__ import annotations

import glob
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_child_groups_run_each_untimed_phase_once():
    cs = _smoke()
    names = [n for group in cs.CHILD_GROUPS for n in group]
    assert len(names) == len(set(names))
    phases = cs.child_phases()
    assert sorted(names) == sorted(phases)
    labels = " ".join(label for label, _fn in phases.values())
    for n in (2, 5, 6, 9, 10, 11):
        assert f"phase {n} (" in labels
    for n in (3, 4, 7, 8):
        assert f"phase {n} (" not in labels


@pytest.mark.parametrize("timeout", [0.0, 120.0])
def test_failed_or_late_children_fail_the_wait(timeout):
    """At timeout 0 the children still running at the first look are
    killed as late; on the CPU a child that gets that far exits 1 (no
    CUDA).  Either way the wait raises, names the group, and leaves no
    work directory behind."""
    import torch
    if timeout and torch.cuda.is_available():
        pytest.skip("on a card the children would run their phases")
    cs = _smoke()
    build = os.path.join(ROOT, "cactus_tpu_torch", "_build")
    before = set(glob.glob(os.path.join(build, "smoke_children_*")))
    with pytest.raises(AssertionError, match="child phases failed: "
                       r"(cli|parallel) (exited|outlasted)"):
        cs.run_children((("cli",), ("parallel",)), timeout)
    assert set(glob.glob(os.path.join(build, "smoke_children_*"))) == before
