"""ops/cuda_build.py's build targets (CPU): each library's name hashes its
source, every csrc/*.cuh header and nvcc's flags, so editing a header
that sources include (csrc/cluster.cuh) rebuilds every one of them."""

import os

from cactus_tpu_torch.ops import cuda_build


def test_header_edit_changes_every_target(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    names = ("pairhmm", "pairhmm5", "banded")
    for name in names:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    (csrc / "cluster.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))

    def targets():
        return {n: cuda_build._target(n)[1] for n in names}

    first = targets()
    assert first == targets()                 # the hash is stable
    assert all(os.path.basename(t).startswith(f"lib{n}_")
               for n, t in first.items())
    (csrc / "cluster.cuh").write_text("// two\n")
    second = targets()
    assert all(second[n] != first[n] for n in names)
    # a source's edit moves its own target only
    (csrc / "pairhmm.cu").write_text("// pairhmm, edited\n")
    third = targets()
    assert third["pairhmm"] != second["pairhmm"]
    assert third["pairhmm5"] == second["pairhmm5"]
    # a new header counts as well
    (csrc / "extra.cuh").write_text("// extra\n")
    assert all(t != third[n] for n, t in targets().items())


def test_the_sources_include_the_shared_header():
    """The pair-HMM sources take their cluster launcher from
    csrc/cluster.cuh, which the targets hash."""
    csrc = cuda_build.CSRC
    assert os.path.exists(os.path.join(csrc, "cluster.cuh"))
    for name in ("pairhmm", "pairhmm5"):
        with open(os.path.join(csrc, f"{name}.cu")) as fh:
            assert '#include "cluster.cuh"' in fh.read()
