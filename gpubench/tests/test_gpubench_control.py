"""The control, the reference one precision below the configuration's in
the program's place (int16 for the banded DP, bfloat16 for the pair-HMMs),
fails every cell's comparison at a size a test run holds, where the
program passes it (gpubench/readings.py, as it runs on the card at the
cells' own sizes)."""

import gpubench_small
import pytest
import torch

from gpubench import manifest, readings

# the banded control wraps only where scores pass 32,767: at the gap
# fills' divergence (~30 a column) pieces of more than ~1,100 bases
CELLS = {"mammals-gapfill": dict(max_pairs=2, max_len=2000, min_len=1500),
         "mammals-nested": dict(max_pairs=2, max_len=160, min_len=120),
         "pecan-posterior": dict(max_pairs=4, max_len=60, min_len=40)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(tmp_path, cell):
    root = gpubench_small.small_root(tmp_path, calls=1, **CELLS[cell])
    out = readings.readings(cell, [3], [4, 5, 6], torch.device("cpu"),
                            root=root, log=lambda s: None)
    _entry, _config, traffic = manifest.cell(cell, manifest.load(root),
                                             root)
    limits = traffic["checks"]
    assert all(v[0] <= limits[k] for k, v in out["program"].items())
    for i in range(3):
        assert any(v[i] > limits[k] for k, v in out["control"].items())
