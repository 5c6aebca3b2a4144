"""How far the 3-state pair-HMM's float32 forward values lie from the same
steps run in float64, on the pair-HMM calls of chip_smoke.py phase 10's
`align --mask` run (phase 4's human-dog pair at 100 kb with planted
repeats, `chip_smoke.pipe_inputs`).

    JAX_PLATFORMS=cpu python tests/pairhmm_float64_report.py

Runs `align --mask --maf` on that input through cactus_tpu_torch with
`--device cpu` (its MAF is the one the card writes: both equal the JAX
package's pinned digest), keeps every pairhmm_fwd call, and reads the
forward values in log space, log(fM) + lsF, of the plain version
(ops/pairhmm.py::forward_banded) and of the kernels' schedule in float32
(tests/test_torch_pairhmm_schedule.py::model_forward, which
csrc/pairhmm.cu follows) against the plain steps in float64: the largest
gap over the cells whose plain fM lies above each floor (1e-30 is
chip_smoke.check_hmm's), and the cell of the largest gap between the two
float32 versions.  ~2 min on the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

FLOORS = (1e-30, 1e-25, 1e-20, 1e-15, 1e-10, 1e-6)


def path_calls(work):
    """Every pairhmm_fwd call of the human-dog `align --mask` on the CPU."""
    import torch

    import chip_smoke as cs
    from cactus_tpu_torch import cli
    from cactus_tpu_torch.ops import pairhmm_cuda
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick
    calls, real = [], pairhmm_cuda.pairhmm_fwd

    def keep(*a, **k):
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x
                            for x in a), dict(k)))
        return real(*a, **k)

    sf = cs.pipe_inputs(work, evolver, parse_newick)["human_dog"]
    maf = os.path.join(work, "human_dog.maf")
    pairhmm_cuda.pairhmm_fwd = keep
    try:
        assert cli.main(["align", sf, os.path.join(work, "hd"), "--mask",
                         "--maf", maf, "--device", "cpu"]) == 0
    finally:
        pairhmm_cuda.pairhmm_fwd = real
    same = cs.sha256_of(maf) == cs.PIPE_DIGESTS["align_mask_human_dog"]
    print(f"align --mask on the human-dog pair: {len(calls)} pairhmm_fwd "
          f"calls; MAF {'equal to' if same else 'NOT equal to'} the pinned "
          "digest")
    return calls


def main() -> int:
    import torch
    from test_torch_pairhmm_schedule import model_forward

    from cactus_tpu_torch.ops import pairhmm as tp
    with tempfile.TemporaryDirectory() as work:
        calls = path_calls(work)
    worst = {f: [0.0, 0.0, 0.0] for f in FLOORS}
    cell = (0.0, None)
    for i, (a, k) in enumerate(calls):
        runs = [tp.forward_banded(*a, **k), model_forward(*a, **k)[:3],
                tp.forward_banded(*a, **k, dtype=torch.float64)]
        plain, model, f64 = (torch.log(r[0].double())
                             + r[1].double()[..., None] for r in runs)
        fM = runs[0][0]
        for f in FLOORS:
            live = fM > f
            for j, (x, y) in enumerate(((plain, f64), (model, f64),
                                        (model, plain))):
                gap = float(torch.where(live, (x - y).abs(),
                                        torch.zeros_like(x)).max())
                worst[f][j] = max(worst[f][j], gap)
        gap = torch.where(fM > FLOORS[0], (model - plain).abs(),
                          torch.zeros_like(plain))
        if float(gap.max()) > cell[0]:
            at = tuple(int(x) for x in torch.nonzero(gap == gap.max())[0])
            cell = (float(gap.max()),
                    (i, list(a[0].shape), k["band"], at, float(fM[at]),
                     float(plain[at]), float(model[at]), float(f64[at])))
    print("largest |log(fM) + lsF| gap over the cells whose plain fM lies "
          "above the floor (fM is its row's share of the row maximum):")
    for f in FLOORS:
        p64, m64, mp = worst[f]
        print(f"  fM > {f:g}: plain vs float64 {p64:.4g}, kernel schedule "
              f"vs float64 {m64:.4g}, kernel schedule vs plain {mp:.4g}")
    i, shape, band, at, v, p, m, d = cell[1]
    print(f"largest kernel-schedule vs plain gap {cell[0]:.4g}: call {i} "
          f"{shape} band {band}, cell {at}, plain fM {v:.4g}; log(fM) + lsF "
          f"plain {p:.4f}, kernel schedule {m:.4f}, float64 {d:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
