"""Accuracy of the pecan BAR engine on the evolverMammals human-dog pair (CPU).

    JAX_PLATFORMS=cpu python tests/pecan_accuracy_report.py [root_len] [--port]

Simulates (simHuman_chr6:0.164611,simDog_chr6:0.195928)root; at root_len
(default 60000) with seed 41, aligns it with the JAX package's
ProgressiveAligner under the default Config with partialOrderAlignment
off (the pecan engine, 5-state pair-HMM), and prints the pair's recall and
precision against the simulation's truth, with the wall time.  These are
the constants chip_smoke.py holds the port's GPU run to.  With --port the
PyTorch port (device="cpu", its plain PyTorch versions) aligns the same
input too, and the script prints its reading and whether the predicted
pair sets of the two packages are identical.  A CPU run: no time here is
a device number.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from cactus_tpu import progressive as jprog  # noqa: E402
from cactus_tpu.config import Config  # noqa: E402
from cactus_tpu.io.fasta import Sequence  # noqa: E402
from cactus_tpu.testutil import evolver  # noqa: E402
from cactus_tpu.testutil.comparator import score_pairs  # noqa: E402
from cactus_tpu.utils.trees import parse_newick  # noqa: E402

NEWICK = "(simHuman_chr6:0.164611,simDog_chr6:0.195928)root;"


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root_len = int(args[0]) if args else 60_000
    sim = evolver.simulate(parse_newick(NEWICK), root_len=root_len, seed=41)
    a, b = sim.tree.leaf_names()
    truth = sim.truth_pairs_arr(a, b)
    cfg = Config.default()
    cfg.bar.partial_order_alignment = False
    t0 = time.time()
    jres = jprog.ProgressiveAligner(
        parse_newick(NEWICK),
        {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in (a, b)}, config=cfg).run()
    jpred = jprog.leaf_pairs_arr(jres, a, b)
    s = score_pairs(truth, jpred)
    print(f"cactus_tpu (JAX, CPU), root_len {root_len}: recall "
          f"{s.recall:.4f} precision {s.precision:.4f} "
          f"({time.time() - t0:.1f} s)", flush=True)
    if "--port" not in sys.argv:
        return
    from cactus_tpu_torch import progressive as tprog
    from cactus_tpu_torch.config import config_from_numpy
    from cactus_tpu_torch.io.fasta import Sequence as TSequence
    from cactus_tpu_torch.utils.trees import parse_newick as tparse
    t0 = time.time()
    tres = tprog.ProgressiveAligner(
        tparse(NEWICK),
        {ev: {f"{ev}.c": TSequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in (a, b)},
        config=config_from_numpy(dataclasses.asdict(cfg)),
        device="cpu").run()
    tpred = tprog.leaf_pairs_arr(tres, a, b)
    s = score_pairs(truth, tpred)
    print(f"cactus_tpu_torch (device cpu), root_len {root_len}: recall "
          f"{s.recall:.4f} precision {s.precision:.4f} "
          f"({time.time() - t0:.1f} s); predicted pairs identical to "
          f"cactus_tpu's: {np.array_equal(jpred, tpred)}", flush=True)


if __name__ == "__main__":
    main()
