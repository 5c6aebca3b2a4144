"""Accuracy of the poa BAR engine on two evolver inputs (CPU).

    JAX_PLATFORMS=cpu python tests/poa_accuracy_report.py [mammals|star] [--port]

`mammals`: the evolverMammals tree of tests/test_evolver_gate.py at
root_len 600 kb, seed 41, tree_workers=2.  `star`: the 4-leaf star
(simHuman, simCow, simDog, simMouse under one root) at root_len 200 kb,
seed 41 — a star gives ends of 3 or more members, so progressive round 2
and later run.  Both use the default Config with bar.msa_engine="poa".
With no name, both run.

For each input the JAX package's ProgressiveAligner aligns it and the
script prints the average of mean pairwise recall and precision, the
lowest pair recall and precision, the wall time and BAR's time per
ancestor step, and poa_msa_batch's calls with their group counts and
member counts.  These are the constants chip_smoke.py holds the port's
GPU run to.  With --port the PyTorch port (device="cpu", its plain
PyTorch versions) aligns the same input too, and the script prints its
reading and whether every pair's predicted pair set is identical to the
JAX package's.  A CPU run: no time here is a device number.
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
from cactus_tpu.ops import poa as jpoa  # noqa: E402
from cactus_tpu.testutil import evolver  # noqa: E402
from cactus_tpu.testutil.comparator import score_pairs  # noqa: E402
from cactus_tpu.utils.trees import parse_newick  # noqa: E402

INPUTS = {
    "mammals": ("((simHuman_chr6:0.144018,(simMouse_chr6:0.084509,"
                "simRat_chr6:0.091589)mr:0.271974)anc1:0.020593,"
                "(simCow_chr6:0.18908,simDog_chr6:0.16303)anc2:0.032898)"
                "root;", 600_000, 2),
    "star": ("(simHuman_chr6:0.144018,simCow_chr6:0.18908,"
             "simDog_chr6:0.16303,simMouse_chr6:0.3)root;", 200_000, 1),
}


def reading(sim, res, leaves, leaf_pairs):
    """(average, lowest recall, lowest precision, predicted pairs)."""
    recalls, precisions, preds = [], [], []
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            pred = leaf_pairs(res, leaves[i], leaves[j])
            s = score_pairs(sim.truth_pairs_arr(leaves[i], leaves[j]), pred)
            recalls.append(s.recall)
            precisions.append(s.precision)
            preds.append(pred)
    avg = (float(np.mean(recalls)) + float(np.mean(precisions))) / 2
    return avg, min(recalls), min(precisions), preds


def run(name: str, port: bool) -> None:
    nwk, root_len, workers = INPUTS[name]
    sim = evolver.simulate(parse_newick(nwk), root_len=root_len, seed=41)
    leaves = sim.tree.leaf_names()
    cfg = Config.default()
    cfg.bar.msa_engine = "poa"
    calls = []
    batch = jpoa.poa_msa_batch

    def spy(groups, params):
        sizes = np.bincount([len(g) for g in groups])
        calls.append((len(groups), {k: int(c) for k, c in enumerate(sizes)
                                    if c}))
        return batch(groups, params)

    jpoa.poa_msa_batch = spy
    t0 = time.time()
    try:
        jres = jprog.ProgressiveAligner(
            parse_newick(nwk),
            {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
             for ev in leaves}, config=cfg, tree_workers=workers).run()
    finally:
        jpoa.poa_msa_batch = batch
    wall = time.time() - t0
    avg, lo_r, lo_p, jpreds = reading(sim, jres, leaves, jprog.leaf_pairs_arr)
    bar = {ev: round(st.timings["bar"], 1) for ev, st in jres.steps.items()}
    print(f"cactus_tpu (JAX, CPU) {name}, root_len {root_len}: average "
          f"{avg:.4f}, lowest pair recall {lo_r:.4f}, lowest pair precision "
          f"{lo_p:.4f} ({wall:.1f} s; BAR s per step {bar}); poa_msa_batch "
          f"calls (groups, {{members: groups}}): {calls}", flush=True)
    if not port:
        return
    from cactus_tpu_torch import progressive as tprog
    from cactus_tpu_torch.config import config_from_numpy
    from cactus_tpu_torch.io.fasta import Sequence as TSequence
    from cactus_tpu_torch.utils.trees import parse_newick as tparse
    t0 = time.time()
    tres = tprog.ProgressiveAligner(
        tparse(nwk),
        {ev: {f"{ev}.c": TSequence(f"{ev}.c", sim.genomes[ev].codes)}
         for ev in leaves},
        config=config_from_numpy(dataclasses.asdict(cfg)),
        tree_workers=workers, device="cpu").run()
    avg, lo_r, lo_p, tpreds = reading(sim, tres, leaves,
                                      tprog.leaf_pairs_arr)
    same = all(np.array_equal(a, b) for a, b in zip(jpreds, tpreds))
    print(f"cactus_tpu_torch (device cpu) {name}, root_len {root_len}: "
          f"average {avg:.4f}, lowest pair recall {lo_r:.4f}, lowest pair "
          f"precision {lo_p:.4f} ({time.time() - t0:.1f} s); predicted pairs "
          f"identical to cactus_tpu's: {same}", flush=True)


def main() -> None:
    names = [a for a in sys.argv[1:] if not a.startswith("--")] or \
        list(INPUTS)
    for name in names:
        run(name, "--port" in sys.argv)


if __name__ == "__main__":
    main()
