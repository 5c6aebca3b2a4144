"""How far the port's Felsenstein pass and conservation scores stray from
the JAX package's (CPU).

    JAX_PLATFORMS=cpu python tests/phast_gap_report.py [--seeds N]

Both packages run the same float32 message pass (cactus_tpu/phast.py's
XLA code against cactus_tpu_torch/phast.py's PyTorch ops): the lift of a
child's message through its Jukes-Cantor matrix, the product into the
parent, the 1e-30-floored normalisation and the sum of log norms.  XLA on
the CPU fuses multiply-adds and brings its own log, so the per-column
log-likelihoods differ by a few ulps.  This script prints, on the inputs
tests/test_torch_phast.py uses (MAFs of 3-genome alignments, seeds 81,
41, 61, ... and the synthetic conserved-run blocks of
tests/test_chains_phast.py), the readings the test's tolerances are
taken from:

1. the column log-likelihood gap in ulps of the column's largest |ll|
   over its rows (`column_log_likelihoods` at three scales,
   `column_ll_multi` on the ratio, LRT and SCORE grids);
2. phylo_fit's scale in both packages (the golden section may take the
   other branch where two evaluations tie within those ulps);
3. phylo_p's score gap at the JAX package's scale, for each method (CONACC
   mode), absolute and relative to max(1, |score|), and for SCORE also
   where the curvature |I| is under 1e-2 (near its 1e-3 floor, where the
   score test's U^2 / |I| magnifies the ulps most) and where it is not;
4. the conservation verb's default track (LRT, CONACC), each package at
   its own fitted scale, relative to max(1, |score|).

It imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from cactus_tpu import phast as jp  # noqa: E402
from cactus_tpu_torch import phast as tp  # noqa: E402
from cactus_tpu_torch.utils.trees import parse_newick as t_newick  # noqa: E402
from test_torch_phast import _grid  # noqa: E402


def ulp_gap(a: np.ndarray, b: np.ndarray) -> float:
    """max over columns of |a - b| in ulps of the column's largest |a|
    (rows: axis 0 of 2-D inputs)."""
    a2, b2 = np.atleast_2d(a), np.atleast_2d(b)
    scale = np.spacing(np.abs(a2).max(axis=0).astype(np.float32))
    return float((np.abs(a2 - b2) / scale).max()) if a2.size else 0.0


def alignment_blocks(seed: int, root_len: int = 6000):
    """(blocks, newick) of a 3-genome JAX alignment's MAF (no ancestors)."""
    from cactus_tpu import progressive
    from cactus_tpu.io.fasta import Sequence
    from cactus_tpu.phases import hal as hal_mod
    from cactus_tpu.testutil import evolver
    from cactus_tpu.utils.trees import parse_newick
    newick = "((a:0.04,b:0.04)ab:0.04,c:0.08)root;"
    sim = evolver.simulate(parse_newick(newick), root_len=root_len,
                           seed=seed)
    genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in ["a", "b", "c"]}
    res = progressive.ProgressiveAligner(parse_newick(newick), genomes,
                                         min_chain_override=64).run()
    return hal_mod.hal2maf(res, None, include_ancestor=False), res.tree


def conserved_blocks(newick: str, n: int, lo: int, hi: int, seed: int,
                     copy_to=("b", "c")):
    """The synthetic blocks of tests/test_chains_phast.py: evolver leaves
    without indels, a run [lo, hi) of leaf a copied into `copy_to`."""
    from cactus_tpu.io.maf import MafBlock, MafRow
    from cactus_tpu.testutil import evolver
    from cactus_tpu.utils.trees import parse_newick
    tree = parse_newick(newick)
    sim = evolver.simulate(tree, root_len=n, seed=seed, indel_rate=0.0)
    leaves = tree.leaf_names()
    codes = {g: sim.genomes[g].codes.copy() for g in leaves}
    for g in copy_to:
        codes[g][lo:hi] = codes["a"][lo:hi]
    rows = [MafRow(src=f"{g}.c", start=0, size=n, strand="+", src_size=n,
                   text="".join("ACGT"[c] for c in codes[g]))
            for g in leaves]
    return [MafBlock(rows=rows)], tree


def inputs(n_seeds: int):
    out = []
    for seed in (81, 41, 61, 7, 13, 29, 97, 3)[:n_seeds]:
        out.append((f"alignment seed {seed}", *alignment_blocks(seed)))
    out.append(("conserved star", *conserved_blocks(
        "(a:0.2,b:0.2,c:0.2)root;", 1500, 500, 1000, 5)))
    out.append(("conserved subtree", *conserved_blocks(
        "((a:0.1,b:0.1)ab:0.1,(c:0.1,d:0.1)cd:0.1)root;", 1200, 400, 800, 9,
        copy_to=("b",))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3,
                    help="alignments to read (default 3)")
    opts = ap.parse_args()
    worst = {"ll": 0.0, "scale": 0.0, "ratio": 0.0, "LRT": 0.0,
             "SCORE": 0.0, "SCORE_I_floor": 0.0}
    for what, blocks, jtree in inputs(opts.seeds):
        ttree = t_newick(jtree.to_newick())
        obs, _meta = jp.columns_from_maf(blocks, jtree)
        gaps = []
        for s in (0.5, 1.0, 2.0):
            gaps.append(ulp_gap(jp.column_log_likelihoods(obs, jtree, s),
                                tp.column_log_likelihoods(obs, ttree, s,
                                                          device="cpu")))
        for name in ("ratio", "LRT", "SCORE"):
            sc = _grid(jtree, name)
            gaps.append(ulp_gap(jp.column_ll_multi(obs, jtree, sc),
                                tp.column_ll_multi(obs, ttree, sc,
                                                   device="cpu")))
        js = float(jp.phylo_fit(blocks, jtree))
        ts = float(tp.phylo_fit(blocks, ttree, device="cpu"))
        line = (f"{what}: {len(obs)} columns; ll gap {max(gaps):.2f} ulps "
                f"(by call {[round(g, 2) for g in gaps]}); scale JAX "
                f"{js!r} port {ts!r} (|diff| {abs(js - ts):.3g})")
        worst["ll"] = max(worst["ll"], max(gaps))
        worst["scale"] = max(worst["scale"], abs(js - ts))
        for method in ("ratio", "LRT", "SCORE"):
            a, ma = jp.phylo_p(blocks, jtree, neutral_scale=js,
                               method=method)
            b, mb = tp.phylo_p(blocks, ttree, neutral_scale=js,
                               method=method, device="cpu")
            assert ma == mb
            gap = float(np.abs(a - b).max()) if len(a) else 0.0
            rel = float((np.abs(a - b) / np.maximum(1.0, np.abs(a))).max()
                        ) if len(a) else 0.0
            worst[method] = max(worst[method], gap)
            worst[method + "_rel"] = max(worst.get(method + "_rel", 0.0),
                                         rel)
            line += (f"; {method} score gap {gap:.3g} (relative to "
                     f"max(1, |score|) {rel:.3g})")
            if method == "SCORE":
                ll = jp.column_ll_multi(obs, jtree,
                                        _grid(jtree, "SCORE", js))
                info = np.abs(-(ll[2] - 2 * ll[1] + ll[0]) / 0.0025)
                floor = info < 1e-2
                fl = float(np.abs(a - b)[floor].max()) if floor.any() \
                    else 0.0
                ok = float(np.abs(a - b)[~floor].max()) if (~floor).any() \
                    else 0.0
                worst["SCORE_I_floor"] = max(worst["SCORE_I_floor"], fl)
                line += (f" ({int(floor.sum())} columns with |I| < 1e-2: "
                         f"{fl:.3g}; the others {ok:.3g})")
        a, _m = jp.phylo_p(blocks, jtree, neutral_scale=js, method="LRT")
        b, _m = tp.phylo_p(blocks, ttree, neutral_scale=ts, method="LRT",
                           device="cpu")
        rel = float((np.abs(a - b) / np.maximum(1.0, np.abs(a))).max())
        worst["verb_LRT_rel"] = max(worst.get("verb_LRT_rel", 0.0), rel)
        line += f"; LRT track at each own scale {rel:.3g} (relative)"
        print(line, flush=True)
    print("worst: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
