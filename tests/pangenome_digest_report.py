"""Pin the pangenome path's outputs for chip_smoke.py's phase 9.

    JAX_PLATFORMS=cpu python tests/pangenome_digest_report.py [--work DIR]

Runs the JAX package (cactus_tpu) on the CPU on phase 9's inputs
(chip_smoke.pan_inputs: 4 haplotypes of PAN_NEWICK, seed 23): the
`pangenome` verb in star mode at 100 kb and in sv and refmap modes at
20 kb, `run_pangenome_split` on the two-chromosome input, and the `gfa
index|vcf|viz` and `patch` verbs on the star run's GFA.  Prints the
sha256 of every file each run wrote, and for each .lay.tsv the
layout_stress of the JAX package's layout_2d of its graph run on the
draws the port takes (`jax_layout_on_port_draws`: the layout files of the
two packages hold different random draws), as the PAN_DIGESTS literal that
chip_smoke.py holds the card's runs to.  Takes ~3 min.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pprint
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


@contextlib.contextmanager
def port_draws(n_ep: int, iters: int, batch: int, seed: int):
    """Within the block, jax.random hands cactus_tpu's layout_2d and
    sgd_sort the draws cactus_tpu_torch takes for the same arguments
    (`layout2d._draws`) instead of threefry bits, so that the JAX
    package's SGD runs on the port's pairs.  A key stands for (iteration,
    stream): PRNGKey gives iteration 0, split(key, 4) carries the next
    iteration and hands the body's three draws streams 1-3 of this one
    (randint: the termini; uniform: u, then the sign draws)."""
    import jax
    import jax.numpy as jnp
    from cactus_tpu_torch.pangenome import layout2d as tlay
    a, u, s = (jnp.asarray(x.numpy()) for x in tlay._draws(n_ep, iters,
                                                            batch, seed))
    rnd = jax.random
    saved = rnd.PRNGKey, rnd.split, rnd.randint, rnd.uniform

    def split(key, num=2):
        return jnp.stack([jnp.stack([key[0] + 1, key[1] * 0])]
                         + [jnp.stack([key[0], key[1] * 0 + i])
                            for i in range(1, num)])

    rnd.PRNGKey = lambda _seed: jnp.zeros(2, jnp.uint32)
    rnd.split = split
    rnd.randint = lambda key, shape, lo, hi: a[key[0]]
    rnd.uniform = lambda key, shape: jnp.where(key[1] == 2, u[key[0]],
                                               s[key[0]])
    try:
        yield
    finally:
        rnd.PRNGKey, rnd.split, rnd.randint, rnd.uniform = saved


def jax_layout_on_port_draws(g, ref, seed: int = 0, iters: int = 200,
                             batch: int = 1024):
    """cactus_tpu's layout_2d of `g` on the draws cactus_tpu_torch's
    layout_2d takes with the same arguments (`port_draws`)."""
    from cactus_tpu.pangenome import layout2d as jlay
    n_ep = len(jlay._step_termini(g, ref)[0])
    with port_draws(n_ep, iters, batch, seed):
        return jlay.layout_2d(g, ref_name=ref, iters=iters, batch=batch,
                              seed=seed)


def jax_stress_on_port_draws(lay, gfa=None) -> float:
    """layout_stress of cactus_tpu's layout_2d on the port's draws
    (`jax_layout_on_port_draws`, seed 0 as the pipeline lays out), on the
    graph `lay` was laid out on, read back through a .lay.tsv as the
    card's run is."""
    import chip_smoke as cs
    from cactus_tpu.pangenome import layout2d as jlay
    from cactus_tpu.pangenome.graph import read_gfa
    g, ref = cs.pan_layout_graph(lay, read_gfa, gfa)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "same_draws.lay.tsv")
        jlay.write_lay(path, g, jax_layout_on_port_draws(g, ref))
        X = jlay.read_lay(path)
    return round(jlay.layout_stress(g, X, ref_name=ref), 6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None,
                    help="keep the runs' outputs there (default: a "
                         "temporary directory, removed at the end)")
    opts = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from cactus_tpu import cli
    from cactus_tpu.io.fasta import Sequence
    from cactus_tpu.pangenome import layout2d
    from cactus_tpu.pangenome.driver import run_pangenome_split
    from cactus_tpu.pangenome.graph import read_gfa
    from cactus_tpu.testutil import evolver
    from cactus_tpu.utils.trees import parse_newick

    work = opts.work or tempfile.mkdtemp(prefix="pan_digests_")
    os.makedirs(work, exist_ok=True)
    try:
        seqfiles, split = cs.pan_inputs(work, evolver, parse_newick,
                                        Sequence)
        pinned = {}
        for run, argv in cs.pan_cli_runs(seqfiles, work):
            t0 = time.time()
            assert cli.main(argv) == 0
            pinned[run] = cs.pan_digests(argv[2], layout2d, read_gfa)
            print(f"{run}: {time.time() - t0:.1f} s", file=sys.stderr)
        t0 = time.time()
        run_pangenome_split(split, "ref", os.path.join(work, "split"))
        pinned["split"] = cs.pan_digests(os.path.join(work, "split"),
                                         layout2d, read_gfa)
        print(f"split: {time.time() - t0:.1f} s", file=sys.stderr)
        gfa = os.path.join(work, "star", "pangenome.gfa")
        for run, argv in cs.pan_verb_runs(work):
            t0 = time.time()
            assert cli.main(argv) == 0
            pinned[run] = cs.pan_digests(os.path.join(work, run), layout2d,
                                         read_gfa, gfa=gfa)
            print(f"{run}: {time.time() - t0:.1f} s", file=sys.stderr)
        for run, files in pinned.items():
            for rel, val in files.items():
                if isinstance(val, dict):
                    files[rel] = {"stress": jax_stress_on_port_draws(
                        os.path.join(work, run, rel),
                        gfa if run.startswith("gfa") else None)}
    finally:
        if opts.work is None:
            shutil.rmtree(work, ignore_errors=True)
    print("PAN_DIGESTS = " + pprint.pformat(pinned, width=76, compact=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
