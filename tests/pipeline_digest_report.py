"""Pin the step-by-step pipeline's outputs for chip_smoke.py's phase 10.

    JAX_PLATFORMS=cpu python tests/pipeline_digest_report.py [--work DIR]
                                                           [--port-cpu]

Runs the JAX package (cactus_tpu) on the CPU on phase 10's inputs
(chip_smoke.pipe_inputs): `preprocess --lastz-mask --tandem-mask
--satellite softmask` on the five evolverMammals genomes (600 kb root,
seed 41), `align --mask --maf` on phase 4's human-dog pair at 100 kb,
then on the two-genome seqfile of phase 5 prepare's plan run by `sh`
(`python -m cactus_tpu`:
preprocess, `align --target root`, the export), `align --mask --maf`,
`blast --events a,b` in the default, --fastga and --minimap2 modes, and
`stats` on the plan's store.  Prints
the sha256 of each output as the PIPE_DIGESTS literal that chip_smoke.py
holds the card's runs to.  With --port-cpu it runs cactus_tpu_torch with
--device cpu instead (its plan on the CPU too), to check the literal
against the port's plain versions.  Takes ~2 min for cactus_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import pprint
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None,
                    help="keep the runs' outputs there (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--port-cpu", action="store_true",
                    help="run cactus_tpu_torch with --device cpu instead")
    opts = ap.parse_args()
    import chip_smoke as cs
    if opts.port_cpu:
        from cactus_tpu_torch import cli
        from cactus_tpu_torch.testutil import evolver
        from cactus_tpu_torch.utils.trees import parse_newick
        package, device = "cactus_tpu_torch", ["--device", "cpu"]
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from cactus_tpu import cli
        from cactus_tpu.testutil import evolver
        from cactus_tpu.utils.trees import parse_newick
        package, device = "cactus_tpu", []

    work = opts.work or tempfile.mkdtemp(prefix="pipe_digests_")
    os.makedirs(work, exist_ok=True)
    try:
        seqfiles = cs.pipe_inputs(work, evolver, parse_newick)
        pinned = {}
        t0 = time.time()
        prep = os.path.join(work, "prep")
        assert cli.main(["preprocess", seqfiles["mammals"], prep,
                         *cs.PIPE_PREPROCESS_OPTS, *device]) == 0
        pinned["preprocess"] = cs.pan_digests(prep)
        print(f"preprocess: {time.time() - t0:.1f} s", file=sys.stderr)
        for run, argv, out, _kernels in cs.pipe_verb_runs(seqfiles, work):
            t0 = time.time()
            assert cli.main([*argv, *device]) == 0
            pinned[run] = cs.sha256_of(out)
            print(f"{run}: {time.time() - t0:.1f} s", file=sys.stderr)
        # the port's plan runs on the default device: its `python` asks
        # for the CPU
        env = cs.python_on_path(work, " ".join(device))
        plan_out = os.path.join(work, "plan")
        cmds, secs = cs.run_plan(package, seqfiles["pair"], plan_out, work,
                                 env)
        pinned["plan"] = cs.sha256_of(os.path.join(plan_out, "out.maf"))
        print(f"plan ({len(cmds)} commands): {secs:.1f} s", file=sys.stderr)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["stats", plan_out]) == 0
        pinned["stats"] = hashlib.sha256(buf.getvalue().encode()).hexdigest()
    finally:
        if opts.work is None:
            shutil.rmtree(work, ignore_errors=True)
    print("PIPE_DIGESTS = " + pprint.pformat(pinned, width=76,
                                             compact=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
