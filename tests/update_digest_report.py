"""Pin phase 11's outputs for chip_smoke.py: the store, its updates, the
neutral scales and the chunked one-process MAF.

    JAX_PLATFORMS=cpu python tests/update_digest_report.py [--work DIR]
                                                         [--port-cpu]

Runs the JAX package (cactus_tpu) on the CPU on phase 11's inputs
(chip_smoke.update_inputs: phase 3's five evolverMammals genomes at 600
kb, seed 41, and the three genomes the updates bring): `align --hal`
into a store, then `update add` under anc1, `update add --branch` above
simCow_chr6, `update replace` of simDog_chr6 and `update remove` of
simMouse_chr6, each with --hal and followed by `hal2maf`
(chip_smoke.update_argvs); phylo_fit's neutral scale on the updated
store: the conservation verb's without and with --annotation (the
annotation of chip_smoke.phast_gff on chip_smoke.UPD_REF's sequences),
and phylo_fit's on those 4d sites; and ProgressiveAligner at
blast.chunk_size chip_smoke.UPD_CHUNK on the five genomes
(chip_smoke.chunked_run).
Prints the UPD_DIGESTS and UPD_SCALES literals chip_smoke.py holds the
card's runs to.  With --port-cpu it runs cactus_tpu_torch with --device
cpu instead (the digests must be the same literal, the scales within
chip_smoke.UPD_SCALE_ATOL), and also the chunked run on a 2-shard CPU
mesh, whose MAF must equal the one-process MAF.  Takes ~10 min for
cactus_tpu.
"""

from __future__ import annotations

import argparse
import json
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
        package, device, kw = "cactus_tpu_torch", ["--device", "cpu"], \
            {"device": "cpu"}
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        package, device, kw = "cactus_tpu", [], {}
    import importlib
    mod = {m: importlib.import_module(f"{package}.{m}")
           for m in ("cli", "phast", "phases.hal", "store",
                     "testutil.evolver", "utils.trees")}
    cli = mod["cli"]

    work = opts.work or tempfile.mkdtemp(prefix="update_digests_")
    os.makedirs(work, exist_ok=True)
    try:
        inputs = cs.update_inputs(work, mod["testutil.evolver"],
                                  mod["utils.trees"].parse_newick)
        pinned = {}
        for run, argv in cs.update_argvs(inputs):
            t0 = time.time()
            assert cli.main([*argv, *device]) == 0
            maf = os.path.join(work, f"{run}.maf")
            assert cli.main(["hal2maf", inputs["store"], maf]) == 0
            pinned[run] = cs.update_digests(inputs["store"], maf,
                                            inputs["hal"])
            print(f"{run}: {time.time() - t0:.1f} s", file=sys.stderr)
        t0 = time.time()
        phast = mod["phast"]
        result = mod["store"].AlignmentStore(inputs["store"]).load_result()
        tree = result.tree
        ref_seqs = result.genomes[cs.UPD_REF]
        gff = cs.phast_gff(os.path.join(work, "genes.gff"), ref_seqs)
        scales = {}
        for key, extra in (("all", []), ("annotation", ["--annotation",
                                                        gff])):
            out = os.path.join(work, f"cons_{key}.wig")
            assert cli.main(["conservation", inputs["store"], out, *extra,
                             *device]) == 0
            with open(out + ".mod.json") as fh:
                scales[key] = json.load(fh)["rate_scale"]
        blocks = mod["phases.hal"].hal2maf(result, None,
                                           include_ancestor=False)
        sites = phast.four_d_sites(ref_seqs, phast.gff_cds_transcripts(gff))
        scales["4d"] = float(phast.phylo_fit(blocks, tree, sites=sites,
                                             **kw))
        obs, meta = phast.columns_from_maf(blocks, tree)
        _o, kept = phast.filter_columns_to_sites(obs, meta, sites)
        print(f"scales: {time.time() - t0:.1f} s ({len(kept)} of "
              f"{len(meta)} columns on the 4d sites of {cs.UPD_REF})",
              file=sys.stderr)
        t0 = time.time()
        one = os.path.join(work, "chunked.maf")
        _wall, _tasks = cs.chunked_run(package, inputs["seqfile"], one, **kw)
        pinned["chunked"] = cs.sha256_of(one)
        print(f"chunked: {time.time() - t0:.1f} s", file=sys.stderr)
        if opts.port_cpu:
            t0 = time.time()
            two = os.path.join(work, "chunked2.maf")
            _wall, tasks = cs.chunked_run(package, inputs["seqfile"], two,
                                          n_devices=2, **kw)
            same = cs.sha256_of(two) == pinned["chunked"]
            print(f"chunked on a 2-shard CPU mesh: {time.time() - t0:.1f} "
                  f"s, blast tasks {tasks}, MAF "
                  f"{'equal to' if same else 'DIFFERENT from'} the "
                  "one-process MAF", file=sys.stderr)
    finally:
        if opts.work is None:
            shutil.rmtree(work, ignore_errors=True)
    print("UPD_DIGESTS = " + pprint.pformat(pinned, width=76,
                                            compact=False))
    print(f"UPD_SCALES = {scales!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
