"""Command-line entry points (python -m cactus_tpu_torch <command>).

The PyTorch/CUDA port carries the two verbs of a default run so far:
`align` (progressive alignment of a seqfile into an alignment store, with
optional HAL archive and MAF export) and `hal2maf` (MAF export from a
store).  The other verbs of the JAX package's CLI (cactus_tpu/cli.py) and
the `--mask` option of `align` exit with a "not ported yet" message; they
are queued in ROADMAP.md.

Device work runs on the current CUDA device unless `--device cpu` is
given (the plain PyTorch versions and the native C++ kernels).
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import Config
from .io.fasta import Sequence, read_fasta
from .io.seqfile import SeqFile
from .progressive import ProgressiveAligner
from .store import AlignmentStore

# verbs of cactus_tpu's CLI that this package does not carry yet
NOT_PORTED_VERBS = ("preprocess", "blast", "prepare", "update", "chains",
                    "conservation", "hal", "gfa", "stats", "maf2bigmaf",
                    "patch", "hal2seqfile", "pangenome")


def _log(msg: str) -> None:
    print(f"[cactus-tpu-torch] {msg}", file=sys.stderr, flush=True)


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"cactus_tpu_torch: {what} is not ported yet "
                      "(see ROADMAP.md); use python -m cactus_tpu for it")


def load_genomes_from_seqfile(sf: SeqFile, only: set[str] | None = None,
                              pp=None) -> dict[str, dict[str, Sequence]]:
    """Load + sanitize every genome (cutHeaders → checkUniqueHeaders →
    event prefixing; config XML <preprocessor> entries :20-43).  `only`
    restricts loading to the named events (--root subtrees)."""
    from .preprocessor.headers import sanitize_genome
    if pp is None:
        pp = Config.default().preprocessor
    genomes = {}
    for event, path in sf.paths.items():
        if only is not None and event not in only:
            continue
        seqs = read_fasta(path)
        genomes[event] = sanitize_genome(event, seqs, cut=pp.cut_headers)
    return genomes


def cmd_align(args) -> int:
    if args.mask:
        raise _not_ported("align --mask (repeat masking)")
    sf = SeqFile.parse(args.seqfile)
    tree = sf.tree if sf.tree is not None else sf.star_tree()
    if args.root:
        # reference `cactus --root`: align only the named subtree
        # (progressive_decomposition.py get_subtree semantics)
        node = tree.find(args.root)
        if node is None:
            raise SystemExit(f"--root {args.root!r} is not in the tree")
        node.parent = None
        node.length = None
        tree = node
        _log(f"restricted to subtree rooted at {args.root} "
             f"({len(tree.leaf_names())} genomes)")
    config = Config.default()
    if args.config:
        from .config_xml import load_config_xml
        config = load_config_xml(args.config, base=config)
        _log(f"loaded config overrides from {args.config}")
    genomes = load_genomes_from_seqfile(
        sf, only=set(tree.leaf_names()), pp=config.preprocessor)
    store = AlignmentStore(args.outdir)
    aligner = ProgressiveAligner(
        tree, genomes, config=config,
        min_chain_override=args.min_chain, store=store, log=_log,
        tree_workers=args.tree_workers, device=args.device)
    targets = ({t for t in args.target.split(",")}
               if args.target else None)
    result = aligner.run(targets=targets)
    if targets is not None:
        _log(f"computed target step(s) {sorted(targets)}; artifacts "
             "for finished steps only")
    from .phases import hal as hal_phase
    hal_phase.write_result_c2h(result, args.outdir + "/c2h")
    if args.hal:
        from .hal_archive import HalArchive
        HalArchive.from_result(args.hal, result)
        _log(f"wrote HAL archive {args.hal}")
    if args.maf:
        hal_phase.write_hal2maf(args.maf, result, args.ref_genome)
        _log(f"wrote {args.maf}")
    stats = hal_phase.hal_stats(result)
    with open(args.outdir + "/stats.json", "w") as fh:
        json.dump(stats, fh, indent=1)
    for row in stats:
        _log(f"{row['genome']}: {row['n_sequences']} seqs, "
             f"{row['length']} bp, {row['n_top_segments']} top, "
             f"{row['n_bottom_segments']} bottom")
    return 0


def cmd_hal2maf(args) -> int:
    from .io.maf import write_maf
    from .phases import hal as hal_phase
    store = AlignmentStore(args.store)
    result = store.load_result()
    blocks = hal_phase.hal2maf(result, args.ref_genome)
    if args.dup_filter:
        from .maf_tools import dup_filter
        blocks = dup_filter(blocks, mode=args.dup_filter,
                            ref_genome=args.ref_genome)
    if args.merge:
        from .maf_tools import merge_adjacent_blocks
        blocks = merge_adjacent_blocks(blocks)
    if args.norm:
        from .io.taf import taf_norm
        blocks = taf_norm(blocks)
    if args.taf:
        from .io.taf import taf_index, write_taf
        write_taf(args.out, blocks)
        taf_index(args.out)
        _log(f"wrote {args.out} (+.tai index, {len(blocks)} blocks)")
        return 0
    write_maf(args.out, blocks)
    _log(f"wrote {args.out} ({len(blocks)} blocks)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED_VERBS:
        raise _not_ported(f"the {argv[0]!r} verb")
    p = argparse.ArgumentParser(prog="cactus-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    pa = sub.add_parser("align", help="progressive alignment from a seqfile")
    pa.add_argument("seqfile")
    pa.add_argument("outdir")
    pa.add_argument("--maf", help="also write a MAF referenced on the root")
    pa.add_argument("--root", default=None,
                    help="align only the subtree rooted at this event "
                         "(reference `cactus --root`)")
    pa.add_argument("--hal", help="also write a durable .hal archive")
    pa.add_argument("--ref-genome", default=None)
    pa.add_argument("--min-chain", type=int, default=None,
                    help="override the melting minimum chain length")
    pa.add_argument("--mask", action="store_true",
                    help="(not ported yet) repeat-mask inputs")
    pa.add_argument("--config", default=None,
                    help="cactus-format config XML with parameter overrides")
    pa.add_argument("--tree-workers", type=int, default=1,
                    help="concurrent independent ancestor steps")
    pa.add_argument("--target", default=None,
                    help="compute only these ancestor step(s) "
                         "(comma-separated; deps resume from the store)")
    pa.add_argument("--device", default=None,
                    help="torch device for the kernels (default: the "
                         "current CUDA device; 'cpu' runs the plain "
                         "PyTorch versions)")
    pa.set_defaults(fn=cmd_align)

    pm = sub.add_parser("hal2maf", help="export MAF from an alignment store")
    pm.add_argument("store")
    pm.add_argument("out")
    pm.add_argument("--ref-genome", default=None)
    pm.add_argument("--dup-filter", default=None,
                    choices=["single", "single-ref", "consensus"])
    pm.add_argument("--merge", action="store_true",
                    help="merge abutting blocks")
    pm.add_argument("--norm", action="store_true",
                    help="taffy-norm block merging (gap fill ≤30bp)")
    pm.add_argument("--taf", action="store_true",
                    help="write TAF (+.tai index) instead of MAF")
    pm.set_defaults(fn=cmd_hal2maf)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
