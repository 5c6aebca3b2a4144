"""Command-line entry points (python -m cactus_tpu_torch <command>).

The PyTorch/CUDA port carries `align` (progressive alignment of a
seqfile into an alignment store, with optional HAL archive and MAF
export), `hal2maf` (MAF export from a store), `pangenome` (the star, SV-
graph and refmap pangenome builders, with --stage), `gfa` (indexes, VCF
and viz of an external GFA) and `patch` (scaffold an assembly along a
graph's donor walks).  The other verbs of the JAX package's CLI
(cactus_tpu/cli.py) and the `--mask` option of `align` exit with a "not
ported yet" message; they are queued in ROADMAP.md.

Every verb that takes `--device` (`align`, `pangenome`, and `gfa` for
its viz tool's layout) runs its device work on the current CUDA device
unless `--device cpu` is given (the plain PyTorch versions and the
native C++ kernels); without a GPU the default raises.  `patch` and the
index and vcf tools of `gfa` do host work only.
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
                    "conservation", "hal", "stats", "maf2bigmaf",
                    "hal2seqfile")


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


def cmd_pangenome(args) -> int:
    from .ops import resolve_device
    from .pangenome import driver as pdrv
    device = resolve_device(args.device)
    sf = SeqFile.parse(args.seqfile)
    genomes = load_genomes_from_seqfile(sf)
    ref = args.reference or sf.order[0]
    kw = dict(min_chain_override=args.min_chain,
              filter_depth=args.filter or None, viz=not args.no_viz,
              log=_log, device=device)
    if args.mode == "sv":
        # the full minigraph-cactus tier: iterative SV graph → graphmap
        # → base-level align-to-graph → join (cactus-pangenome); with
        # --stage, run ONE stage against the outdir's artifacts (the
        # cactus-minigraph/-graphmap/-align/-graphmap-join
        # decomposition — staged == monolithic byte-for-byte)
        stages = (args.stage,) if args.stage else pdrv.SV_STAGES
        pdrv.run_pangenome_sv(genomes, ref, args.outdir, stages=stages,
                              **kw)
    elif args.mode == "refmap":
        pdrv.run_pangenome_refmap(genomes, ref, args.outdir, **kw)
    else:
        pdrv.run_pangenome(genomes, ref, args.outdir, **kw)
    return 0


def cmd_patch(args) -> int:
    """Scaffold + gap-fill an assembly along donor walks of a pangenome
    graph (cactus-panpatch analog; host work only)."""
    import os
    from .io.fasta import write_fasta
    from .pangenome.graph import read_gfa
    from .pangenome.patch import patch_assembly
    g = read_gfa(args.gfa)
    patched, report = patch_assembly(g, args.target, args.donors.split(","),
                                     require_telomeres=args.telomeres)
    os.makedirs(args.outdir, exist_ok=True)
    fa = os.path.join(args.outdir, f"{args.target}.patched.fa")
    write_fasta(fa, patched)
    with open(os.path.join(args.outdir, "patch_report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    _log(f"patched {len(report['placed'])} contigs "
         f"({len(report['unplaced'])} unplaced) → {fa}")
    return 0


def cmd_gfa(args) -> int:
    """Consume an EXTERNAL GFA (vg-style): indexes, VCF, viz/layout.

    The pangenome drivers emit these artifacts for graphs built here;
    this verb runs the same tooling over any GFA v1.x with P/W paths
    (vg index / vg deconstruct / odgi viz equivalents).  Only the viz
    tool's 2D layout runs on the device (`--device`)."""
    import os
    from .pangenome.graph import graph_stats, read_gfa
    g = read_gfa(args.gfa)
    ref = args.reference or sorted(g.walks)[0]
    if ref not in g.walks:
        raise SystemExit(f"--reference {ref!r} is not a path; known: "
                         f"{sorted(g.walks)[:8]}...")
    if args.tool == "index":
        os.makedirs(args.out, exist_ok=True)
        from .pangenome.giraffe import DistanceIndex, MinimizerIndex
        from .pangenome.indexes import degree_stats, save_gbz, snarls
        save_gbz(os.path.join(args.out, "graph.gbz"), g)
        MinimizerIndex.build(g).save(os.path.join(args.out, "graph.min"))
        DistanceIndex.build(g, ref).save(os.path.join(args.out, "graph.dist"))
        sn = snarls(g, ref)
        with open(os.path.join(args.out, "snarls.json"), "w") as fh:
            json.dump([dict(start=s.start, end=s.end, level=s.level,
                            span=s.span, n_nodes=s.n_nodes)
                       for s in sn], fh)
        st = dict(graph_stats(g), **degree_stats(g))
        with open(os.path.join(args.out, "stats.json"), "w") as fh:
            json.dump(st, fh, indent=1, default=str)
        _log(f"indexed {g.n_nodes} nodes / {len(g.walks)} paths "
             f"-> {args.out}")
    elif args.tool == "vcf":
        from .pangenome import vcf as vcf_mod
        vcf_mod.write_vcf(args.out, g, ref)
        _log(f"wrote {args.out}")
    elif args.tool == "viz":
        from .ops import resolve_device
        from .pangenome.layout2d import draw, layout_2d, write_lay
        device = resolve_device(args.device)
        from .pangenome.viz import viz as render_viz
        render_viz(g, args.out, ref_name=ref)
        base = args.out.rsplit(".", 1)[0]
        X = layout_2d(g, ref_name=ref, device=device)
        write_lay(base + ".lay.tsv", g, X)
        draw(g, X, base + ".draw.png")
        _log(f"wrote {args.out} (+.lay.tsv/.draw.png)")
    return 0


def _add_device(parser, what: str = "the kernels") -> None:
    parser.add_argument("--device", default=None,
                        help=f"torch device for {what} (default: the "
                             "current CUDA device; 'cpu' runs the plain "
                             "PyTorch versions)")


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
    _add_device(pa)
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

    pf = sub.add_parser("gfa", help="consume an external GFA: "
                        "index/vcf/viz (vg/odgi-style tools)")
    pf.add_argument("tool", choices=["index", "vcf", "viz"])
    pf.add_argument("gfa")
    pf.add_argument("out")
    pf.add_argument("--reference", default=None,
                    help="reference path name (default: first path)")
    _add_device(pf, "the viz tool's 2D layout")
    pf.set_defaults(fn=cmd_gfa)

    ppt = sub.add_parser("patch",
                         help="scaffold + gap-fill an assembly along "
                              "pangenome donor walks (cactus-panpatch)")
    ppt.add_argument("gfa")
    ppt.add_argument("target", help="event name of the assembly to patch")
    ppt.add_argument("outdir")
    ppt.add_argument("--donors", required=True,
                     help="comma-separated donor events, best first")
    ppt.add_argument("--telomeres", action="store_true",
                     help="require telomeric anchors at contig ends")
    ppt.set_defaults(fn=cmd_patch)

    pg = sub.add_parser("pangenome",
                        help="star pangenome build → GFA + VCF")
    pg.add_argument("seqfile")
    pg.add_argument("outdir")
    pg.add_argument("--reference", default=None,
                    help="reference genome (default: first in seqfile)")
    pg.add_argument("--min-chain", type=int, default=64)
    pg.add_argument("--stage",
                    choices=["minigraph", "graphmap", "align", "join"],
                    default=None,
                    help="run ONE sv-mode stage against the outdir's "
                         "artifacts (stage-decomposed cactus-pangenome)")
    pg.add_argument("--mode", choices=["star", "sv", "refmap"],
                    default="star",
                    help="star: one star alignment (cactus-align "
                         "--pangenome); sv: minigraph-cactus SV-graph "
                         "pipeline (cactus-pangenome); refmap: "
                         "star-to-reference (cactus-refmap)")
    pg.add_argument("--filter", type=int, default=2,
                    help="allele-frequency filter tier depth (0 = off; "
                    "graphmap-join --filter)")
    pg.add_argument("--no-viz", action="store_true",
                    help="skip the odgi-viz 1D PNG rasters")
    _add_device(pg)
    pg.set_defaults(fn=cmd_pangenome)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
