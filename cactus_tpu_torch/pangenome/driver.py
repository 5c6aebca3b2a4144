"""cactus-pangenome equivalent: star alignment → graph → normalize →
tiers → GFA/VCF.

Reference pipeline (refmap/cactus_pangenome.py:3-13): minigraph SV graph
→ graphmap → split → per-chromosome star cactus-align → graphmap-join
(GFAffix normalize, clip tiers, GFA/GBZ/VCF/indexes).  Native version:
chromosome splitting by reference-coverage binning (split.py), one star
alignment per chromosome (the cactus-align --pangenome mode), shared-
affix normalization (normalize.py), full + clip graph tiers, and the
nested-snarl VCF (vcf.py).

Every entry point takes `device`: the torch device the alignment's
kernels, the vcfwave tier's banded DP and the 2D layout run on (None =
the current CUDA device; ops.resolve_device raises without one).
"""

from __future__ import annotations

import json
import os

from ..config import Config
from ..io.fasta import Sequence
from ..progressive import ProgressiveAligner
from ..utils.trees import Tree
from . import graph as graph_mod
from . import vcf as vcf_mod
from .normalize import collapse_shared_affixes
from .split import AMBIGUOUS, split_by_chromosome


def run_pangenome(genomes: dict[str, dict[str, Sequence]],
                  ref_event: str, outdir: str,
                  config: Config | None = None,
                  min_chain_override: int | None = 64,
                  normalize: bool = True,
                  clip: int | None = 10_000,
                  filter_depth: int | None = 2,
                  viz: bool = True,
                  log=lambda m: None, device=None) -> dict:
    """Align all haplotypes star-wise against each other and emit the
    graph artifacts.  Returns the stats dict."""
    os.makedirs(outdir, exist_ok=True)
    root = Tree("_pan_root_")
    for ev in genomes:
        root.add_child(Tree(ev, 0.05))
    aligner = ProgressiveAligner(root, genomes, config=config,
                                 min_chain_override=min_chain_override,
                                 log=log, device=device)
    result = aligner.run()
    step = result.steps["_pan_root_"]
    seqs: dict[str, Sequence] = {}
    for ev in genomes:
        seqs.update(genomes[ev])
    pg = graph_mod.build_graph(step.caf, seqs, chop=True)
    pg.validate(seqs)
    return _emit_graph_artifacts(pg, seqs, ref_event, outdir,
                                 normalize=normalize, clip=clip,
                                 filter_depth=filter_depth, viz=viz,
                                 log=log, device=device)


def _emit_graph_artifacts(pg, seqs: dict[str, Sequence], ref_event: str,
                          outdir: str, normalize: bool = True,
                          clip: int | None = 10_000,
                          filter_depth: int | None = 2,
                          viz: bool = True,
                          log=lambda m: None, device=None) -> dict:
    if normalize:
        rounds = collapse_shared_affixes(pg)
        pg.validate(seqs)
        log(f"normalize: shared-affix collapse converged in {rounds} "
            f"rounds ({pg.n_nodes} nodes)")

    ref_paths = [n for n in pg.walks if n.split(".", 1)[0] == ref_event]
    if not ref_paths:
        raise ValueError(f"reference event {ref_event} has no paths")

    gfa = os.path.join(outdir, "pangenome.gfa")
    graph_mod.write_gfa(gfa, pg, ref_name=ref_paths[0])
    vcf = os.path.join(outdir, "pangenome.vcf")
    vcf_mod.write_vcf(vcf, pg, ref_paths[0])
    # the processed tier: collapse-bubble merge_duplicates + vcfbub
    # (graphmap-join's `vcfbub --max-level 0 --max-ref-length 100000`)
    vcf_mod.write_vcf(os.path.join(outdir, "pangenome.bub.vcf"), pg,
                      ref_paths[0], merge_dups=True,
                      bub_max_ref_length=100_000, max_level=0)
    # the wave tier: vcfwave realignment decomposition of the bub VCF
    # (graphmap-join's optional `vcfwave` pass, config XML :493)
    vcf_mod.write_vcf(os.path.join(outdir, "pangenome.wave.vcf"), pg,
                      ref_paths[0], merge_dups=True,
                      bub_max_ref_length=100_000, max_level=0, wave=True,
                      device=device)

    # index factory (graphmap-join emits GBZ/snarls/xg/odgi stats,
    # plus the --giraffe pair: minimizer .min + distance .dist)
    from .giraffe import DistanceIndex, MinimizerIndex
    from .indexes import degree_stats, save_gbz, snarls
    save_gbz(os.path.join(outdir, "pangenome.gbz"), pg)
    MinimizerIndex.build(pg).save(os.path.join(outdir, "pangenome.min"))
    DistanceIndex.build(pg, ref_paths[0]).save(
        os.path.join(outdir, "pangenome.dist"))
    sn = snarls(pg, ref_paths[0])
    with open(os.path.join(outdir, "snarls.json"), "w") as fh:
        json.dump([dict(start=s.start, end=s.end, level=s.level,
                        span=s.span, n_nodes=s.n_nodes)
                   for s in sn], fh)

    stats = graph_mod.graph_stats(pg)
    stats["odgi"] = degree_stats(pg)
    stats["n_snarls"] = len(sn)
    tiers: dict = {}
    if clip is not None:
        clipped, bed = graph_mod.clip_graph(pg, max_unaligned=clip)
        graph_mod.write_gfa(os.path.join(outdir, "pangenome.clip.gfa"),
                            clipped)
        with open(os.path.join(outdir, "clipped.bed"), "w") as fh:
            for name, ivs in bed.items():
                for a, b in ivs:
                    fh.write(f"{name}\t{a}\t{b}\n")
        stats["clip"] = graph_mod.graph_stats(clipped)
        stats["clipped_bp"] = int(sum(b - a for ivs in bed.values()
                                      for a, b in ivs))
        tiers["clip"] = (clipped, bed)
        if filter_depth is not None and filter_depth > 0:
            # graphmap-join `--filter 2` tier: allele-frequency filter
            # of the clip graph (cactus_graphmap_join.py:157)
            filt, fbed = graph_mod.filter_graph(
                clipped, min_depth=filter_depth, ref_sample=ref_event)
            graph_mod.write_gfa(
                os.path.join(outdir, "pangenome.filter.gfa"), filt)
            with open(os.path.join(outdir, "filtered.bed"), "w") as fh:
                for name, ivs in fbed.items():
                    for a, b in ivs:
                        fh.write(f"{name}\t{a}\t{b}\n")
            stats["filter"] = graph_mod.graph_stats(filt)
            stats["filtered_bp"] = int(sum(b - a for ivs in fbed.values()
                                           for a, b in ivs))
            tiers["filter"] = (filt, fbed)

    if tiers:
        # standalone exclusions report with the closure invariant
        from .exclusions import exclusions_report, write_exclusions
        rep = exclusions_report(seqs, tiers)
        write_exclusions(os.path.join(outdir, "exclusions.tsv"), rep)

    if viz:
        # graphmap-join --viz: odgi 1D raster per graph tier
        from .viz import viz as render_viz
        render_viz(pg, os.path.join(outdir, "pangenome.viz.png"),
                   ref_name=ref_paths[0])
        if "clip" in tiers:
            render_viz(tiers["clip"][0],
                       os.path.join(outdir, "pangenome.clip.viz.png"))
        # graphmap-join --odgi pair: odgi layout (.lay) + odgi draw
        from .layout2d import layout_2d, write_lay, draw
        X = layout_2d(pg, ref_name=ref_paths[0], device=device)
        write_lay(os.path.join(outdir, "pangenome.lay.tsv"), pg, X)
        draw(pg, X, os.path.join(outdir, "pangenome.draw.png"))

    stats["reference"] = ref_paths[0]
    with open(os.path.join(outdir, "graph_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=1)
    log(f"graph: {stats['n_nodes']} nodes, {stats['n_edges']} edges, "
        f"{stats['n_paths']} paths → {gfa}")
    return stats


def sv_stage_minigraph(genomes: dict[str, dict[str, Sequence]],
                       ref_event: str, outdir: str,
                       config: Config | None = None, min_sv: int = 50,
                       log=lambda m: None, device=None) -> None:
    """cactus-minigraph stage: mash-ordered iterative SV graph →
    `sv_graph.rgfa` + `minigraph_order.json` (the artifact the
    reference exports between Toil workflows, cactus_pangenome.py:10-12)."""
    from .minigraph import build_sv_graph
    os.makedirs(outdir, exist_ok=True)
    cfg = config or Config.default()
    svg, order = build_sv_graph(genomes, ref_event, config=cfg,
                                min_sv=min_sv, log=log, device=device)
    svg.write_rgfa(os.path.join(outdir, "sv_graph.rgfa"))
    with open(os.path.join(outdir, "minigraph_order.json"), "w") as fh:
        json.dump(dict(order=order, n_nodes=svg.n_nodes,
                       n_edges=len(svg.edges)), fh)


def sv_stage_graphmap(genomes: dict[str, dict[str, Sequence]],
                      outdir: str, config: Config | None = None,
                      log=lambda m: None, device=None) -> None:
    """cactus-graphmap stage: map every assembly onto the SV graph
    (read from `sv_graph.rgfa`) → `graphmap.paf`."""
    from ..io.paf import write_paf
    from .minigraph import graphmap, read_rgfa
    cfg = config or Config.default()
    svg = read_rgfa(os.path.join(outdir, "sv_graph.rgfa"))
    records = graphmap(svg, genomes, config=cfg, log=log, device=device)
    with open(os.path.join(outdir, "graphmap.paf"), "w") as fh:
        write_paf(fh, records)


def sv_stage_align(genomes: dict[str, dict[str, Sequence]],
                   outdir: str, config: Config | None = None,
                   min_chain_override: int | None = 64,
                   log=lambda m: None) -> None:
    """cactus-align stage: CAF over `graphmap.paf` + the graph's node
    sequences → base-level graph → `pangenome.raw.gfa` (pre-join)."""
    from ..io.paf import read_paf
    from ..phases.caf import run_caf
    from .minigraph import read_rgfa
    from .normalize import compact
    cfg = config or Config.default()
    svg = read_rgfa(os.path.join(outdir, "sv_graph.rgfa"))
    records = read_paf(os.path.join(outdir, "graphmap.paf"))
    seqs: dict[str, Sequence] = dict(svg.node_fasta())
    node_names = set(seqs)
    for ev in genomes:
        seqs.update(genomes[ev])
    caf = run_caf(records, {n: len(s) for n, s in seqs.items()},
                  cfg.caf, ingroup_events=set(genomes) | {"_MINIGRAPH_"},
                  min_chain_override=min_chain_override, log=log)
    pg = graph_mod.build_graph(caf, seqs, chop=True)
    pg.validate(seqs)
    # drop the graph pseudo-event's walks (join drops _MINIGRAPH_)
    for n in node_names:
        pg.walks.pop(n, None)
    compact(pg)
    hap_seqs = {n: s for n, s in seqs.items() if n not in node_names}
    pg.validate(hap_seqs)
    graph_mod.write_gfa(os.path.join(outdir, "pangenome.raw.gfa"), pg)


def sv_stage_join(genomes: dict[str, dict[str, Sequence]],
                  ref_event: str, outdir: str,
                  normalize: bool = True, clip: int | None = 10_000,
                  filter_depth: int | None = 2, viz: bool = True,
                  log=lambda m: None, device=None) -> dict:
    """cactus-graphmap-join stage: normalize/clip/filter tiers, VCFs,
    and the index factory over `pangenome.raw.gfa`."""
    pg = graph_mod.read_gfa(os.path.join(outdir, "pangenome.raw.gfa"))
    hap_seqs: dict[str, Sequence] = {}
    for ev in genomes:
        hap_seqs.update(genomes[ev])
    pg.validate(hap_seqs)
    stats = _emit_graph_artifacts(pg, hap_seqs, ref_event, outdir,
                                  normalize=normalize, clip=clip,
                                  filter_depth=filter_depth, viz=viz,
                                  log=log, device=device)
    with open(os.path.join(outdir, "graph_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


SV_STAGES = ("minigraph", "graphmap", "align", "join")


def run_pangenome_sv(genomes: dict[str, dict[str, Sequence]],
                     ref_event: str, outdir: str,
                     config: Config | None = None,
                     min_sv: int = 50,
                     min_chain_override: int | None = 64,
                     normalize: bool = True, clip: int | None = 10_000,
                     filter_depth: int | None = 2, viz: bool = True,
                     stages: tuple = SV_STAGES,
                     log=lambda m: None, device=None) -> dict:
    """The full minigraph-cactus tier: iterative SV graph → graphmap →
    base-level alignment against the graph → normalize/clip/VCF.

    Mirrors cactus-pangenome's stage chain (refmap/cactus_pangenome.py:
    3-13): instead of the all-pairs star alignment, every haplotype is
    aligned only to the SV graph's node sequences (the `_MINIGRAPH_`
    event), and base-level homology between haplotypes arises
    transitively through the shared node columns in CAF — the reference
    architecture, and O(haplotypes), not O(haplotypes²).

    Every stage hands its artifact to the next THROUGH DISK (rgfa, paf,
    raw gfa), so a staged run (one stage per invocation, the reference's
    cactus-minigraph/-graphmap/-align/-graphmap-join decomposition) is
    byte-identical to this monolithic run.
    """
    stats: dict = {}
    if "minigraph" in stages:
        sv_stage_minigraph(genomes, ref_event, outdir, config=config,
                           min_sv=min_sv, log=log, device=device)
    if "graphmap" in stages:
        sv_stage_graphmap(genomes, outdir, config=config, log=log,
                          device=device)
    if "align" in stages:
        sv_stage_align(genomes, outdir, config=config,
                       min_chain_override=min_chain_override, log=log)
    if "join" in stages:
        stats = sv_stage_join(genomes, ref_event, outdir,
                              normalize=normalize, clip=clip,
                              filter_depth=filter_depth, viz=viz, log=log,
                              device=device)
        with open(os.path.join(outdir, "minigraph_order.json")) as fh:
            stats["sv_graph"] = json.load(fh)
        with open(os.path.join(outdir, "graph_stats.json"), "w") as fh:
            json.dump(stats, fh, indent=1)
    return stats


def run_pangenome_refmap(genomes: dict[str, dict[str, Sequence]],
                         ref_event: str, outdir: str,
                         config: Config | None = None,
                         min_chain_override: int | None = 64,
                         normalize: bool = True,
                         clip: int | None = 10_000,
                         filter_depth: int | None = 2,
                         viz: bool = True,
                         log=lambda m: None, device=None) -> dict:
    """cactus-refmap alternative (refmap/cactus_refmap.py): every
    assembly aligns ONLY against the reference genome (minimap2-to-
    reference in the reference pipeline; this package's own anchoring
    stack here), and the base graph comes from those star-to-reference
    records — O(haplotypes) like the SV tier, but anchored on a linear
    reference instead of an SV graph."""
    from ..phases.blast import align_genomes
    from ..phases.caf import run_caf

    os.makedirs(outdir, exist_ok=True)
    cfg = config or Config.default()
    seqs: dict[str, Sequence] = {}
    for ev in genomes:
        seqs.update(genomes[ev])
    def _unprefixed(ev):
        # align_genomes re-applies the event prefix to contig keys
        return {n.split(".", 1)[1] if n.startswith(ev + ".") else n: s
                for n, s in genomes[ev].items()}

    ref_genome = _unprefixed(ref_event)
    records = []
    for ev in genomes:
        if ev == ref_event:
            continue
        n0 = len(records)
        records.extend(align_genomes(_unprefixed(ev), ref_genome,
                                     ev, ref_event, cfg.blast,
                                     device=device))
        log(f"refmap: {ev}: {len(records) - n0} records vs {ref_event}")
    caf = run_caf(records, {n: len(s) for n, s in seqs.items()},
                  cfg.caf, ingroup_events=set(genomes),
                  min_chain_override=min_chain_override, log=log)
    pg = graph_mod.build_graph(caf, seqs, chop=True)
    pg.validate(seqs)
    return _emit_graph_artifacts(pg, seqs, ref_event, outdir,
                                 normalize=normalize, clip=clip,
                                 filter_depth=filter_depth, viz=viz,
                                 log=log, device=device)


def run_pangenome_split(genomes: dict[str, dict[str, Sequence]],
                        ref_event: str, outdir: str,
                        config: Config | None = None,
                        min_chain_override: int | None = 64,
                        log=lambda m: None, device=None) -> dict:
    """Multi-chromosome pangenome: split contigs by reference
    chromosome, build one graph per chromosome (the cactus-align
    --batch per-chromosome fan-out), and write per-chromosome artifact
    directories plus the contig assignment table."""
    os.makedirs(outdir, exist_ok=True)
    per_chrom, assignment = split_by_chromosome(genomes, ref_event,
                                                config=config, log=log,
                                                device=device)
    with open(os.path.join(outdir, "contig_assignment.tsv"), "w") as fh:
        for contig, chrom in sorted(assignment.items()):
            fh.write(f"{contig}\t{chrom}\n")
    all_stats: dict = {"chromosomes": {}, "ambiguous_contigs": sorted(
        c for c, ch in assignment.items() if ch == AMBIGUOUS)}
    for chrom, sub in sorted(per_chrom.items()):
        if chrom == AMBIGUOUS:
            continue
        if sum(len(g) for g in sub.values()) < 2:
            log(f"{chrom}: only the reference contig, skipping")
            continue
        cdir = os.path.join(outdir, chrom.replace("/", "_"))
        log(f"chromosome {chrom}: {sum(len(g) for g in sub.values())} "
            "contigs")
        all_stats["chromosomes"][chrom] = run_pangenome(
            sub, ref_event, cdir, config=config,
            min_chain_override=min_chain_override, log=log, device=device)
    with open(os.path.join(outdir, "pangenome_stats.json"), "w") as fh:
        json.dump(all_stats, fh, indent=1)
    return all_stats
