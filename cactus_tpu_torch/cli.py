"""Command-line entry points (python -m cactus_tpu_torch <command>).

The PyTorch/CUDA port carries these verbs of the JAX package's CLI
(cactus_tpu/cli.py):
- `align`: progressive alignment of a seqfile into an alignment store,
  with --mask (k-mer repeat masking), --hal, --maf, --root and --target;
- `preprocess`: sanitize and repeat-mask genomes into FASTAs, with
  --tandem-mask, --lastz-mask and --satellite;
- `blast`: the standalone pairwise anchoring stage into a PAF, with
  --fastga and --minimap2;
- `prepare`: the step-by-step plan (preprocess, one `align --target` a
  ancestor, the export), printed or as --script / --wdl, whose commands
  run this package;
- `hal2maf`, `stats`, `hal2seqfile`, `chains`, `maf2bigmaf` and `hal`
  (every tool) on a store, MAF or HAL archive;
- `pangenome` (star, sv and refmap builders, with --stage), `gfa`
  (indexes, VCF and viz of an external GFA) and `patch`;
- `update` (add, add --branch, replace, remove a genome in a store, with
  --hal) and `conservation` (phyloFit + phyloP-style tracks, the
  Felsenstein pass on the device).

Every verb that takes `--device` (`align`, `preprocess`, `blast`,
`update`, `conservation`, `pangenome`, and `gfa` for its viz tool's
layout) runs its device work on the current CUDA device unless `--device
cpu` is given (the plain PyTorch versions and the native C++ kernels);
without a GPU the default raises.  The other verbs do host work only.
Launched under `torchrun`, every verb first joins the process group
(parallel/distributed.py).
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


def _log(msg: str) -> None:
    print(f"[cactus-tpu-torch] {msg}", file=sys.stderr, flush=True)


def load_genomes_from_seqfile(sf: SeqFile,
                              do_mask: bool = False,
                              only: set[str] | None = None,
                              pp=None, device=None
                              ) -> dict[str, dict[str, Sequence]]:
    """Load + sanitize (+ optionally repeat-mask) every genome.

    Mirrors the reference preprocessing chain: cutHeaders →
    checkUniqueHeaders → event prefixing → repeat masking
    (cactus_preprocessor.py; config XML <preprocessor> entries :20-43).
    `only` restricts loading to the named events (--root subtrees).  The
    masking's k-mer count runs on `device`.
    """
    from .preprocessor.headers import sanitize_genome
    from .preprocessor.masking import mask_genome
    if pp is None:
        pp = Config.default().preprocessor
    genomes = {}
    for event, path in sf.paths.items():
        if only is not None and event not in only:
            continue
        seqs = read_fasta(path)
        genome = sanitize_genome(event, seqs, cut=pp.cut_headers)
        if do_mask and pp.repeat_mask:
            genome = mask_genome(genome, k=pp.mask_kmer,
                                 min_length=pp.mask_min_contig,
                                 gc_skew_limit=pp.mask_gc_skew_limit,
                                 device=device)
        genomes[event] = genome
    return genomes


def cmd_preprocess(args) -> int:
    """Repeat-mask + sanitize genomes, write masked FASTAs
    (cactus-preprocess equivalent)."""
    import os
    from .io.fasta import write_fasta
    from .ops import resolve_device
    from .preprocessor.stats import assembly_stats
    device = resolve_device(args.device)
    sf = SeqFile.parse(args.seqfile)
    genomes = load_genomes_from_seqfile(sf, do_mask=not args.no_mask,
                                        device=device)
    os.makedirs(args.outdir, exist_ok=True)
    if args.tandem_mask:
        from .preprocessor.variants import tandem_mask_genome
        genomes = {ev: tandem_mask_genome(g) for ev, g in genomes.items()}
    if args.lastz_mask:
        from .preprocessor.variants import lastz_repeat_mask
        cfg = Config.default()
        genomes = {ev: lastz_repeat_mask(
                       g, cfg.blast, period=cfg.preprocessor.min_period,
                       log=_log, device=device)
                   for ev, g in genomes.items()}
    if args.satellite:
        from .preprocessor.variants import apply_bed, satellite_bed
        for ev in list(genomes):
            bed = satellite_bed(genomes[ev])
            if bed:
                with open(os.path.join(args.outdir,
                                       f"{ev}.satellites.bed"), "w") as fh:
                    for row in bed:
                        fh.write("\t".join(str(x) for x in row) + "\n")
                genomes[ev] = apply_bed(genomes[ev], bed, args.satellite)
    for event, genome in genomes.items():
        p = os.path.join(args.outdir, f"{event}.fa")
        write_fasta(p, genome)
        st = assembly_stats(genome)
        _log(f"{event}: {st['n_sequences']} seqs, {st['total_length']} bp, "
             f"N50 {st['n50']}, masked {st['masked_fraction']:.1%} → {p}")
    return 0


def cmd_align(args) -> int:
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
        sf, do_mask=args.mask, only=set(tree.leaf_names()),
        pp=config.preprocessor, device=args.device)
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


def cmd_blast(args) -> int:
    """Standalone pairwise anchoring → PAF (cactus-blast equivalent)."""
    import dataclasses
    from .io.paf import write_paf
    from .ops import resolve_device
    from .phases import blast as blast_phase
    device = resolve_device(args.device)
    sf = SeqFile.parse(args.seqfile)
    genomes = load_genomes_from_seqfile(sf)
    events = args.events.split(",") if args.events else list(genomes)
    cfg = Config.default().blast
    if args.fastga:
        cfg = dataclasses.replace(cfg, aligner="fastga")
    if args.minimap2:
        cfg = dataclasses.replace(cfg, aligner="minimap2")
    records = []
    for i, a in enumerate(events):
        for b in events[i + 1:]:
            for qn, qs in genomes[a].items():
                for tn, ts in genomes[b].items():
                    records.extend(blast_phase.align_contig_pair(
                        qs, ts, qn, tn, cfg, preset=args.preset,
                        device=device))
    records = blast_phase.finalize(records, cfg)
    with open(args.out, "w") as fh:
        write_paf(fh, records)
    _log(f"wrote {len(records)} PAF records to {args.out}")
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


def cmd_prepare(args) -> int:
    """Step-decomposed command plan (cactus-prepare analog: every stage
    independently runnable/restartable); optional shell script / WDL
    workflow output.  Its commands run this package."""
    import os
    from .prepare import make_plan, write_script, write_wdl
    sf = SeqFile.parse(args.seqfile)
    tree = sf.tree if sf.tree is not None else sf.star_tree()
    # size each stage with the reference's consolidated memory model
    # (cactus_workflow.py:34-97) from the on-disk FASTA sizes
    event_bytes = {}
    for ev, path in sf.paths.items():
        try:
            event_bytes[ev] = os.path.getsize(path)
        except OSError:
            pass
    stages = make_plan(tree, args.seqfile, args.outdir,
                       prog="python -m cactus_tpu_torch",
                       event_bytes=event_bytes)
    if args.wdl:
        with open(args.wdl, "w") as fh:
            write_wdl(stages, fh)
        _log(f"wrote WDL workflow {args.wdl}")
    if args.script:
        with open(args.script, "w") as fh:
            write_script(stages, fh)
        _log(f"wrote script {args.script}")
    if not args.wdl and not args.script:
        print(f"## cactus-tpu-torch plan for {args.seqfile} -> "
              f"{args.outdir}")
        write_script(stages, sys.stdout)
    return 0


def cmd_update(args) -> int:
    """add / add --branch / replace / remove a genome in a store; the
    re-run ancestor steps run on --device."""
    from . import update as update_mod
    store = AlignmentStore(args.store)
    result = None
    if args.action == "add":
        seqs = read_fasta(args.fasta)
        from .preprocessor.headers import sanitize_genome
        genome = sanitize_genome(args.event, seqs)
        if getattr(args, "branch", None):
            # halAddToBranch analog: new ancestor splits the branch
            # above --branch, the new leaf attaches to it
            result = update_mod.add_genome_to_branch(
                store, args.event, genome, args.branch,
                branch_length=args.branch_length,
                min_chain_override=args.min_chain, log=_log,
                device=args.device)
        else:
            result = update_mod.add_genome(
                store, args.event, genome, args.parent,
                branch_length=args.branch_length,
                min_chain_override=args.min_chain, log=_log,
                device=args.device)
    elif args.action == "replace":
        seqs = read_fasta(args.fasta)
        from .preprocessor.headers import sanitize_genome
        genome = sanitize_genome(args.event, seqs)
        result = update_mod.replace_genome(
            store, args.event, genome,
            min_chain_override=args.min_chain, log=_log, device=args.device)
    else:
        result = update_mod.remove_genome(
            store, args.event, min_chain_override=args.min_chain,
            log=_log, device=args.device)
    if getattr(args, "hal", None) and result is not None:
        update_mod.refresh_archive(args.hal, result, log=_log)
    return 0


def cmd_maf2bigmaf(args) -> int:
    """MAF → bigMaf bed + autoSql (cactus-maf2bigmaf analog; the exact
    inputs bedToBigBed consumes)."""
    from .io.maf import read_maf
    from .maf_tools import write_bigmaf
    blocks = list(read_maf(args.maf))
    n = write_bigmaf(args.out, blocks, args.ref_genome)
    _log(f"wrote {n} bigMaf rows to {args.out} (+{args.out}.as schema)")
    return 0


def cmd_hal2seqfile(args) -> int:
    """Write a seqfile + per-genome FASTAs from an alignment store
    (cactus-hal2seqfile analog: the input plan for update workflows)."""
    import os
    from .io.fasta import write_fasta
    store = AlignmentStore(args.store)
    result = store.load_result()
    os.makedirs(args.outdir, exist_ok=True)
    lines = [result.tree.to_newick()]
    events = ([e.strip() for e in args.events.split(",")] if args.events
              else [n for n in result.genomes
                    if not args.leaves_only
                    or not result.tree.find(n).children])
    for ev in events:
        fa = os.path.join(args.outdir, f"{ev}.fa")
        write_fasta(fa, result.genomes[ev])
        lines.append(f"{ev} {fa}")
    out = args.out or os.path.join(args.outdir, "seqfile.txt")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    _log(f"wrote {out} ({len(events)} genomes)")
    return 0


def cmd_chains(args) -> int:
    """UCSC liftover chains between two genomes (hal2chains analog)."""
    from .chains_export import write_chains
    store = AlignmentStore(args.store)
    result = store.load_result()
    n = write_chains(args.out, result, args.ref, args.query)
    _log(f"wrote {n} chains to {args.out}")
    return 0


def cmd_conservation(args) -> int:
    """phyloFit + phyloP-style conservation wiggle from the alignment; the
    Felsenstein pass runs on --device."""
    import json
    from .phases import hal as hal_phase
    from . import phast
    from .ops import resolve_device
    device = resolve_device(args.device)
    store = AlignmentStore(args.store)
    result = store.load_result()
    blocks = hal_phase.hal2maf(result, args.ref_genome,
                               include_ancestor=False)
    tree = result.tree
    sites = None
    if getattr(args, "annotation", None):
        # cactus-phast --mode phyloFit: neutral model from 4d sites of
        # a gene annotation (GFF seqids = MAF src names)
        ref = args.ref_genome or tree.name
        ref_seqs = result.genomes[ref]
        tx = phast.gff_cds_transcripts(args.annotation)
        sites = phast.four_d_sites(ref_seqs, tx)
        _log(f"4d sites: {sum(len(v) for v in sites.values())} positions "
             f"from {len(tx)} transcripts")
    scale = phast.phylo_fit(blocks, tree, sites=sites, device=device)
    method = getattr(args, "method", "LRT") or "LRT"
    mode = getattr(args, "mode", "CONACC") or "CONACC"
    subtrees = getattr(args, "subtree", None) or [None]

    def emit(path, scores, meta):
        phast.write_wig(path, scores, meta)
        if getattr(args, "bigwig", False):
            from .io.bigwig import write_bigwig
            per: dict[str, list] = {}
            for s, (seq, pos) in zip(scores, meta):
                if seq is None or pos < 0:
                    continue
                per.setdefault(seq, []).append((pos, float(s)))
            data = {}
            sizes = {}
            ref = args.ref_genome or tree.name
            for seq, pts in per.items():
                pts.sort()
                import numpy as _np
                data[seq] = (_np.array([p for p, _v in pts], _np.uint32),
                             _np.array([v for _p, v in pts], _np.float32))
                seqs = result.genomes.get(ref, {})
                sizes[seq] = (len(seqs[seq].codes) if seq in seqs
                              else int(data[seq][0][-1]) + 1)
            write_bigwig(path + ".bw", data, sizes)
            _log(f"wrote {path}.bw")

    for name in subtrees:
        # cactus_phast --subtree: one track per named node; naming the
        # root yields the standard whole-tree track (no .s tag)
        sub = None if (name is None or name == tree.name) else name
        scores, meta = phast.phylo_p(blocks, tree, neutral_scale=scale,
                                     method=method, mode=mode,
                                     subtree=sub, device=device)
        path = args.out if sub is None else f"{args.out}.{sub}.wig"
        emit(path, scores, meta)
        _log(f"track {'root' if sub is None else sub}: wrote {path}")
    with open(args.out + ".mod.json", "w") as fh:
        json.dump({"model": "JC69", "rate_scale": scale,
                   "method": method, "mode": mode}, fh)
    _log(f"neutral rate scale {scale:.3f}; wrote {args.out}")
    return 0


def cmd_stats(args) -> int:
    from .phases import hal as hal_phase
    store = AlignmentStore(args.store)
    result = store.load_result()
    for row in hal_phase.hal_stats(result):
        print("{genome}\t{n_sequences}\t{length}\t{n_top_segments}\t"
              "{n_bottom_segments}".format(**row))
    return 0


def cmd_hal(args) -> int:
    """HAL-archive tools: stats / fasta / maf / validate / removeDupes /
    metadata / append / liftover / mutations / snps / export-hdf5 /
    import-hdf5 (the halStats / hal2fasta / hal2maf / halValidate /
    halRemoveDupes CLI surface of the reference hal submodule)."""
    from .hal_archive import HalArchive
    if args.tool == "import-hdf5":
        # `archive` is the DESTINATION .hal (created, not opened);
        # --hdf5 names the source container
        from .io.hal_hdf5 import import_hdf5
        if not args.hdf5:
            raise SystemExit("hal import-hdf5 needs --hdf5 <source.h5>")
        import_hdf5(args.hdf5, args.archive)
        _log(f"imported {args.hdf5} -> {args.archive}")
        return 0
    arc = HalArchive.open(args.archive)
    if args.tool == "stats":
        for row in arc.stats():
            print("{genome}\t{n_sequences}\t{length}\t{n_top_segments}\t"
                  "{n_bottom_segments}".format(**row))
    elif args.tool == "fasta":
        from .io.fasta import write_fasta
        write_fasta(args.out or sys.stdout, arc.dna(args.genome))
    elif args.tool == "maf":
        from .io.maf import write_maf
        blocks = arc.hal2maf(ref_genome=args.genome, ref_seq=args.ref_seq,
                             ref_start=args.start, ref_end=args.end)
        write_maf(args.out, blocks)
        _log(f"wrote {args.out} ({len(blocks)} blocks)")
    elif args.tool == "validate":
        errs = arc.validate()
        for e in errs:
            print(e)
        return 1 if errs else 0
    elif args.tool == "removeDupes":
        n = arc.remove_dupes(args.genome)
        _log(f"demoted {n} duplicate top segments in {args.genome}")
    elif args.tool == "export-hdf5":
        # the reference's storage model is HDF5 (hal submodule); write
        # a HAL-structured HDF5 container (see io/hal_hdf5.py caveat)
        from .io.hal_hdf5 import export_hdf5
        export_hdf5(arc, args.out or args.archive + ".h5")
        _log(f"wrote {args.out or args.archive + '.h5'}")
    elif args.tool == "metadata":
        if args.set:
            k, _, v = args.set.partition("=")
            arc.set_metadata(k, v)
            _log(f"set {k}")
        else:
            print(json.dumps(arc.get_metadata(), indent=1))
    elif args.tool == "append":
        # halAppendCactusSubtree / cactus-halAppendSubtrees analog:
        # import one computed ancestor step from a store into the
        # growing archive (export_hal BFS order is the caller's job)
        store = AlignmentStore(args.store)
        result = store.load_result()
        node = result.tree.find(args.genome)
        if node is None or args.genome not in result.steps:
            raise SystemExit(f"no computed step for {args.genome!r}")
        children = {c.name: result.genomes[c.name] for c in node.children
                    if c.name in result.genomes}
        arc.append_subtree(result.steps[args.genome],
                           result.genomes[args.genome], children)
        _log(f"appended subtree {args.genome} "
             f"({len(children)} children) to {args.archive}")
    elif args.tool == "liftover":
        # halLiftover: --genome src, --target dst, --bed in, --out bed
        ivals = []
        with open(args.bed) as fh:
            for line in fh:
                if line.strip() and not line.startswith(("#", "track")):
                    f = line.split()
                    ivals.append((f[0], int(f[1]), int(f[2])))
        runs = arc.liftover(args.genome, ivals, args.target)
        out = open(args.out, "w") if args.out else sys.stdout
        for sname, s0, dname, d0, L, strand in runs:
            out.write(f"{dname}\t{d0}\t{d0 + L}\t{sname}:{s0}-{s0 + L}\t0\t"
                      f"{'+' if strand == 1 else '-'}\n")
        if args.out:
            out.close()
            _log(f"wrote {args.out} ({len(runs)} runs)")
    elif args.tool == "mutations":
        print("#genome\tparent\talignedBp\tsubs\tinsEvents\tinsBp\t"
              "delBp\tdupParentBp")
        for row in arc.summarize_mutations():
            print("{genome}\t{parent}\t{aligned_bp}\t{subs}\t"
                  "{ins_events}\t{ins_bp}\t{del_bp}\t"
                  "{dup_parent_bp}".format(**row))
    elif args.tool == "snps":
        snp = arc.snps(args.genome, args.target)
        out = open(args.out, "w") if args.out else sys.stdout
        out.write("#srcSeq\tsrcPos\tsrcBase\tdstSeq\tdstPos\tdstBase\n")
        for row in snp:
            out.write("\t".join(str(x) for x in row) + "\n")
        if args.out:
            out.close()
            _log(f"wrote {args.out} ({len(snp)} SNPs)")
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
                    help="repeat-mask inputs before aligning")
    pa.add_argument("--config", default=None,
                    help="cactus-format config XML with parameter overrides")
    pa.add_argument("--tree-workers", type=int, default=1,
                    help="concurrent independent ancestor steps")
    pa.add_argument("--target", default=None,
                    help="compute only these ancestor step(s) "
                         "(comma-separated; deps resume from the store)")
    _add_device(pa)
    pa.set_defaults(fn=cmd_align)

    pp = sub.add_parser("preprocess",
                        help="sanitize + repeat-mask genomes → FASTAs")
    pp.add_argument("seqfile")
    pp.add_argument("outdir")
    pp.add_argument("--no-mask", action="store_true")
    pp.add_argument("--tandem-mask", action="store_true",
                    help="FasTAN-style tandem-repeat masking")
    pp.add_argument("--lastz-mask", action="store_true",
                    help="sampled self-alignment repeat masking")
    pp.add_argument("--satellite", choices=["softmask", "hardmask",
                                            "clip"],
                    help="annotate satellite arrays (dna-brnn analog) "
                         "and apply the given action; writes "
                         "<event>.satellites.bed")
    _add_device(pp, "the k-mer count and the self-alignments")
    pp.set_defaults(fn=cmd_preprocess)

    pb = sub.add_parser("blast", help="pairwise anchoring stage → PAF")
    pb.add_argument("seqfile")
    pb.add_argument("out")
    pb.add_argument("--events", default=None,
                    help="comma-separated genome names (default: all pairs)")
    pb.add_argument("--preset", default="default")
    pb.add_argument("--fastga", action="store_true",
                    help="adaptamer-style unique-seed aligner mode")
    pb.add_argument("--minimap2", action="store_true",
                    help="minimizer-sampled seed aligner mode "
                         "(reference: minimap2 -c -x asm20)")
    _add_device(pb, "the seed join and the gap fill")
    pb.set_defaults(fn=cmd_blast)

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

    pr = sub.add_parser("prepare",
                        help="print the step-decomposed command plan")
    pr.add_argument("seqfile")
    pr.add_argument("outdir")
    pr.add_argument("--wdl", default=None,
                    help="write a WDL 1.0 workflow (Cromwell/Terra)")
    pr.add_argument("--script", default=None,
                    help="write an ordered shell script")
    pr.set_defaults(fn=cmd_prepare)

    pu = sub.add_parser("update",
                        help="add/replace/remove a genome in a store")
    pu.add_argument("action", choices=["add", "replace", "remove"])
    pu.add_argument("store")
    pu.add_argument("event")
    pu.add_argument("--fasta", default=None)
    pu.add_argument("--parent", default=None,
                    help="add-to-node: attach the new leaf under this event")
    pu.add_argument("--branch", default=None,
                    help="add-to-branch: split the branch above this event "
                         "with a new ancestor (halAddToBranch)")
    pu.add_argument("--branch-length", type=float, default=0.1)
    pu.add_argument("--min-chain", type=int, default=None)
    pu.add_argument("--hal", default=None,
                    help="also refresh this HAL archive after the update")
    _add_device(pu, "the re-run ancestor steps")
    pu.set_defaults(fn=cmd_update)

    pc = sub.add_parser("chains",
                        help="UCSC chains between two genomes")
    pc.add_argument("store")
    pc.add_argument("ref")
    pc.add_argument("query")
    pc.add_argument("out")
    pc.set_defaults(fn=cmd_chains)

    pv = sub.add_parser("conservation",
                        help="phyloP-style conservation wiggle")
    pv.add_argument("store")
    pv.add_argument("out")
    pv.add_argument("--ref-genome", default=None)
    pv.add_argument("--annotation", default=None,
                    help="GFF with CDS rows: fit the neutral model on "
                         "4d sites only (cactus-phast phyloFit mode)")
    pv.add_argument("--method", default="LRT",
                    choices=["ratio", "LRT", "SCORE"],
                    help="phyloP --method (cactus_phast.py:158)")
    pv.add_argument("--mode", default="CONACC",
                    choices=["CONACC", "CON", "ACC", "NNEUT"],
                    help="phyloP --mode sign convention")
    pv.add_argument("--subtree", nargs="+", default=None, metavar="NAME",
                    help="one lineage-specific track per named internal "
                         "node (phyloP --subtree; the root name gives "
                         "the standard whole-tree track)")
    pv.add_argument("--bigwig", action="store_true",
                    help="also write .bw (native bbi writer, no "
                         "wigToBigWig needed)")
    _add_device(pv, "the Felsenstein pass")
    pv.set_defaults(fn=cmd_conservation)

    ph = sub.add_parser("hal", help="HAL archive tools (halStats/"
                        "hal2fasta/hal2maf/halValidate/halRemoveDupes)")
    ph.add_argument("tool", choices=["stats", "fasta", "maf", "validate",
                                     "removeDupes", "metadata", "liftover",
                                     "snps", "mutations", "append",
                                     "export-hdf5", "import-hdf5"])
    ph.add_argument("--set", default=None,
                    help="metadata key=value to store (halSetMetadata)")
    ph.add_argument("archive")
    ph.add_argument("--store", default=None,
                    help="alignment store to append a subtree from "
                         "(hal append)")
    ph.add_argument("--genome", default=None)
    ph.add_argument("--target", default=None,
                    help="destination genome for liftover/snps")
    ph.add_argument("--bed", default=None,
                    help="input BED of source intervals (liftover)")
    ph.add_argument("--out", default=None)
    ph.add_argument("--ref-seq", default=None)
    ph.add_argument("--hdf5", default=None,
                    help="source HDF5 container (hal import-hdf5)")
    ph.add_argument("--start", type=int, default=0)
    ph.add_argument("--end", type=int, default=None)
    ph.set_defaults(fn=cmd_hal)

    ps = sub.add_parser("stats", help="halStats-style genome table")
    ps.add_argument("store")
    ps.set_defaults(fn=cmd_stats)

    pbm = sub.add_parser("maf2bigmaf",
                         help="MAF → bigMaf bed + autoSql "
                              "(cactus-maf2bigmaf)")
    pbm.add_argument("maf")
    pbm.add_argument("out")
    pbm.add_argument("--ref-genome", required=True)
    pbm.set_defaults(fn=cmd_maf2bigmaf)

    psf = sub.add_parser("hal2seqfile",
                         help="store → seqfile + per-genome FASTAs "
                              "(cactus-hal2seqfile)")
    psf.add_argument("store")
    psf.add_argument("outdir")
    psf.add_argument("--out", default=None, help="seqfile path")
    psf.add_argument("--events", default=None,
                     help="comma-separated genome subset")
    psf.add_argument("--leaves-only", action="store_true")
    psf.set_defaults(fn=cmd_hal2seqfile)

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
    # join the process group when launched by torchrun (no-op unless
    # MASTER_ADDR is set); host verbs take the CPU's gloo backend
    from .parallel import distributed
    distributed.initialize(device=getattr(args, "device", "cpu"), log=_log)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
