"""Progressive alignment driver: bottom-up ancestor reconstruction.

Replaces the Toil workflow orchestration (reference:
src/cactus/progressive/cactus_progressive.py:86-193 progressive_schedule /
progressive_step): internal nodes of the guide tree are processed in
postorder; each ancestor step runs blast → CAF → BAR → reference on its
children (+ nearest outgroups), producing the ancestral genome consumed by
the parent's step.  Instead of HAL files between Toil jobs, steps exchange
in-memory genomes plus vectorized child→ancestor coordinate maps (the
top/bottom-segment structure of HAL, hal/impl/hal.c:14-77), which also
give transitive leaf↔leaf homology through lowest common ancestors.

Device work (banded DP, pair-HMM, large Felsenstein windows) runs on the
aligner's `device`: the current CUDA device unless the caller names
another (device="cpu" runs the plain PyTorch versions and native C++).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import Config, divergence_preset
from .io.fasta import Sequence
from .ops import resolve_device
from .phases import bar as bar_phase
from .phases import blast as blast_phase
from .phases import reference as ref_phase
from .phases.caf import CafResult, run_caf
from .utils.trees import Tree


@dataclass
class SeqMap:
    """Base-level map from one sequence into an ancestor genome.

    tgt_idx[i]: index into the ancestor's ordered sequence-name list
    (-1 = unaligned base); tgt_pos[i]: position there; strand[i]: +/-1.
    """
    tgt_idx: np.ndarray
    tgt_pos: np.ndarray
    strand: np.ndarray


# per-base map arrays above this many bytes back onto disk (anonymous
# unlinked temp files): at genome scale the retained child→ancestor
# maps are the largest RESIDENT structure (9 B/base · total bases per
# ancestor step), and file-backed pages are evictable under memory
# pressure while staying transparent ndarrays to every consumer —
# the streaming/spill design the reference gets from chunked files
# (local_alignment.py:370-408) applied to the map layer
MAPS_MEMMAP_BYTES = int(__import__("os").environ.get(
    "CACTUS_MAPS_MEMMAP_BYTES", str(1 << 30)))


def _map_array(n: int, fill, dtype) -> np.ndarray:
    if n * np.dtype(dtype).itemsize < MAPS_MEMMAP_BYTES:
        return np.full(n, fill, dtype)
    import tempfile
    f = tempfile.TemporaryFile(prefix="cactus_map_")
    f.truncate(n * np.dtype(dtype).itemsize)
    arr = np.memmap(f, dtype=dtype, mode="r+", shape=(n,))
    arr[:] = fill
    return arr


@dataclass
class AncestorStep:
    event: str
    caf: CafResult
    ref: ref_phase.ReferenceResult
    anc_seq_names: list[str]
    maps: dict[str, SeqMap]            # child/outgroup seq → ancestor coords
    ingroup_events: set[str]
    outgroup_events: set[str]
    timings: dict[str, float] = field(default_factory=dict)


@dataclass
class ProgressiveResult:
    tree: Tree
    steps: dict[str, AncestorStep]
    genomes: dict[str, dict[str, Sequence]]   # event → {seq name → Sequence}

    def step_of_child(self, event: str) -> AncestorStep | None:
        """The ancestor step in which `event` participates as a child."""
        node = self.tree.find(event)
        if node is None or node.parent is None:
            return None
        return self.steps.get(node.parent.name)


def seq_maps_from_step(caf: CafResult,
                       ref: ref_phase.ReferenceResult) -> dict[str, SeqMap]:
    """Vectorized child→ancestor coordinate maps from block structure.

    Fully array-parallel over segments (no per-segment Python loop): the
    global tgt arrays are filled by one base expansion pass, then each
    sequence's map is a view.  Expansion is batched so transient memory
    stays bounded at genome scale."""
    table = caf.table
    anc_index = {n: i for i, n in enumerate(ref.sequences)}
    total = int(table.total)
    g_idx = _map_array(total, -1, np.int32)
    # int32 positions: a single ancestor contig stays < 2^31 bases
    # (guarded below); halves the dominant per-base map footprint
    g_pos = _map_array(total, -1, np.int32)
    g_str = _map_array(total, 0, np.int8)
    assert all(len(s) < (1 << 31) for s in ref.sequences.values())

    blocks = caf.blocks
    lens = blocks.block_length()
    nb = blocks.n_blocks
    coord_ai = np.full(nb, -1, np.int32)
    coord_astart = np.zeros(nb, np.int64)
    coord_orient = np.ones(nb, np.int8)
    for b, (anc_seq, astart, orient) in ref.block_coord.items():
        coord_ai[b] = anc_index[anc_seq]
        coord_astart[b] = astart
        coord_orient[b] = orient

    sel = np.flatnonzero(caf.alive[blocks.seg_block]
                         & (coord_ai[blocks.seg_block] >= 0))
    BATCH = 4_000_000   # expanded bases per batch
    lo = 0
    seg_ln_all = blocks.seg_len[sel]
    cum = np.cumsum(seg_ln_all)
    while lo < len(sel):
        hi = int(np.searchsorted(cum, (cum[lo - 1] if lo else 0) + BATCH,
                                 side="left")) + 1
        s = sel[lo:hi]
        ln = blocks.seg_len[s]
        n = int(ln.sum())
        seg_of = np.repeat(np.arange(len(s)), ln)
        k = np.arange(n) - np.repeat(np.cumsum(ln) - ln, ln)
        b = blocks.seg_block[s][seg_of]
        strand = blocks.seg_strand[s][seg_of].astype(np.int64)
        L = lens[b]
        col = np.where(strand == 1, k, ln[seg_of] - 1 - k)
        # member base sits at block column col (segment length == block
        # length for lockstep blocks); ancestor position of column c is
        # astart+c (orient +1) else astart+L-1-c
        orient = coord_orient[b].astype(np.int64)
        apos = coord_astart[b] + np.where(orient == 1, col, L - 1 - col)
        gidx = (table.offsets[blocks.seg_seq[s]][seg_of]
                + blocks.seg_start[s][seg_of] + k)
        g_idx[gidx] = coord_ai[b]
        g_pos[gidx] = apos
        g_str[gidx] = (strand * orient).astype(np.int8)
        lo = hi

    maps = {}
    for name, si in table.index.items():
        o = int(table.offsets[si])
        e = o + int(table.lengths[si])
        maps[name] = SeqMap(g_idx[o:e], g_pos[o:e], g_str[o:e])
    return maps


def compose_maps(m1: SeqMap, names1: list[str],
                 maps2: dict[str, SeqMap]) -> SeqMap:
    """child→A composed with A→B gives child→B (missing data propagates).

    One pass over the aligned bases: the A-side maps are viewed through
    concatenated (offset-shifted) arrays so the composition is a single
    gather regardless of how many A sequences exist (the per-sequence
    flatnonzero scan was the 100 Mb-scale hot spot)."""
    n = len(m1.tgt_idx)
    out = SeqMap(_map_array(n, -1, np.int32), _map_array(n, -1, np.int32),
                 _map_array(n, 0, np.int8))
    # concatenated view of maps2 over names1 order
    lens = np.array([len(maps2[nm].tgt_idx) if nm in maps2 else 0
                     for nm in names1], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    total = int(offs[-1])
    if total == 0:
        return out
    cat_idx = _map_array(total, -1, np.int32)
    cat_pos = _map_array(total, -1, np.int32)
    cat_str = _map_array(total, 0, np.int8)
    for k, nm in enumerate(names1):
        m2 = maps2.get(nm)
        if m2 is None:
            continue
        o = int(offs[k])
        cat_idx[o:o + len(m2.tgt_idx)] = m2.tgt_idx
        cat_pos[o:o + len(m2.tgt_idx)] = m2.tgt_pos
        cat_str[o:o + len(m2.tgt_idx)] = m2.strand
    # windowed composition: the int64 index temporaries are the cost
    # (up to ~32 B per aligned base at once); windows bound them to
    # ~1 GB regardless of genome size
    CHUNK = 32_000_000
    for w0 in range(0, n, CHUNK):
        w1 = min(n, w0 + CHUNK)
        t1 = np.asarray(m1.tgt_idx[w0:w1])
        sel = np.flatnonzero((t1 >= 0) & (lens[np.maximum(t1, 0)] > 0))
        if not len(sel):
            continue
        g = offs[t1[sel]] + np.asarray(m1.tgt_pos[w0:w1])[sel]
        ok = cat_idx[g] >= 0
        sel, g = sel[ok], g[ok]
        out.tgt_idx[w0:w1][sel] = cat_idx[g]
        out.tgt_pos[w0:w1][sel] = cat_pos[g]
        out.strand[w0:w1][sel] = \
            np.asarray(m1.strand[w0:w1])[sel] * cat_str[g]
    return out


def nearest_outgroups(tree: Tree, node: Tree, k: int) -> list[str]:
    """Nearest leaves outside `node`'s subtree (greedyLeaves strategy,
    reference: src/cactus/progressive/outgroup.py — distance-ranked)."""
    if k <= 0 or node.parent is None:
        return []
    inside = set(node.leaf_names()) | {node.name}
    cands = [lf for lf in tree.leaf_names() if lf not in inside]
    cands.sort(key=lambda lf: tree.distance(node.name, lf))
    return cands[:k]


class ProgressiveAligner:
    """Runs the full progressive pipeline over a guide tree."""

    def __init__(self, tree: Tree, genomes: dict[str, dict[str, Sequence]],
                 config: Config | None = None,
                 min_chain_override: int | None = None,
                 store=None, log=None, n_devices: int | None = None,
                 tree_workers: int = 1, check_tree: bool = True,
                 branch_scale: float = 1.0,
                 upweight_ancestors: bool = False, device=None):
        self.tree = tree.copy()
        self.device = resolve_device(device)
        # ancestor-level (tree) parallelism: independent subtree steps
        # run concurrently (the reference's one-Toil-job-per-ancestor
        # DAG, progressive_schedule cactus_progressive.py:86-155)
        self.tree_workers = max(1, tree_workers)
        self.tree.name_internal_nodes()
        self.config = config or Config.default()
        self.genomes = dict(genomes)
        self.min_chain_override = min_chain_override
        self.store = store          # AlignmentStore for checkpoint/resume
        self.log = log or (lambda msg: None)
        if check_tree:
            # input-tree sanity (progressive_decomposition.py:303-343)
            from .utils.decomposition import (check_branch_lengths,
                                              check_degree2_ancestors,
                                              check_multifurcations)
            check_branch_lengths(self.tree, log=self.log)
            check_degree2_ancestors(self.tree)
            check_multifurcations(self.tree, log=self.log)
        # divergence presets read from a (possibly scaled) copy of the
        # tree (get_ancestor_scaled_tree, reference :208-241)
        self.div_tree = self.tree
        if branch_scale != 1.0 or upweight_ancestors:
            from .utils.decomposition import get_ancestor_scaled_tree
            self.div_tree = get_ancestor_scaled_tree(
                self.tree, max_div=2.0, branch_scale=branch_scale,
                upweight_ancestors=upweight_ancestors)
        # shard the blast chunk-pair grid over an n-shard mesh of
        # devices and processes (outputs are bit-identical to one device
        # by construction — see parallel/mesh.py); the shards are cards,
        # or logical shards where self.device is the CPU
        self.mesh = None
        if n_devices is not None and n_devices > 1:
            from .parallel.mesh import make_mesh
            self.mesh = make_mesh(n_devices, device=self.device)

    def run(self, targets: set[str] | None = None) -> ProgressiveResult:
        """Run all ancestor steps (or only `targets`, relying on the
        store for their dependencies — the cactus-prepare decomposed
        per-ancestor stage semantics)."""
        import time
        steps: dict[str, AncestorStep] = {}
        if self.store is not None:
            self.store.save_tree(self.tree)
            for ev, genome in self.genomes.items():
                if not self.store.has_genome(ev):
                    self.store.save_genome(ev, genome)
        internal = [n for n in self.tree.postorder() if not n.is_leaf()]
        if targets is not None:
            # a target pulls in its not-yet-checkpointed internal
            # descendants (deps compute on demand; store-present steps
            # are resume points and stop the closure)
            by_name = {n.name: n for n in internal}
            keep: set[str] = set()

            def add_closure(name: str) -> None:
                if name not in by_name or name in keep:
                    return
                keep.add(name)
                if (self.store is not None and self.store.has_step(name)
                        and self.store.has_genome(name)):
                    return
                for c in by_name[name].children:
                    if not c.is_leaf():
                        add_closure(c.name)

            for t in targets:
                add_closure(t)
            internal = [n for n in internal
                        if n.name in keep
                        or (self.store is not None
                            and self.store.has_step(n.name))]
        if self.tree_workers > 1:
            self._run_tree_parallel(internal, steps)
        else:
            for node in internal:
                self._run_node(node, steps)
        result = ProgressiveResult(tree=self.tree, steps=steps,
                                   genomes=self.genomes)
        if self.config.check.run_check:
            # <check runCheck> analog: the reference runs
            # flower_checkRecursive after every phase
            # (pipeline/cactus_consolidated.c:385-511)
            from .phases.hal import hal_validate
            errs = hal_validate(result)
            if errs:
                raise AssertionError(
                    "hal_validate failed:\n" + "\n".join(errs))
            self.log("runCheck: hal_validate clean")
        return result

    def _run_node(self, node: Tree, steps: dict[str, AncestorStep]) -> None:
        """One ancestor: resume from the store or compute + checkpoint.

        Transient failures retry up to config retries (the Toil
        job-retry analog, SURVEY §5 failure detection); the checkpoint
        store means a retried process loses only the failing step.
        """
        import time
        if (self.store is not None and self.store.has_step(node.name)
                and self.store.has_genome(node.name)):
            # resume: reuse the checkpointed step (--restart semantics)
            step = self.store.load_step(node.name)
            self.genomes[node.name] = dict(step.ref.sequences)
            steps[node.name] = step
            self.log(f"{node.name}: resumed from store")
            return
        t0 = time.time()
        retries = getattr(self.config, "retries", 1)
        chunk_size = None          # None = configured value
        for attempt in range(retries + 1):
            try:
                step = self._ancestor_step(node, chunk_size=chunk_size)
                break
            except (MemoryError, OSError, RuntimeError) as e:
                if attempt >= retries:
                    raise
                # escalation on retry (the Slurm --doubleMem analog,
                # doc/pangenome.md:186): halve the blast chunk size so
                # the retried attempt needs roughly half the transient
                # memory per device batch — a deterministic failure
                # gets a *different*, cheaper execution instead of N
                # identical ones (per-node override; shared config is
                # never mutated — tree workers run concurrently)
                chunk_size = max(
                    1 << 20,
                    (chunk_size or self.config.blast.chunk_size) // 2)
                self.log(f"{node.name}: attempt {attempt + 1} failed "
                         f"({type(e).__name__}: {e}); retrying with "
                         f"chunk_size={chunk_size}")
        steps[node.name] = step
        self.log(f"{node.name}: {int(step.caf.alive.sum())} blocks, "
                 f"{step.ref.total_length()} bp ancestor, "
                 f"{time.time() - t0:.1f}s")
        if self.store is not None:
            self.store.save_genome(node.name, self.genomes[node.name])
            self.store.save_step(step)

    def _run_tree_parallel(self, internal: list[Tree],
                           steps: dict[str, AncestorStep]) -> None:
        """Dependency-scheduled concurrent ancestor steps.

        A node is ready once every internal child's step exists (leaf
        children and leaf outgroups are always ready); the thread pool
        mirrors the reference's Toil job DAG over ancestors.  Steps land
        in `steps` / `self.genomes` under the GIL, and a node is only
        submitted after its dependencies completed, so workers never
        race on shared state.
        """
        from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                        wait)
        internal_names = {n.name for n in internal}
        pending = {n.name: n for n in internal}
        done: set[str] = set()

        def ready(node: Tree) -> bool:
            return all(c.name in done or c.name not in internal_names
                       for c in node.children)

        with ThreadPoolExecutor(max_workers=self.tree_workers) as pool:
            futures = {}
            while pending or futures:
                for name in [n for n, nd in pending.items() if ready(nd)]:
                    futures[pool.submit(self._run_node, pending[name],
                                        steps)] = name
                    del pending[name]
                if not futures:
                    raise RuntimeError("tree schedule deadlock: "
                                       f"pending={list(pending)}")
                fin, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for f in fin:
                    name = futures.pop(f)
                    f.result()      # propagate worker exceptions
                    done.add(name)

    # ---- one ancestor ----
    def _ancestor_step(self, node: Tree,
                       chunk_size: int | None = None) -> AncestorStep:
        cfg = self.config
        children = [c.name for c in node.children]
        from .utils.outgroups import greedy_outgroups
        outgroups = greedy_outgroups(
            self.tree, node, cfg.outgroup.max_num_outgroups,
            overlap_scale=cfg.outgroup.overlap_penalty,
            clade_discount=cfg.outgroup.clade_discount)
        events = children + outgroups
        seqs: dict[str, Sequence] = {}
        for ev in events:
            for name, s in self.genomes[ev].items():
                seqs[name] = s

        # divergence preset from the deepest ingroup path (caf.c:159-183),
        # measured on the scaled divergence tree when configured
        div_node = self.div_tree.find(node.name) or node
        max_path = max((c.length or 0.0) + c.max_leaf_depth()
                       for c in div_node.children)
        if node is self.tree or node.name == self.tree.name:
            # extra divergence allowance when aligning the root's
            # children (distanceToAddToRootAlignment, config XML :2-3 —
            # declared-but-unread in the reference code; honored here)
            max_path += self.config.distance_to_add_to_root_alignment
        preset = divergence_preset(2.0 * max_path)

        # per-phase wall-clock + peak-RSS telemetry (the reference's
        # st_logInfo elapsed-seconds lines and CACTUS_LOG_MEMORY
        # peak-RSS reporting; pipeline/cactus_consolidated.c:366-555,
        # shared/common.py:819-825,928-955)
        import resource as _resource
        import time as _time
        timings: dict[str, float] = {}
        mem_mb: dict[str, float] = {}

        def _rss_mb() -> float:
            return _resource.getrusage(
                _resource.RUSAGE_SELF).ru_maxrss / 1024.0

        def _device_peak_mb() -> float:
            """CUDA peak bytes allocated so far (0 on the CPU)."""
            if self.device.type != "cuda":
                return 0.0
            import torch
            return torch.cuda.max_memory_allocated(self.device) / 1e6

        self.log(f"{node.name}: blast starting (preset {preset}, "
                 f"{len(seqs)} seqs, og={outgroups})")
        t0 = _time.time()
        records = self._blast(node, children, outgroups, preset,
                              chunk_size=chunk_size)
        timings["blast"] = _time.time() - t0
        mem_mb["blast"] = _rss_mb()

        # outgroup alignments are OVERLAY evidence (reconstruction votes),
        # not structural pinches: independent og alignments wobble against
        # each other and fragment ingroup block segmentation (measured:
        # cow↔dog recall 0.97→0.62 when og records pinch)
        og_set = set(outgroups)

        def is_og(r):
            return (r.qname.split(".", 1)[0] in og_set
                    or r.tname.split(".", 1)[0] in og_set)

        og_records = [r for r in records if is_og(r) and r.is_primary]
        in_records = [r for r in records if not is_og(r)]
        in_seqs = {n: s for n, s in seqs.items()
                   if n.split(".", 1)[0] not in og_set}
        og_full = {n: s for n, s in seqs.items()
                   if n.split(".", 1)[0] in og_set}
        if cfg.blast.trim_outgroups and og_full:
            # keep only og sequence near an ingroup alignment (reference
            # trimOutgroups, local_alignment.py:861-904)
            total = sum(len(s) for s in og_full.values())
            og_records, og_codes = blast_phase.trim_outgroup_sequences(
                og_records, og_full,
                flank=cfg.blast.trim_outgroup_flanking)
            kept = sum(len(c) for c in og_codes.values())
            if total:
                self.log(f"{node.name}: og trim kept {kept}/{total} bp "
                         f"({100.0 * kept / total:.0f}%)")
        else:
            og_codes = {n: s.codes for n, s in og_full.items()}
        self.log(f"{node.name}: caf starting ({len(in_records)} ingroup + "
                 f"{len(og_records)} og records)")

        t0 = _time.time()
        event_tree = self._event_tree(node, outgroups)
        if cfg.caf.pinch_outgroups:
            # reference semantics (caf/impl/caf.c:238-284): outgroup
            # records pinch as real threads, so the singleCopyOutgroup
            # policy family + minimumOutgroupDegree act structurally;
            # og-only blocks still die at minimumIngroupDegree, and the
            # HAL/maps layers already skip non-child events
            caf_seqs = dict(in_seqs)
            for n, c in og_codes.items():
                caf_seqs[n] = Sequence(n, c)
            caf_records = in_records + og_records
            caf_og_events = og_set
        else:
            caf_seqs = in_seqs
            caf_records = in_records
            caf_og_events = set()
        lengths = {n: len(s) for n, s in caf_seqs.items()}
        caf = run_caf(caf_records, lengths, cfg.caf, preset=preset,
                      ingroup_events=set(children),
                      outgroup_events=caf_og_events,
                      min_chain_override=self.min_chain_override,
                      event_tree=event_tree)
        timings["caf"] = _time.time() - t0
        mem_mb["caf"] = _rss_mb()
        self.log(f"{node.name}: bar starting "
                 f"({int(caf.alive.sum())} live blocks)")

        t0 = _time.time()
        if cfg.nested_refinement:
            # second decomposition inside large unaligned link
            # interiors, BEFORE bar fills adjacency gaps (the
            # reference's recursive flower layers run at the CAF level
            # and bar works the hierarchy's leaves —
            # cactus_consolidated.c:426-460; phases/nested.py)
            from .phases import nested as nested_phase
            # iterate to fixpoint (depth cap): the reference recurses
            # layer-by-layer until leaf flowers
            # (cactus_consolidated.c:439-460, caf/impl/finishing.c:438);
            # a level-2 tangle (an inversion inside an insertion inside
            # an insertion) only becomes visible on the graph REBUILT by
            # level 1, so one pass can miss it (tests/test_nested.py)
            for depth in range(cfg.nested_max_depth):
                n0 = int(caf.alive.sum())
                caf = nested_phase.refine_nested(
                    caf, caf_seqs, cfg, preset, set(children),
                    caf_og_events, log=lambda m: self.log(
                        f"{node.name}: {m}"), device=self.device)
                n1 = int(caf.alive.sum())
                if n1 == n0:
                    break
                self.log(f"{node.name}: nested refinement level "
                         f"{depth + 1}: {n0} -> {n1} live blocks")
        caf = bar_phase.run_bar(caf, caf_seqs, cfg.bar,
                                ingroup_events=set(children),
                                outgroup_events=caf_og_events,
                                device=self.device)
        if cfg.bar.rescue and og_records and not cfg.caf.pinch_outgroups:
            n0 = caf.blocks.n_blocks
            caf = bar_phase.rescue_outgroup_covered(caf, og_records, cfg.bar)
            if caf.blocks.n_blocks > n0:
                self.log(f"{node.name}: rescued "
                         f"{caf.blocks.n_blocks - n0} outgroup-covered "
                         f"segments (bar rescue)")
        timings["bar"] = _time.time() - t0
        mem_mb["bar"] = _rss_mb()

        t0 = _time.time()
        gcodes = bar_phase.global_codes(caf.table, caf_seqs)
        ref = ref_phase.run_reference(
            caf, gcodes, event_tree, node.name, cfg.reference,
            # og evidence is structural when pinched; overlay otherwise
            og_records=[] if cfg.caf.pinch_outgroups else og_records,
            og_codes=og_codes, device=self.device)
        timings["reference"] = _time.time() - t0
        mem_mb["reference"] = _rss_mb()
        # the full ancestor genome (incl. dust threads) stays available
        # for export/maps; the parent's blast packs small contigs into
        # super-contigs, so fragmentation can't explode its pair grid
        self.genomes[node.name] = dict(ref.sequences)
        maps = seq_maps_from_step(caf, ref)
        dev_mb = _device_peak_mb()
        self.log(f"{node.name} phases: " + " ".join(
            f"{k}={v:.1f}s" for k, v in timings.items())
                 + " | peak rss " + " ".join(
            f"{k}={v:.0f}MB" for k, v in mem_mb.items())
                 + (f" | device peak {dev_mb:.0f}MB" if dev_mb else ""))
        timings.update({f"{k}_peak_rss_mb": v for k, v in mem_mb.items()})
        if dev_mb:
            timings["device_peak_mb"] = dev_mb
        return AncestorStep(event=node.name, caf=caf, ref=ref,
                            anc_seq_names=list(ref.sequences),
                            maps=maps, ingroup_events=set(children),
                            outgroup_events=set(outgroups),
                            timings=timings)

    def _blast(self, node: Tree, children: list[str], outgroups: list[str],
               preset: str, chunk_size: int | None = None):
        """All ingroup pairs + each ingroup vs outgroups (reference:
        make_paf_alignments, paf/local_alignment.py:751-858).  Genome seq
        names already carry the event prefix.  Fragmented genomes are
        packed into N-spaced super-contigs (faffy-chunk style) so the
        contig-pair grid stays bounded, then long contigs split into the
        chunkSize/overlapSize grid (30 Mb / 10 kb, config XML :90-92) —
        the memory bound that admits chromosome-scale inputs.  The
        resulting chunk-pair task grid is sharded over the device mesh
        when one is configured."""
        from .phases.chunking import (chunk_genome, dechunk_records,
                                      fix_lengths, pack_small_contigs,
                                      split_packed_records)
        cfg = self.config.blast
        big_mode = (cfg.aligner in ("fastga", "minimap2")
                    and chunk_size is None)
        eff_chunk = chunk_size or (cfg.big_chunk_size if big_mode
                                   else cfg.chunk_size)
        packed: dict[str, dict] = {}
        pack_maps: dict = {}
        chunks: dict[str, list] = {}
        qchunks: dict[str, list] = {}
        for ev in set(children) | set(outgroups):
            packed[ev], mp = pack_small_contigs(self.genomes[ev])
            pack_maps.update(mp)
            chunks[ev] = chunk_genome(packed[ev], eff_chunk,
                                      cfg.overlap_size)
            # whole-genome-aligner grid: query chunks stream against the
            # ONE whole-genome target index (minimap2/FastGA structure;
            # the reference's bigChunkSize=6e9 degenerate grid) — task
            # count and per-task memory stay LINEAR in genome size
            qchunks[ev] = (chunk_genome(packed[ev], cfg.chunk_size,
                                        cfg.overlap_size)
                           if big_mode else chunks[ev])

        og_preset = preset if preset in ("one", "two", "three", "four",
                                         "five") else "default_og"

        by_name = {c.name: c
                   for clist in (chunks, qchunks)
                   for ev in clist for c in clist[ev]
                   if c.name != c.origin}

        def chunk_pair_tasks(qchunks, tchunks, use_preset, out):
            for qc in qchunks:
                if len(qc.seq) < cfg.minimum_sequence_length:
                    continue
                for tc in tchunks:
                    if len(tc.seq) < cfg.minimum_sequence_length:
                        continue
                    out.extend(blast_phase.pair_tasks(
                        qc.seq, tc.seq, qc.name, tc.name, cfg, use_preset))

        tasks = []
        for i, a in enumerate(children):
            for b in children[i + 1:]:
                chunk_pair_tasks(qchunks[a], chunks[b], preset, tasks)
        if not cfg.trim_ingroups:
            for a in children:
                for og in outgroups:
                    chunk_pair_tasks(qchunks[a], chunks[og], og_preset,
                                     tasks)
        elif outgroups:
            # cascade tier 0 aligns FULL ingroups to the nearest og —
            # independent of the ingroup-pair results, so its tasks
            # share the main dispatch (one device batch, no extra
            # barrier); later tiers depend on tier-0 coverage
            for a in children:
                chunk_pair_tasks(qchunks[a], chunks[outgroups[0]],
                                 og_preset, tasks)
        if self.mesh is not None:
            self.log(f"{node.name}: {len(tasks)} blast tasks over "
                     f"{len(self.mesh.devices.flat)} devices")
        records = blast_phase.run_tasks(tasks, cfg, mesh=self.mesh,
                                        log=self.log, device=self.device)
        records = dechunk_records(records, by_name)

        if cfg.trim_ingroups and outgroups:
            og0 = outgroups[0]
            tier0 = [r for r in records
                     if r.tname.split(".", 1)[0] == og0]
            records = [r for r in records
                       if r.tname.split(".", 1)[0] != og0]
            records += self._blast_outgroup_cascade(
                node, children, outgroups, packed, chunks, og_preset,
                tier0_records=tier0, eff_chunk=eff_chunk)

        records = split_packed_records(records, pack_maps)
        lengths = {n: len(s)
                   for ev in set(children) | set(outgroups)
                   for n, s in self.genomes[ev].items()}
        records = fix_lengths(records, lengths)
        return blast_phase.finalize(records, cfg)

    def _blast_outgroup_cascade(self, node: Tree, children: list[str],
                                outgroups: list[str], packed, chunks,
                                og_preset: str, tier0_records=None,
                                eff_chunk: int | None = None):
        """Progressive ingroup→outgroup trimming (reference
        make_ingroup_to_outgroup_alignments_0/1/2/3,
        paf/local_alignment.py:421-526): align each ingroup to the
        nearest outgroup, extract the uncovered remainder (≥ trimMinSize,
        flanked by trimFlanking), and recurse on the next outgroup — so
        later outgroups only see sequence earlier ones missed.  Records
        come back rebased to the packed-contig coordinates."""
        from .phases.chunking import (chunk_genome, dechunk_records,
                                      uncovered_subsequences)
        cfg = self.config.blast
        eff_chunk = eff_chunk or cfg.chunk_size
        # per child: the shrinking remainder genome and the rebase map
        # from its current sequence names back to packed coordinates
        remainder = {c: dict(packed[c]) for c in children}
        sub_rebase: dict[str, dict] = {c: {} for c in children}
        out: list = []
        for tier, og in enumerate(outgroups):
            if tier == 0 and tier0_records is not None:
                # produced inside the main blast dispatch (already in
                # packed coords — dechunked there)
                recs = tier0_records
            else:
                tasks = []
                tier_rebase: dict = {}
                for c in children:
                    rchunks = chunk_genome(remainder[c], eff_chunk,
                                           cfg.overlap_size)
                    for ch in rchunks:
                        if ch.name != ch.origin:
                            tier_rebase[ch.name] = ch
                    for qc in rchunks:
                        if len(qc.seq) < cfg.minimum_sequence_length:
                            continue
                        for tc in chunks[og]:
                            if len(tc.seq) < cfg.minimum_sequence_length:
                                continue
                            tasks.extend(blast_phase.pair_tasks(
                                qc.seq, tc.seq, qc.name, tc.name, cfg,
                                og_preset))
                if not tasks:
                    break
                recs = blast_phase.run_tasks(tasks, cfg, mesh=self.mesh,
                                             log=self.log,
                                             device=self.device)
                # rebase the 30 Mb chunk layer → current remainder coords
                recs = dechunk_records(recs, tier_rebase)
            # this tier's remainder→packed map, before it advances
            cur_rebase = {name: ch for c in children
                          for name, ch in sub_rebase[c].items()}
            if tier + 1 < len(outgroups):
                # shrink each child's remainder to what this tier left
                # uncovered, while records are still in remainder coords
                total_left = 0
                for c in children:
                    if not remainder[c]:
                        continue
                    subs, rebase = uncovered_subsequences(
                        remainder[c], recs, min_size=cfg.trim_min_size,
                        flank=cfg.trim_flanking)
                    comp: dict = {}
                    for name, ch in rebase.items():
                        base = sub_rebase[c].get(ch.origin)
                        if base is not None:
                            ch.origin = base.origin
                            ch.offset += base.offset
                        comp[name] = ch
                    for name in subs:
                        # a fully-uncovered sub survives under its old
                        # name: carry its packed-coords mapping forward
                        if name not in comp and name in sub_rebase[c]:
                            comp[name] = sub_rebase[c][name]
                    sub_rebase[c] = comp
                    remainder[c] = subs
                    total_left += sum(len(s) for s in subs.values())
                self.log(f"{node.name}: og cascade tier {tier} ({og}): "
                         f"{total_left} bp uncovered remaining")
            # remainder-extraction layer → packed coords (the reference's
            # `paffy dechunk --query`, local_alignment.py:516-519)
            recs = dechunk_records(recs, cur_rebase)
            out.extend(recs)
        return out

    def _event_tree(self, node: Tree, outgroups: list[str]) -> Tree:
        """Felsenstein tree: the ancestor's children subtrees collapsed to
        leaf events + outgroups attached at the root by path distance."""
        root = Tree(node.name)
        for c in node.children:
            root.add_child(Tree(c.name, c.length))
        for og in outgroups:
            root.add_child(Tree(og, self.tree.distance(node.name, og)))
        return root


# --------------------------------------------------------------------------
# transitive leaf homology (scoring surface)
# --------------------------------------------------------------------------

def leaf_map_to_ancestor(result: ProgressiveResult, leaf: str,
                         ancestor: str) -> dict[str, SeqMap]:
    """Compose maps from `leaf`'s sequences up to `ancestor`'s genome."""
    node = result.tree.find(leaf)
    maps: dict[str, SeqMap] | None = None
    names: list[str] = []
    while node is not None and node.name != ancestor:
        parent = node.parent
        if parent is None:
            raise KeyError(f"{ancestor} is not an ancestor of {leaf}")
        step = result.steps[parent.name]
        if maps is None:
            maps = {n: step.maps[n] for n in result.genomes[leaf]}
        else:
            maps = {n: compose_maps(m, names, step.maps)
                    for n, m in maps.items()}
        names = step.anc_seq_names
        node = parent
    if maps is None:  # leaf == ancestor
        raise KeyError("leaf equals ancestor")
    return maps


def _lca(tree: Tree, a: str, b: str) -> str:
    ancs = set()
    n = tree.find(a)
    while n is not None:
        ancs.add(n.name)
        n = n.parent
    n = tree.find(b)
    while n is not None:
        if n.name in ancs:
            return n.name
        n = n.parent
    raise KeyError(f"no LCA of {a},{b}")


def leaf_pairs_arr(result: ProgressiveResult, a: str, b: str) -> np.ndarray:
    """All predicted homologous base pairs between leaf genomes a and b,
    joined through their LCA's coordinates, as a sorted-unique packed key
    array (utils/pairs.py).  Positions are per-genome concatenated
    (single-contig genomes: plain positions)."""
    from .utils import pairs as pk
    lca = _lca(result.tree, a, b)
    ma = leaf_map_to_ancestor(result, a, lca)
    mb = leaf_map_to_ancestor(result, b, lca)

    def flat(maps, genome):
        offs = {}
        off = 0
        for n, s in result.genomes[genome].items():
            offs[n] = off
            off += len(s)
        pos_l, key_l, strand_l = [], [], []
        for n, m in maps.items():
            sel = np.flatnonzero(m.tgt_idx >= 0)
            pos_l.append(sel + offs[n])
            key_l.append(m.tgt_idx[sel].astype(np.int64) << 40
                         | m.tgt_pos[sel])
            strand_l.append(m.strand[sel])
        if not pos_l:
            z = np.zeros(0, np.int64)
            return z, z, z.astype(np.int8)
        return (np.concatenate(pos_l), np.concatenate(key_l),
                np.concatenate(strand_l))

    pa, ka, sa = flat(ma, a)
    pb, kb, sb = flat(mb, b)
    ia, ib = pk.join_expand(ka, kb)
    rel = sa[ia].astype(np.int16) * sb[ib]
    return pk.unique_keys(pk.pack_pairs(pa[ia], pb[ib], rel))


def leaf_pairs(result: ProgressiveResult, a: str, b: str
               ) -> set[tuple[int, int, int]]:
    """Legacy tuple-set view of leaf_pairs_arr."""
    from .utils import pairs as pk
    return pk.unpack_pairs(leaf_pairs_arr(result, a, b))
