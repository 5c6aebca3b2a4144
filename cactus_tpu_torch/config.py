"""Typed configuration tree for the whole pipeline.

Mirrors the reference's single-XML parameter system
(reference: src/cactus/cactus_progressive_config.xml, parsed on the Python
side by shared/configWrapper.py and on the C side by
api/impl/cactus_params_parser.c).  Here it is a dataclass tree with the same
defaults and the same divergence-dependent preset mechanism
(<divergences one..five> at cactus_progressive_config.xml:10-13 select
per-divergence argument sets; selection logic per caf/impl/caf.c:159-183).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# Divergence preset thresholds (config XML :12): the preset is the first
# whose threshold is >= the max ingroup path length in the guide tree.
DIVERGENCE_THRESHOLDS = {
    "one": 0.05, "two": 0.10, "three": 0.15, "four": 0.20, "five": 0.25,
}
PRESET_ORDER = ["one", "two", "three", "four", "five", "default"]


def divergence_preset(max_path_length: float) -> str:
    for name in PRESET_ORDER[:-1]:
        if max_path_length <= DIVERGENCE_THRESHOLDS[name]:
            return name
    return "default"


# lastz's default T=1 spaced seed (12-of-19), a lighter 11-of-18
# variant, and a transition-tolerant mixed-weight seed ('T' = 1-bit
# purine/pyrimidine care) for the most diverged tier — measured anchor
# coverage at divergence 0.45/0.55: 0.90/0.68 vs 0.76/0.50 for 11-of-18
SEED_12_OF_19 = "1110100110010101111"
SEED_11_OF_18 = "111010011001010111"
SEED_MIXED_19BIT = "11T0110T1T0111"


@dataclass
class SeedParams:
    """Seeding for the pairwise anchoring stage (lastz-equivalent).

    The reference tunes lastz --step and seed scheme by divergence
    (config XML :130-137; lastz default seed = spaced 12-of-19).  Here
    close presets use exact 15-mers (fast, specific) and distant presets
    spaced seeds (mismatch-tolerant with retained specificity).
    """
    k: int = 15
    steps: dict[str, int] = field(default_factory=lambda: {
        "one": 2, "two": 2, "three": 1, "four": 1, "five": 1,
        "default": 1, "default_og": 1})
    pattern: str = ""  # override: spaced-seed 1/0 pattern for ALL presets
    # 'default_og' applies to ingroup↔outgroup pairs at the distant
    # preset: outgroup alignments are advisory evidence, and the
    # highest-sensitivity seed there floods CAF with wobble-fragmenting
    # pinches (measured: cow↔dog 0.97→0.79 when og pairs use the mixed
    # seed)
    patterns: dict[str, str] = field(default_factory=lambda: {
        "one": "", "two": "",                      # contiguous k
        "three": SEED_12_OF_19,
        "four": SEED_11_OF_18, "five": SEED_11_OF_18,
        "default": SEED_MIXED_19BIT,
        "default_og": SEED_11_OF_18})
    max_occurrences: int = 64   # drop seeds occurring more often (repeat guard)
    max_anchors: int = 1 << 22  # fixed-size anchor buffer per chunk pair
    # length-adaptive seeds: the 18-22-bit divergence T-patterns drown
    # in Lq*Lt/2^bits chance collisions at megabase scale (a 4 Mb pair
    # yields ~30M spurious anchors on the 19-bit default pattern);
    # above the threshold such patterns fall back to lastz's 12-of-19
    # seed (24 bits) — see pattern_for.  Contiguous k=15 (30 bits) is
    # already specific enough (≈16k chance hits per 4 Mb pair, and the
    # native HSP filter removes those), and staying ≤15 keeps every
    # seed scheme within the device kernel's int32 hash space, so the
    # same join can run host-side OR as a batched TPU dispatch.
    k_large: int = 15
    seed_scale_threshold: int = 1_000_000
    # single-chip device routing for seed joins: chunk pairs whose
    # combined length reaches this go to the TPU as batched vmapped
    # joins.  Disabled by default: MEASURED SLOWER on a v5e (20 Mb
    # pair blast 783 s vs 142 s on the threaded host-numpy join —
    # XLA's TPU argsort at 4M keys loses to numpy's introsort by ~5x
    # per join, dwarfing any transfer saving).  Kept config-reachable
    # for future hardware/XLA where the device sort wins.
    device_join_threshold: int = 1 << 62

    def step_for(self, preset: str) -> int:
        return self.steps.get(preset, self.steps["default"])

    def pattern_for(self, preset: str, min_len: int = 0) -> str:
        if self.pattern:
            return self.pattern
        p = self.patterns.get(preset, self.patterns["default"])
        if p and min_len >= self.seed_scale_threshold:
            # megabase-scale tasks: permissive low-bit patterns (the
            # 18-22 bit divergence seeds) drown in L^2/2^bits chance
            # hits; fall back to lastz's own default 12-of-19 seed —
            # what the reference runs at EVERY divergence (submodule
            # lastz default seed; transitions approximated by the
            # T-patterns only below this scale)
            ones = 2 * p.count("1") + p.count("T")
            if ones < 24:
                return SEED_12_OF_19
        return p

    def k_for(self, preset: str, min_len: int) -> int:
        """Effective contiguous seed weight for a task whose smaller
        side is min_len bases (no-op when a spaced pattern drives)."""
        if self.pattern_for(preset, min_len):
            return self.k
        if min_len >= self.seed_scale_threshold:
            return self.k_large
        return self.k

    def span_for(self, preset: str, min_len: int = 0) -> int:
        p = self.pattern_for(preset, min_len)
        return len(p) if p else self.k_for(preset, min_len)


@dataclass
class ExtendParams:
    """Gapped/ungapped extension scores (lastz-equivalent defaults).

    lastz default scoring: match 91 / mismatch -114ish (HOXD70-like);
    we use the same 5x5 substitution matrix the reference feeds abPOA
    (config XML :312-318) for consistency across stages.
    """
    match: int = 91
    mismatch: int = -114
    gap_open: int = 400
    gap_extend: int = 30
    # xdrop + hsp_threshold drive the native ungapped x-drop HSP filter
    # (native/dp.cpp dp_hsp_filter — lastz's seed-hit filtering): seed
    # runs extend along their diagonal and must reach hsp_threshold or
    # die before chaining.  ydrop's gapped-termination role is covered
    # by the banded gap fill plus the min_gap_score record split
    # (blast._emit_records).
    xdrop: int = 910
    ydrop: int = 3000
    hsp_threshold: int = 1500  # min ungapped HSP score to seed gapped ext
    gapped_threshold: int = 2400  # min gapped alignment score to report
    # chains force-stitch their anchor gaps with banded DP; a filled
    # gap whose DP score is negative means the chain bridged a
    # NON-homologOUS interval (e.g. an inversion) — split the record
    # there instead, so the true (reverse-strand) alignment can win the
    # interval as primary.  lastz's ydrop terminates chains the same
    # way; splits apply to gaps spanning >= min_gap_score_cols columns.
    min_gap_score: int = 0
    min_gap_score_cols: int = 48
    band: int = 128        # band half-width (diagonal units) for gapped DP


@dataclass
class BlastParams:
    """Blast (pairwise anchoring) phase — config XML <blast> (:90-123).

    chunk_size: the reference's 30 Mb suits lastz's memory profile
    (config XML :90); the TPU-first default is 4 Mb so one chunk pair's
    seed anchors fit the fixed-capacity device table with headroom
    (~1 anchor/bp unique + repeat occupancy vs the max_anchors buffer)
    and the chunk-pair grid gives the mesh scheduler useful granularity.
    Loading the reference XML restores 30 Mb; the per-task adaptive
    anchor cap in phases/blast.py keeps that safe too."""
    chunk_size: int = 4_000_000
    overlap_size: int = 10_000
    minimum_sequence_length: int = 30
    # chaining (paffy chain equivalents, config :106-113)
    chain_gap_open: int = 5000
    chain_gap_extend: int = 1
    chain_max_gap_length: int = 1_000_000
    chain_trim_fraction: float = 1.0
    paf_trim_identity: float = 0.2
    min_primary_chain_score: int = 10_000
    # ingroup/outgroup trimming (config :114-119)
    trim_ingroups: bool = True
    trim_outgroups: bool = True
    trim_min_size: int = 100
    trim_flanking: int = 100
    trim_outgroup_flanking: int = 2000
    # keep tile-level>1 / demoted records as tp:A:S in the blast output
    # (reference XML default 0 drops them before CAF, config :119; the
    # TPU-first default keeps them — CAF's vectorized secondary-tier
    # filter policies are cheap here and secondaries measurably help
    # the symmetric-evidence anneal; loading a reference XML restores 0)
    output_secondary_alignments: bool = True
    # primary/secondary selection mode: "coverage" (query-coverage
    # greedy, keeps overlapping evidence — measured best recall with
    # duplications) or "tile-trim" (the reference paffy
    # chain→tile→trim→filter pipeline, local_alignment.py:658-727 —
    # fewer records, ~25% faster, small recall cost on duplications)
    primary_selection: str = "coverage"
    # alternative whole-genome aligner mode (reference --fastga,
    # local_alignment.py:120-241): adaptamer-style seeding — only
    # target-unique seed hits, merged runs kept at ≥ fastga_min_match —
    # sparse anchors for near-identical genomes at a fraction of the
    # seed volume
    # "minimap2" mode (reference `minimap2 -c -x asm20`,
    # local_alignment.py:99-118, config XML :94): contiguous-k seeds
    # sampled as (k, w) window minimizers on both sides, same
    # chain/extend stack downstream
    aligner: str = "lastz"              # "lastz" | "fastga" | "minimap2"
    fastga_min_match: int = 20
    minimap2_window: int = 10           # minimizer window w
    # whole-genome aligner modes keep the chunk-pair grid DEGENERATE:
    # the reference bumps chunkSize to bigChunkSize=6e9 for GPU/FastGA
    # runs (config XML :91, local_alignment.py:378-390) so the
    # quadratic all-pairs grid collapses to ~one task per genome pair
    # and the genome-scale index is built once — the same switch here
    # (host-side exact join; the fixed-capacity device table only
    # serves sub-chunk tasks)
    big_chunk_size: int = 6_000_000_000
    seed: SeedParams = field(default_factory=SeedParams)
    extend: ExtendParams = field(default_factory=ExtendParams)


@dataclass
class CafParams:
    """CAF phase — config XML <caf> (:195-231)."""
    deannealing_rounds: tuple[int, ...] = (2, 32, 256)
    annealing_rounds: dict[str, tuple[int, ...]] = field(default_factory=lambda: {
        "one": (2048,), "two": (1024,), "three": (1024,),
        "four": (512,), "five": (512,), "default": (256,)})
    trim: int = 3
    block_trim: int = 5
    minimum_block_degree: int = 2
    minimum_number_of_species: int = 1
    minimum_ingroup_degree: int = 1
    minimum_outgroup_degree: int = 0
    minimum_tree_coverage: float = 0.0
    alignment_filter: str = "filterSecondariesByMultipleSequences"
    # Pinch outgroup records into the block graph as real threads
    # (reference semantics, caf/impl/caf.c:238-284): makes the
    # outgroup-dependent filter policies (singleCopyOutgroup family,
    # minimumOutgroupDegree) act end-to-end.  Default OFF = outgroup
    # evidence stays overlay-only (Felsenstein votes + bar rescue):
    # A/B on 0.2-divergence sims with segmental duplications measured
    # overlay better (og alignment wobble fragments ingroup block
    # segmentation; cow-dog recall 0.97 -> 0.62 when pinched, round-1
    # note in progressive.py) — but both paths are driver-reachable.
    pinch_outgroups: bool = False
    max_adjacency_component_size_ratio: float = 50.0
    # XML-compat: stCaf_finish uses these to decide which thread ends
    # are "attached" (chromosome-level) when building the recursive
    # flower hierarchy (caf.c:474, pinchToCactus.c:115-116); the flat
    # block model here has no attachment notion — fragmented ancestors
    # are instead packed into super-contigs by the parent's blast
    # (phases/chunking.py pack_small_contigs), losing no homology
    min_length_for_chromosome: int = 1_000_000
    proportion_unaligned_bases_for_new_chromosome: float = 0.95
    max_median_sequence_length_between_linked_ends: int = 100_000
    remove_recoverable_chains: str = "unequalNumberOfIngroupCopies"
    max_recoverable_chains_iterations: int = 10
    max_recoverable_chain_length: int = 500_000
    minimum_block_homology_support: float = 0.05
    # reference default -1 disables the megablock support check
    # (config XML :212); set >0 to destroy weakly-supported megablocks
    minimum_block_degree_to_check_support: int = -1
    # anneal tp:A:S records with the secondary filter policy (the
    # reference always feeds the secondary PAF when present)
    use_secondary_alignments: bool = True

    def annealing_for(self, preset: str) -> tuple[int, ...]:
        return self.annealing_rounds.get(preset, self.annealing_rounds["default"])


@dataclass
class PecanParams:
    """cPecan pair-HMM MSA params — config XML <pecan> (:271-286)."""
    spanning_trees: int = 5
    gap_gamma: float = 0.0
    match_gamma: float = 0.2
    use_banding: bool = True
    split_matrix_bigger_than_this: int = 3000
    anchor_matrix_bigger_than_this: int = 500
    diagonal_expansion: int = 20
    constraint_diagonal_trim: int = 14
    align_ambiguity_characters: bool = True
    use_progressive_merging: bool = True
    use_mum_anchors: bool = True
    recursive_mums: bool = True
    # reference always runs stateMachine5_construct(fiveState)
    # (bar/impl/bar.c:65); False falls back to the 3-state machine
    five_state: bool = True


@dataclass
class PoaParams:
    """abPOA-equivalent MSA params — config XML <poa> (:307-326)."""
    window: int = 10_000            # sliding window, 50% overlap
    band_constant: int = 1000       # adaptive band = const + frac*len
    band_fraction: float = 0.1
    # 5x5 ACGTN substitution matrix (config :312-318)
    sub_matrix: tuple[int, ...] = (
        91, -114, -61, -123, -100,
        -114, 100, -125, -61, -100,
        -61, -125, 100, -114, -100,
        -123, -61, -114, 91, -100,
        -100, -100, -100, -100, 100)
    gap_open1: int = 400
    gap_extend1: int = 30
    gap_open2: int = 1200
    gap_extend2: int = 1
    progressive_mode: bool = True


@dataclass
class BarParams:
    """BAR phase — config XML <bar> (:244-260).

    msa_engine: 'star' (batched banded-DP star MSA — the TPU-first
    default, equal accuracy to POA on benchmarks), 'poa' (true
    partial-order graph MSA, the abPOA-parity path), 'pecan' (pair-HMM
    posteriors, the cPecan path; selected by partialOrderAlignment=0 in
    reference configs)."""
    run_bar: bool = True
    banding_limit: int = 1_000_000
    msa_engine: str = "star"
    partial_order_alignment: bool = True
    # per-string cap (reference bandingLimit, config:245); strings
    # longer than the POA window align as 10 kb windows with carry-over
    # cursors (ops/banded.py:align_pairs_windowed)
    max_end_string: int = 1_000_000
    # consistency: choose each two-end gap's cut point from alignment
    # coverage instead of the midpoint (poaBarAligner.c:751-806)
    best_cut: bool = True
    # bar rescue (bar/impl/rescue.c): unblocked ingroup runs covered by
    # outgroup alignments become single-degree blocks so the sequence
    # reaches the ancestor
    rescue: bool = True
    rescue_min_segment_length: int = 100
    rescue_covered_threshold: float = 0.5
    minimum_block_degree: int = 2
    minimum_ingroup_degree: int = 1
    minimum_outgroup_degree: int = 0
    minimum_number_of_species: int = 1
    pecan: PecanParams = field(default_factory=PecanParams)
    poa: PoaParams = field(default_factory=PoaParams)


@dataclass
class ReferenceParams:
    """Reference phase — config XML <reference> (:345-361)."""
    matching_algorithm: str = "blossom5"  # blossom5|maxWeight|maxCardinality|greedy
    # XML-compat: the consolidated binary takes the reference event name
    # from this knob; this driver names every ancestor by its tree node
    # (progressive.py), so the value is never consulted
    reference_event: str = "reference"
    # XML-compat: the reference's own annealing-temperature hook is
    # documented "currently unused" (buildReference.c:1050); the nudge
    # pass here is the equivalent constant-temperature hill climb
    use_simulated_annealing: bool = True
    theta: float = 1e-6
    phi: float = 1.0
    max_walk_for_calculating_z: int = 100_000
    permutations: int = 10
    ignore_unaligned_gaps: bool = True
    wiggle: float = 0.9999
    number_of_ns: int = 10
    min_sequences_to_support_adjacency: int = 1
    make_scaffolds: bool = True
    # streamed Felsenstein: ancestral reconstruction runs per column
    # window of this size so the (C, E, 4) observation tensor and its
    # per-segment-base expansion stay bounded at genome scale (the
    # reference streams blocks through its RecordHolder machinery,
    # recursiveThreadBuilder.h:19-37)
    felsenstein_window_columns: int = 8_000_000


@dataclass
class PreprocessorParams:
    """Preprocessor chain — config XML <preprocessor> entries (:20-43)."""
    cut_headers: bool = True
    check_unique_headers: bool = True
    repeat_mask: bool = True          # Red-equivalent k-mer masking
    mask_kmer: int = 13               # k-mer length for repeat statistics
    mask_min_contig: int = 20_000     # redPrefilterOpts -m
    mask_gc_skew_limit: float = 0.98  # redPrefilterOpts -b
    min_period: int = 50


@dataclass
class CheckParams:
    run_check: bool = False


@dataclass
class OutgroupParams:
    """Greedy outgroup selection — config XML <outgroup> (:539-547) and
    src/cactus/progressive/outgroup.py."""
    max_num_outgroups: int = 3
    strategy: str = "greedyLeaves"
    clade_discount: float = 0.3
    overlap_penalty: float = 2.0


@dataclass
class Config:
    distance_to_add_to_root_alignment: float = 0.1
    # nested tangle refinement (phases/nested.py): after the flat
    # CAF+BAR pass, re-decompose large unaligned link interiors — the
    # one-level analog of the reference's recursive flower hierarchy
    # (cactus_consolidated.c:115-144,439-460)
    nested_refinement: bool = True
    nested_min_interior: int = 64
    nested_max_interior: int = 200_000
    nested_max_members: int = 12
    nested_max_depth: int = 3
    # per-ancestor-step retry budget on transient failures (the Toil
    # job-retry analog; checkpoint store bounds lost work to one step)
    retries: int = 1
    preprocessor: PreprocessorParams = field(default_factory=PreprocessorParams)
    blast: BlastParams = field(default_factory=BlastParams)
    caf: CafParams = field(default_factory=CafParams)
    bar: BarParams = field(default_factory=BarParams)
    reference: ReferenceParams = field(default_factory=ReferenceParams)
    check: CheckParams = field(default_factory=CheckParams)
    outgroup: OutgroupParams = field(default_factory=OutgroupParams)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def default(cls) -> "Config":
        return cls()


def _like(default, value):
    """`value` rebuilt in the container and scalar types of `default`.

    numpy arrays become lists (or tuples where the default is a tuple)
    and numpy scalars become Python scalars, so a configuration that
    went through dataclasses.asdict and numpy compares equal to one
    built here."""
    if hasattr(value, "tolist"):
        value = value.tolist()
    if isinstance(default, tuple) or (default is None
                                      and isinstance(value, tuple)):
        inner = default[0] if default else None
        return tuple(_like(inner, v) for v in value)
    if isinstance(default, list):
        inner = default[0] if default else None
        return [_like(inner, v) for v in value]
    if isinstance(default, dict):
        return {k: _like(default.get(k), v) for k, v in value.items()}
    return value


def _from_dict(cls, d: dict):
    base = cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        cur = getattr(base, f.name)
        if dataclasses.is_dataclass(cur):
            kwargs[f.name] = _from_dict(type(cur), d[f.name])
        else:
            kwargs[f.name] = _like(cur, d[f.name])
    return cls(**kwargs)


def config_from_numpy(d: dict) -> Config:
    """A Config from the `dataclasses.asdict()` form of another
    package's Config, whose leaves may be numpy arrays or lists
    (substitution matrices, gap and HMM parameters, preset tables)."""
    return _from_dict(Config, d)


def params_from_numpy(cls, d: dict):
    """An instance of the dataclass `cls` of this package (PecanParams,
    ops.pairhmm5.Hmm5Params, ...) from the `dataclasses.asdict()` form
    of another package's twin, as config_from_numpy does for a Config."""
    return _from_dict(cls, d)
