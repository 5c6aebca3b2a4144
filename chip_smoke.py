#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cactus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--dump-banded PATH] [--dump-pairhmm PATH]
                          [--dump-pairhmm5 PATH] [--dump-poa PATH]

Run from the root of a checkout on a machine with one CUDA GPU and the
CUDA toolkit.  It imports nothing of JAX or of the cactus_tpu package.
The build (1) and the phases whose readings the kernels line times (3,
4, 7 and 8) run first, one after the other, with the card to
themselves; then the others (2, 5, 6, 9, 10 and 11) run in child processes of this script
(`--phases`, CHILD_GROUPS), all at once, each group in order, and their
logs follow in that order.  The kernels line's max_abs_err also takes
the children's gaps.

1. Prints the card's name and power limit (nvidia-smi), builds every
   CUDA kernel of the port from cactus_tpu_torch/csrc/ (one nvcc per
   source, in parallel) and the native C++ host kernels.
2. Holds each kernel against its plain PyTorch version on the card:
   banded_dp at bands 128, 512, 2048 and 16384 with ragged pairs and at
   bands 8-1024 on the live-cell edge cases (m = 0, n = 0, n < m,
   |n - m| = band - 1), with max_live as the path passes it (end scores,
   end states and the live cells' direction bytes bit-equal; it logs the
   kernel each check takes, the warp kernel up to 256 live cells a row,
   and the live cells beside the band cells), the same band-512 pairs on
   both kernels (max_live 256 and 257, bit-equal to each other and to the
   plain version), banded_traceback against the host
   traceback_band (equal), pairhmm_fwd/pairhmm_bwd at bands 512 and 2048
   with pieces of up to 2048 rows (posterior max |diff| <= HMM_ATOL, logZ
   within LOGZ_RTOL, and the forward values log(fM) + lsF within FWD_LOG_ATOL
   where the plain fM is above 1e-30: the kernel rescales once per 8 rows
   and rounds its rows differently), and pairhmm5_fwd/pairhmm5_bwd at
   bands 1024, 2048 and 4096 with pieces of up to 2048 rows and at band
   16384, with max_live as the pecan path passes it (the same three
   tolerances; it logs the live cells beside the computed ones).
3. Runs the default path: the evolverMammals-scale regression of
   tests/test_evolver_gate.py (the same 5-genome tree, root_len 600 kb,
   seed 41, tree_workers=2, default Config) through the port's
   ProgressiveAligner and MAF export, holds it to the gate's accuracy
   bar (average >= 0.89, every pair recall > 0.80 and precision > 0.85)
   and checks that banded_dp, banded_traceback, pairhmm_fwd and
   pairhmm_bwd were launched.  The launch counts are set to 0 just before
   the run and read just after it.  It logs banded_dp's live cells and
   its event time by band, and its longest calls.  Then it times each
   kernel and its plain version with CUDA events on the largest inputs
   the path gave that kernel, beside the bound for the same work (for
   banded_dp also its band-cell bound and its occupancy), and replays
   every call of the path one at a time, kernel by kernel: banded_dp,
   by band and kernel, with its ops bound, its latency line (the longest
   wavefront's steps, one shuffle round and C dependent add-max pairs
   each) at its largest and its longest-row call, and the band-128 total;
   banded_traceback on each banded_dp call's outputs made again, with
   the S the path derives (each held equal to the host traceback; it
   logs the steps walked, and times its longest-walk call beside a
   latency line: the longest walk x one shared-memory step); and
   pairhmm_fwd, then pairhmm_bwd on each forward call's outputs made
   again, each call held to the plain versions as in step 2.  Each
   replay logs its total, by band, and its longest call.  The pair-HMM
   rows also log the time a row of the longest pair and a latency line:
   its rows x (2 ceil(log2 B) + ceil(log2 B) / 8) dependent steps of one
   warp-shuffle latency each.
   With --dump-banded it saves banded_dp's calls' inputs to PATH, with
   --dump-pairhmm pairhmm_fwd's.
4. Runs the pecan path (partialOrderAlignment off: the cPecan BAR engine
   with the 5-state pair-HMM) on the human-dog leaf pair of the same
   tree, seed 41: first at root_len 60 kb, held within PECAN_TOL of the
   JAX package's CPU accuracy reading there, then at 600 kb, held to the
   gate's per-pair floors (recall > 0.80, precision > 0.85).  Each run
   sets the launch counts to 0 just before it and reads them just after,
   and must have launched pairhmm5_fwd and pairhmm5_bwd; it prints the
   wall, the per-phase split, the device's peak memory, the pair-HMM
   cells (live, computed, padded) and the widest band.  Then it times the
   two 5-state kernels and their plain versions on the 600 kb run's
   largest inputs, with a latency line (the longest pair's rows x the
   dependent steps of a row, `hmm5_row_steps`), and replays the 600 kb
   run's calls as for pairhmm_fwd / pairhmm_bwd, each held to the plain
   versions with step 2's tolerances and logged with its live and
   computed cells.  With --dump-pairhmm5 it saves those calls' inputs.
5. Runs `python -m cactus_tpu_torch align` on a small two-genome seqfile
   in subprocesses, with the default config and --maf, then with a pecan
   config XML and --hal and --maf, and checks the MAFs and that the
   port's HalArchive reads the HAL back and validates it.
6. Holds the three POA kernels against their plain versions on the card,
   bit for bit (POA_SWEEP_CASES): poa_affine on bubbled DAGs with forward
   predecessors (N 64-4096, bands 64, 512, 4096 and 16384, ragged
   queries, band offsets jumping by up to 3), poa_chain on chains with
   source pad nodes (the dominant bin P 16,000 x N 64 x B 64, offsets
   stepping by 0/1, and band 16384), both on
   their live cells (real nodes v < n, columns off[v] + b <= L:
   `poa_live_equal`, ops/poa_cuda.py::live_mask), with n_nodes and
   max_live as align_bin passes them; and poa_linear up to L 2048 on
   every cell, and on the live cells of the extents poa_align passes
   (n_nodes, l_len; `poa_linear_live_equal`).
7. Runs the poa path (BAR msa_engine="poa") on the evolverMammals tree at
   600 kb, seed 41, tree_workers=2, and on a 4-leaf star tree at 200 kb,
   seed 41, each held to the gate's bar and within POA_TOL of the JAX
   package's CPU reading (tests/poa_accuracy_report.py); the first must
   launch poa_chain, the second poa_affine and poa_chain.  Each run sets
   the launch counts to 0 just before it and reads them just after, and
   prints the wall, the per-phase split, the device's peak memory, the
   problems and the cells used vs padded, the largest Nb and B, and a
   sha256 of its leaf pair sets (`leaf_pairs_digest`).  Then poa_msa
   without params (the linear-gap DP) on seeded groups must launch
   poa_linear and build the graphs the CPU run builds.  Then it times the
   three POA kernels (through their wrappers, with the path's n_nodes and
   max_live, or n_nodes and l_len) and their plain versions on the
   largest inputs their paths gave them, with a latency line (the longest
   problem's real nodes x a node's dependent steps, `poa_node_steps`),
   and replays each path's calls (kept as host copies) by bin, each
   call held to the plain version on its live cells.  With --dump-poa it
   saves those calls' inputs (poa_chain from the evolverMammals path,
   poa_affine from the star, poa_linear from poa_msa's groups).

8. Runs the wide routes (rows past each kernel's widest narrow launch:
   POA rows over 16,384 live cells, 3-state bands over 16,384, 5-state
   windows over 65,536 cells) through the entry points a user calls,
   poa_align_affine and poa_align of a 20,000-base query against a chain
   graph and a bubbled graph (poa_align's linear DP then reads DAG
   predecessors),
   posterior_pairs_banded at band 32768 and posterior_pairs_banded5 at
   max_live 70,001 and at max_live 140,001 (band 262144, past the
   131,072 cells the 5-state cluster kernels hold in shared memory),
   with the launch counts set to 0 just before and read just after; each
   must launch its wide kernels (poa_wide, poa_linear_wide,
   pairhmm_fwd_wide / pairhmm_bwd_wide, pairhmm5_fwd_wide /
   pairhmm5_bwd_wide: one thread-block cluster a pair or problem), the
   POA alignments must equal the CPU run's and the hits the plain
   posterior's.  The pair-HMMs' long pairs run under gaps that keep
   their paths in float32's range (WIDE_HMM_GAPS, WIDE_HMM5_GAPS), and
   each must have hits in both runs (the 3-state one also a plain
   posterior above 0.5 and plain forward values above 1e-30 at 90% of
   its live window's positions or more, `window_span_share`), so that
   the checks see them and not zeros.  Then it holds each wide kernel
   against its plain version at those shapes (POA bit-equal on the live
   cells, pair-HMMs by step 2's tolerances) and times it beside the
   bound for the same work (poa_wide on the chain and on the bubbled
   graph, logged apart); a direct poa_affine call on moving band offsets
   (`poa_offset_batch`: three DAGs against ~40,000-base queries at band
   32768, predecessor cells thousands of cells away) must launch
   poa_wide once and equal the plain version on the live cells.  Each
   wide line names its cluster and gives a latency line (the longest
   pair's rows or problem's nodes x the dependent steps of a cluster row
   or node, `hmm_cluster_row_steps`, `poa_cluster_node_steps`), and the
   5-state ones time the global-scratch call.
9. Runs the pangenome builder (cactus_tpu_torch.pangenome) on 4
   haplotypes of PAN_NEWICK, seed 23, in process, each run with the
   launch counts set to 0 just before it and read just after:
   `cli.main(["pangenome", ...])` in star mode at 100 kb and in sv and
   refmap modes at 20 kb, and `run_pangenome_split` on the two-chromosome
   input.  The star run must launch banded_dp and banded_traceback; each
   run logs whether pairhmm_fwd / pairhmm_bwd ran, its wall split into the
   alignment phases (AncestorStep.timings), the mapping stages and the
   graph emission's spans (normalize, VCF tiers, indexes, viz, layout;
   `Spans`), its device peak, and banded_dp's launches, live cells and
   widest band, with the vcfwave batch's band.  Recorders keep every
   banded_dp and banded_traceback call of each run, and each call is
   launched again on its inputs and held to its plain version
   (`check_banded_calls`: live cells, end scores and states, moves and
   counts equal).  Then the gfa index|vcf|viz and patch verbs on the star
   GFA, and the sv run one --stage a process, run side by side as
   `python -m cactus_tpu_torch` subprocesses.  Every file of every run
   must equal the JAX package's CPU output, pinned as sha256 digests in
   PAN_DIGESTS (`python tests/pangenome_digest_report.py` makes them);
   each 2D layout (.lay.tsv) is held instead by its layout_stress, within
   PAN_LAYOUT_RTOL of the JAX package's layout on the same draws, with
   every coordinate finite.
10. Runs the step-by-step pipeline through the port.  The masker's
   k-mer count (`kmer_counts_mask`, k 13, max_count 8, dilate 10) runs
   on one PIPE_MASK_LEN (32 Mb, cut from 64 Mb for the phase's time)
   sequence with planted repeat families, on the card and on the CPU:
   the masks must be equal; it logs both times (the device part,
   `kmer_start_mask`, by CUDA events), the masked fraction and the
   device peak.  Every other in-process run goes through `recorded_run`:
   the launch counts set to 0 just before it and read just after, and
   Recorders keeping each banded_dp and banded_traceback call (and each
   pairhmm_fwd call where the run must reach the pair-HMM), each launched
   again on its recorded inputs after the run and held to its plain
   version (`check_recorded`).  The runs: `cli.main(["preprocess",
   ...])` with --lastz-mask, --tandem-mask and --satellite softmask on
   phase 3's five genomes (every FASTA and BED equal to the JAX
   package's CPU output, pinned as sha256 digests in PIPE_DIGESTS); the
   device seed join on two related 2 Mb sequences (q + t = 4 Mb, past
   PIPE_JOIN_THRESHOLD): blast.align_contig_pair once with
   seed.device_join_threshold lowered to it, which must reach
   `_device_join_batch` once, and once with the default (the host join),
   every task's anchors equal to the host join's and the PAF records of
   the two runs equal (it logs the join's time, its device work by CUDA
   events, against the host join's, the bins and sub-batches); and
   `align --mask --maf` on phase 4's human-dog pair at 100 kb (it must
   launch pairhmm_fwd and pairhmm_bwd) and on phase 5's two-genome
   seqfile, and `blast --events a,b` in the default, --fastga and
   --minimap2 modes on the latter.  Each of these runs must launch
   banded_dp and banded_traceback.  Beside them, in `python -m cactus_tpu_torch`
   subprocesses, `prepare --script` and `sh` of the plan on the
   two-genome seqfile (every command must name cactus_tpu_torch; its
   out.maf must equal the pinned digest, its out.hal read back and
   validate in HalArchive), then `stats` on the plan's store.  Each
   output must equal its pinned digest (`python
   tests/pipeline_digest_report.py` makes them).
11. Runs the store's life through the port (`phase_store`): `align --hal`
   of phase 3's five genomes into a store, then `update add` of a sixth
   leaf under anc1, `update add --branch` of a seventh above simCow_chr6,
   `update replace` of simDog_chr6 and `update remove` of simMouse_chr6,
   each with --hal, in process through `recorded_run` (every banded_dp,
   banded_traceback and pairhmm_fwd call of the five runs held to its
   plain version after the last); after each, `hal2maf`, and the store
   (its .npz files by their arrays), the MAF and the HAL must equal the
   JAX package's CPU output,
   pinned in UPD_DIGESTS (`python tests/update_digest_report.py` makes
   them).  Then `conservation` on the updated store on the card (LRT with
   a --subtree track and --bigwig; ratio with --annotation), its neutral
   scales within UPD_SCALE_ATOL of the JAX package's (UPD_SCALES);
   phylo_fit on the card held to the port's CPU run and to the JAX
   package's scale, also on the 4d sites of a seeded annotation of
   UPD_REF; phylo_p's LRT, --subtree LRT, SCORE and ratio scores on the
   card held to the CPU's within PHAST_TOL (every
   CONSERVATION_CPU_STRIDE-th block); it logs the Felsenstein pass's time
   on the LRT grid by CUDA events and its device peak.  In a child of
   its own, on inputs of its own: two ranks
   sharing cuda:0 in a gloo group (`RANK_WORKER` subprocesses) run
   ProgressiveAligner(n_devices=2) on the five genomes at blast.chunk_size
   UPD_CHUNK (every ancestor at least 8 chunk pairs) beside the
   one-process run in this process: both ranks' MAFs must equal the
   one-process MAF, and that the pinned digest; and beside them `python
   -m cactus_tpu_torch.parallel.dryrun 1` runs in a one-rank NCCL group.

Prints one `{"kernels": [...]}` JSON line (each entry also carries the
shape it was timed at and `replayed_ms`, the path's calls of the kernel
replayed one at a time), and as its last line
`{"ok": true, "device": {...}}`.  Any failure exits non-zero without
that last line; so does a machine without CUDA, or a directory without
the cactus_tpu_torch package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT_LEN = 600_000
EVOLVER_MAMMALS_NEWICK = (
    "((simHuman_chr6:0.144018,(simMouse_chr6:0.084509,"
    "simRat_chr6:0.091589)mr:0.271974)anc1:0.020593,"
    "(simCow_chr6:0.18908,simDog_chr6:0.16303)anc2:0.032898)root;")
# the pecan path's input: the human-dog leaf pair of that tree (divergence
# ~0.36, the regime where the reference prescribes cPecan)
PECAN_NEWICK = "(simHuman_chr6:0.164611,simDog_chr6:0.195928)root;"
PECAN_SMALL_LEN = 60_000
PECAN_ROOT_LEN = 600_000
# a CPU accuracy reading of the JAX package cactus_tpu, not of this port:
# (recall, precision) of the pecan engine on PECAN_NEWICK at root_len
# 60 kb, seed 41, default Config with partialOrderAlignment off
# (`JAX_PLATFORMS=cpu python tests/pecan_accuracy_report.py 60000`)
JAX_CPU_PECAN_60K = (0.9880, 0.9841)
PECAN_TOL = 0.005
PECAN_XML = ('<cactusWorkflowConfig>\n  <bar partialOrderAlignment="0"/>\n'
             '</cactusWorkflowConfig>\n')
# the kernels the default path launches (the 5-state ones run on the
# pecan path)
DEFAULT_KERNELS = ("banded_dp", "banded_traceback", "pairhmm_fwd",
                   "pairhmm_bwd")
PECAN_KERNELS = ("pairhmm5_fwd", "pairhmm5_bwd")
# the poa path's inputs: the evolverMammals tree (every BAR end has two
# members, so only progressive round 1 runs, on chain graphs) and a
# 4-leaf star (ends of 3-4 members: rounds 2-3 align against bubbled
# graphs), with the kernels each must launch
POA_STAR_NEWICK = ("(simHuman_chr6:0.144018,simCow_chr6:0.18908,"
                   "simDog_chr6:0.16303,simMouse_chr6:0.3)root;")
POA_RUNS = {
    "mammals": (EVOLVER_MAMMALS_NEWICK, 600_000, 2, ("poa_chain",)),
    "star": (POA_STAR_NEWICK, 200_000, 1, ("poa_affine", "poa_chain")),
}
# CPU accuracy readings of the JAX package cactus_tpu, not of this port:
# the average of mean pairwise recall and precision of the poa engine on
# each input, seed 41 (`JAX_PLATFORMS=cpu python
# tests/poa_accuracy_report.py`)
JAX_CPU_POA_AVG = {"mammals": 0.9488, "star": 0.9693}
POA_TOL = 0.005
POA_GAPS = dict(o1=400, e1=30, o2=1200, e2=1)
# phase 6's POA checks (kernel, P, N, L, B), also tests/poa_sweep_report.py's
# shapes: bubbled DAGs up to N 4096 and band 16384, chains with source pad
# nodes up to the dominant bin P 16,000 x N 64 x B 64 and band 16384
POA_SWEEP_CASES = (
    ("poa_affine", 8, 64, 60, 64), ("poa_affine", 4, 512, 500, 512),
    ("poa_affine", 3, 1024, 3000, 512), ("poa_affine", 1, 4096, 3000, 4096),
    ("poa_affine", 1, 2048, 10000, 16384), ("poa_chain", 16000, 64, 63, 64),
    ("poa_chain", 64, 200, 900, 128), ("poa_chain", 4, 1024, 3000, 512),
    ("poa_chain", 1, 512, 9000, 16384))
# the longest pieces of phase 2's pair-HMM checks: 2048 rows, the rows of
# the default path's largest call (at 4096 rows these checks took 149 s
# on the H100, and the whole script with phase 11 1097 s of its 1200)
PHASE2_HMM_ROWS = 2048
# posterior tolerance: the posterior is exp(lsF + lsB - logZ), a
# difference of float32 sums of per-row log-scales that reach ~1e4 over
# 4096 rows, where one float32 ulp is ~1e-3; the kernels also sum the
# in-row chains in another order than the plain Kogge-Stone scan
HMM_ATOL = 5e-3
# the 3-state kernels' logZ against the plain version's, relative to
# max(1, |logZ|): a few float32 ulps of a log-scale sum
LOGZ_RTOL = 1e-5
# log(fM) + lsF of the 3-state forward kernel against the plain version's
# on the cells where the plain fM is above 1e-30: under 1e-3 on homologous
# pieces (ulps of lsF sums of ~1e4), 0.047 on the default path's diffuse
# (unrelated) piece, at cells of 1e-30..1e-20 of their row maximum that
# the kernel's unscaled 8-row steps pass through float32's subnormal range
FWD_LOG_ATOL = 0.1
# published H100 SXM peaks (NVIDIA data sheet): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s; int32 outside the tensor
# cores: 64 INT32 lanes per SM, half the 128 FP32 lanes behind the
# 67 TFLOP/s (which counts an FMA as 2), i.e. 16.7 TOP/s.  NVIDIA gives no
# rate for the DPX instructions: the banded DP's bound counts each as one
# int32 operation at this rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 16.7e12
# a banded traceback walk is a chain of dependent steps; from shared
# memory each step is at least one shared load (~30 cycles on Hopper, an
# assumption, not measured here) before the next address is known; the
# pair-HMM's latency line counts a warp shuffle at the same latency
SMEM_STEP_CYCLES = 30
# a dependent int32 add or max on Hopper, for the banded DP warp
# kernel's latency line (an assumption, not measured here)
INT_OP_CYCLES = 4
# the untimed phases (child_phases()), a child process a group, all
# groups at once once the timed ones are done: run one after the other
# they took 659 s of a 951 s script on an H100 80GB HBM3 at 700 W, most
# of it host work on one core each; the children must end within
# CHILD_DEADLINE_S of the build's start (the script's limit is 1200 s)
CHILD_GROUPS = (("store",), ("kernels", "poa_kernels", "cli"),
                ("pangenome", "pipeline"), ("parallel",))
CHILD_DEADLINE_S = 1140.0


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------- inputs

def mutate(rng, q, sub=0.1, indel=0.04):
    import numpy as np
    keep = rng.random(len(q)) >= indel / 2
    out = q[keep].copy()
    flip = rng.random(len(out)) < sub
    out[flip] = rng.integers(0, 4, int(flip.sum()))
    ins = np.flatnonzero(rng.random(len(out)) < indel / 2)
    return np.insert(out, ins, rng.integers(0, 4, len(ins))).astype(np.uint8)


def ragged_pairs(seed, n, lo_len, hi_len, band, sub=0.1, indel=0.04):
    """Homologous pairs of ragged lengths whose length difference fits
    the band."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < n:
        q = rng.integers(0, 4, int(rng.integers(lo_len, hi_len))) \
            .astype(np.uint8)
        t = mutate(rng, q, sub, indel)
        if abs(len(t) - len(q)) < band // 2:
            pairs.append((q, t))
    return pairs


def to_device(packed, dev):
    import torch
    return [torch.from_numpy(packed[k]).to(dev)
            for k in ("q", "t_shift", "m_len", "n_len", "lo")]


# ---------------------------------------------------------------- timing

def time_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one
    warm-up run (warmup=False: none, for plain versions that take tens of
    seconds and whose launches were warmed up before)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def replay_calls(name, calls, timed, group_of, shape_of, unit,
                 by_group=None):
    """A path's calls of one kernel again, one at a time on the idle card:
    the kernel's own time, without the other ancestor thread's work or
    host gaps inside the path's events.  timed(args, kw) does what the
    call needs first (move host copies to the card, run the kernel that
    makes its inputs) and returns the function to time; each is timed by
    time_ms with 3 launches after a warm-up.  Logs the calls, the replayed
    total, the total by group (band or bin) and the longest call with its
    shape; returns the total in ms, and fills by_group, where given, with
    {group: (ms, calls)}."""
    by_group = {} if by_group is None else by_group
    longest = (-1.0, None)
    for args, kw in calls:
        ms = time_ms(timed(args, kw), 3)
        group = group_of(args, kw)
        ms_g, n_g = by_group.get(group, (0.0, 0))
        by_group[group] = (ms_g + ms, n_g + 1)
        if ms > longest[0]:
            longest = (ms, shape_of(args, kw))
    total = sum(v[0] for v in by_group.values())
    log(f"{name}: the path's {len(calls)} calls replayed one at a time "
        f"(CUDA events, 3 launches each after a warm-up): {total:.3f} ms; "
        f"by {unit}: " + ", ".join(
            f"{g}: {ms:.3f} ms in {n} calls"
            for g, (ms, n) in sorted(by_group.items()))
        + f"; longest call {longest[0]:.3f} ms at {longest[1]}")
    return total


def traceback_cap(m_len, n_len) -> int:
    """The move capacity S that ops/banded.py::_align_pairs_cuda gives
    banded_traceback for a banded_dp call's pairs: the next power of two
    >= the longest m + n, at least 32."""
    smax = int((m_len.long() + n_len.long()).max()) if len(m_len) else 0
    return max(32, 1 << (smax - 1).bit_length())


def sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def smem_step_ns() -> tuple[float, str]:
    """One dependent shared-memory step of a traceback walk, in ns: an
    assumed SMEM_STEP_CYCLES cycles at the card's maximum SM clock (read
    with nvidia-smi).  Returns (ns, what it assumed)."""
    mhz = sm_clock_mhz()
    return (SMEM_STEP_CYCLES / mhz * 1e3,
            f"{SMEM_STEP_CYCLES} cycles at {mhz:.0f} MHz")


def banded_warp_latency(m_len, n_len, band, max_live) -> tuple[float, str]:
    """The latency line of a banded_dp launch on the warp kernel
    (max_live <= WARP_MAX_LIVE): its longest wavefront, m + lanes - 1
    steps for a pair of m rows whose rows fill `lanes` lanes of C =
    max(2, ceil(max_live / 32)) cells, each step one round of warp
    shuffles (SMEM_STEP_CYCLES) and C dependent add-max pairs on the D
    chain (INT_OP_CYCLES each op), at the card's maximum SM clock.
    Returns (ms, what it counted)."""
    C = max(2, (max_live + 31) // 32)
    width = (n_len.long() + 1).clamp(max=min(band, max_live))
    lanes = (width + C - 1) // C
    steps = int((m_len.long() + lanes - 1)[m_len > 0].max())
    cycles = SMEM_STEP_CYCLES + 2 * C * INT_OP_CYCLES
    mhz = sm_clock_mhz()
    return (steps * cycles / mhz / 1e3,
            f"{steps} steps x ({SMEM_STEP_CYCLES} + 2 x {C} x "
            f"{INT_OP_CYCLES}) cycles at {mhz:.0f} MHz")


class Recorder:
    """Stands in for a kernel wrapper during the main path: passes every
    call through to the wrapper (which counts its launch in
    cuda_build.LAUNCHES), brackets it with CUDA events on the current
    stream, and keeps the inputs of the call with the most cells, to time
    the kernel on them afterwards (cells_of None: keeps none, for a
    kernel whose inputs another kernel's replay makes again).  `attr`
    names the wrapped function where it is not the kernel's name
    (banded_dp's launch function).  keep_calls keeps every call's inputs,
    to replay them: True on the device, "host" as host copies made after
    the call's stop event, so that they add nothing to the path's device
    peak."""

    def __init__(self, module, name, cells_of, attr=None, keep_calls=False):
        self.module, self.name, self.attr = module, name, attr or name
        self.fn = getattr(module, self.attr)
        self.cells_of = cells_of
        self.keep_calls = keep_calls
        self.best = None
        self.best_cells = -1
        self.events = []
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, *args, **kw):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        stop.record()
        kept = args
        if self.keep_calls == "host":
            kept = tuple(x.cpu() if torch.is_tensor(x) else x for x in args)
        with self.lock:
            # under the lock: cells_of may add to counts that both ancestor
            # threads update
            cells = self.cells_of(args, kw) if self.cells_of else -1
            self.events.append((start, stop))
            if self.keep_calls:
                self.calls.append((kept, kw))
            if cells > self.best_cells:
                self.best_cells = cells
                self.best = (kept, kw)
        return out

    def device_ms(self) -> float:
        """Device time between the events around every call (after a
        synchronise)."""
        return sum(a.elapsed_time(b) for a, b in self.events)

    def install(self):
        setattr(self.module, self.attr, self)

    def remove(self):
        setattr(self.module, self.attr, self.fn)


# ---------------------------------------------------------------- phases

def source_digest() -> str:
    """sha256 of chip_smoke.py and of every file of cactus_tpu_torch/ but
    its build outputs, by relative path: ties a run's output to a tree."""
    paths = [os.path.join(HERE, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(HERE, "cactus_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        paths += [os.path.join(root, f) for f in files]
    digest = hashlib.sha256()
    for path in sorted(os.path.relpath(p, HERE) for p in paths):
        with open(os.path.join(HERE, path), "rb") as fh:
            digest.update(path.encode() + b"\0" + fh.read() + b"\0")
    return digest.hexdigest()


def ptxas_lines(out):
    """ptxas's register and spill lines from nvcc's -Xptxas -v output,
    each prefixed with its kernel's name and template arguments
    (pairhmm_fwd_kernel<16, 256>)."""
    import re
    kernel = "?"
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = demangle(m.group(1))
        elif "registers" in line or "spill" in line:
            yield f"{kernel}: {line.replace('ptxas info    :', '').strip()}"


def demangle(mangled):
    """The function name and integer template arguments of an Itanium
    mangled kernel name: its name is the first length-prefixed part that
    ends in _kernel."""
    import re
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]))", mangled):
        n, at = int(m.group(1)), m.start(2)
        name = mangled[at:at + n]
        if name.endswith("_kernel") and len(name) == n:
            rest = mangled[at + n:]
            targs = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
            if targs:
                vals = re.findall(r"L[ib](-?\d+)E", targs.group(1))
                return f"{name}<{', '.join(vals)}>"
            return name
    return mangled


def phase_build():
    from cactus_tpu_torch.native import build as native
    from cactus_tpu_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build()
    for name, out in logs.items():
        for line in ptxas_lines(out):
            log(f"ptxas {name}: {line}")
    cuda_s = time.time() - t0
    t0 = time.time()
    if native.load() is None:
        raise RuntimeError("native C++ host kernels did not build (g++)")
    log(f"built CUDA kernels in {cuda_s:.1f} s ({', '.join(logs) or 'cached'})"
        f", native host kernels in {time.time() - t0:.1f} s")


def edge_pairs(seed, band):
    """Short ragged pairs and the live-cell edge cases: m = 0, n = 0, both
    0, n < m, and |n - m| = band - 1 both ways (lo clamped by
    pack_band_batch)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = ragged_pairs(seed, 6, 1, 60, 2 * band)
    short = max(1, band // 4)
    return pairs + [(codes(0), codes(min(band - 1, 9))),
                    (codes(short), codes(0)), (codes(0), codes(0)),
                    (codes(short + 3), codes(short)),
                    (codes(5), codes(5 + band - 1)),
                    (codes(4 + band - 1), codes(4))]


def banded_live_equal(got, ref, m, n, lo) -> bool:
    """banded_dp's outputs against the plain version's: the direction
    bytes of the live cells, the end scores and the end states."""
    import torch
    from cactus_tpu_torch.ops import banded_cuda
    P, M, B = ref[0].shape
    live = banded_cuda.live_mask(m, n, lo, M, B)
    return (torch.equal(got[0][live], ref[0][live])
            and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]))


def check_banded(pairs, band, sub_d, dev, errs, what):
    """banded_dp, with max_live as the path passes it, against the plain
    version, and banded_traceback on its output against the host
    traceback_band."""
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda
    kw = dict(band=band, gap_open=400, gap_extend=30)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = to_device(packed, dev)
    P, M = args[0].shape
    live_w = banded_cuda.live_width(args[3], band)
    got = banded_cuda.banded_dp(*args, sub_d, **kw, max_live=live_w)
    torch.cuda.synchronize()
    ref = tb.banded_align_batch(*args, sub_d, **kw)
    if not banded_live_equal(got, ref, *args[2:]):
        raise AssertionError(f"banded_dp {what}: differs from the plain "
                             "version on the live cells")
    live = banded_cuda.live_cells(*args[2:], M, band)
    log(f"banded_dp {what} ({P} pairs x {M} rows, max_live {live_w}, the "
        f"{banded_cuda.dp_kernel(live_w)} kernel, "
        f"{banded_cuda.launch_threads(band, live_w, P)} threads): live "
        f"cells, end scores and states bit-equal; {live} live cells of "
        f"{P * M * band} band cells ({int(args[2].sum()) * band} in rows "
        f"1..m, {live / max(1, P * M * band):.1%} live)")
    errs["banded_dp"] = max(errs.get("banded_dp", 0.0), 0.0)
    dirs, _scores, end_mat = got
    S = max(32, 1 << (max(len(q) + len(t) for q, t in pairs) - 1)
            .bit_length())
    mv, ct = banded_cuda.banded_traceback(dirs, args[2], args[3], args[4],
                                          end_mat, S)
    check_traceback_plain((mv, ct), dirs, args[2], args[3], args[4],
                          end_mat, S, what)
    errs["banded_traceback"] = 0.0
    log(f"banded_traceback {what}: equal to host traceback_band "
        f"({int((ct < 0).sum())} walks left the band)")


def check_warp_vs_block(sub_d, dev):
    """The same band-512 pairs (n <= 255) through banded_dp at max_live
    256 (the warp kernel) and 257 (the block kernel): bit-equal to each
    other and to the plain version on the live cells, the end scores and
    the end states."""
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda
    band = 512
    pairs = [pr for pr in ragged_pairs(band, 24, 20, 250, band)
             if len(pr[1]) <= 255] + edge_pairs(64, 64)
    args = to_device(tb.pack_band_batch(pairs, band, min_batch=1), dev)
    kw = dict(band=band, gap_open=400, gap_extend=30)
    ref = tb.banded_align_batch(*args, sub_d, **kw)
    got = {}
    for max_live in (256, 257):
        got[max_live] = banded_cuda.banded_dp(*args, sub_d, **kw,
                                              max_live=max_live)
        if not banded_live_equal(got[max_live], ref, *args[2:]):
            raise AssertionError(f"banded_dp at max_live {max_live} differs "
                                 "from the plain version on the live cells")
    if not banded_live_equal(got[256], got[257], *args[2:]):
        raise AssertionError("banded_dp's warp and block kernels differ")
    log(f"banded_dp band {band}, {len(pairs)} pairs of n <= 255: max_live 256 "
        f"(the {banded_cuda.dp_kernel(256)} kernel) and 257 (the "
        f"{banded_cuda.dp_kernel(257)} kernel) bit-equal to each other and "
        "to the plain version on the live cells, end scores and states")


def check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, post_r, what,
              quiet=False, hold_forward=True, logZ_64=None):
    """A pair-HMM's kernels' outputs against the plain versions': every
    value finite, the posterior within HMM_ATOL, logZ within
    LOGZ_RTOL x max(1, |logZ|), and the forward values in log space,
    log(fM) + lsF, within FWD_LOG_ATOL on the cells where the plain fM is
    above 1e-30 (the value fM * exp(lsF) that both representations hold,
    whichever way a row's scale is rounded; hold_forward=False reads
    that gap without holding it).  With logZ_64, the plain steps' logZ in
    float64, logZ is held to it instead: no farther from it than the
    plain float32 logZ, LOGZ_RTOL aside (past a gap of tens of thousands
    of bases float32 sums in any order miss float64's logZ by more than
    LOGZ_RTOL).  Returns (posterior gap, forward log gap); raises on a
    failed check."""
    import torch
    for name, x in (("fM", fM), ("lsF", lsF), ("logZ", logZ),
                    ("posterior", post)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    d_post = float((post - post_r).abs().max())
    if logZ_64 is None:
        d_z = float(((logZ - logZ_r).abs()
                     / logZ_r.abs().clamp_min(1.0)).max())
        z_what = "logZ max rel diff"
    else:
        z64 = logZ_64.double()
        d_z = float((((logZ.double() - z64).abs()
                      - (logZ_r.double() - z64).abs())
                     / z64.abs().clamp_min(1.0)).max())
        z_what = ("logZ's distance to float64 past the plain version's, "
                  "relative")
    live = fM_r > 1e-30
    d_fwd = float(((torch.log(fM) + lsF[..., None])
                   - (torch.log(fM_r) + lsF_r[..., None]))[live].abs()
                  .max()) if bool(live.any()) else 0.0
    if not quiet:
        log(f"{what}: posterior max|diff| {d_post:.3g} (tolerance "
            f"{HMM_ATOL}), {z_what} {d_z:.3g} (tolerance {LOGZ_RTOL}), "
            f"log(fM) + lsF max|diff| {d_fwd:.3g} (tolerance "
            f"{FWD_LOG_ATOL}, on plain fM > 1e-30)")
    if d_post > HMM_ATOL:
        raise AssertionError(f"{what}: posterior differs by {d_post} > "
                             f"{HMM_ATOL}")
    if d_z > LOGZ_RTOL:
        raise AssertionError(f"{what}: {z_what} {d_z} > {LOGZ_RTOL}")
    if hold_forward and d_fwd > FWD_LOG_ATOL:
        raise AssertionError(f"{what}: log(fM) + lsF differs by {d_fwd} > "
                             f"{FWD_LOG_ATOL}")
    return d_post, d_fwd


def phase_kernels_vs_plain(dev, errs):
    """Every kernel against its plain version at the path's shapes."""
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, pairhmm5_cuda, pairhmm_cuda
    from cactus_tpu_torch.ops import pairhmm as tp
    from cactus_tpu_torch.ops import pairhmm5 as tp5

    sub = tb.score_matrix_6(PoaParams().sub_matrix)
    sub_d = torch.from_numpy(sub).to(dev)
    for band, n, lo_len, hi_len in ((128, 64, 20, 1000), (512, 16, 500, 4000),
                                    (2048, 4, 2000, 8000),
                                    (16384, 2, 300, 1200)):
        pairs = ragged_pairs(band, n, lo_len, hi_len, band)
        check_banded(pairs, band, sub_d, dev, errs, f"band {band}")
    for band in (8, 24, 40, 1000, 1024):
        check_banded(edge_pairs(band, band), band, sub_d, dev, errs,
                     f"band {band} edge cases")
    check_warp_vs_block(sub_d, dev)

    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions()).to(dev)
    for band in (512, 2048):
        pairs = ragged_pairs(band + 7, 4, PHASE2_HMM_ROWS // 2 + 52,
                             PHASE2_HMM_ROWS, band)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        args = to_device(packed, dev)
        hk = dict(band=band, delta=p.delta, epsilon=p.epsilon)
        fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **hk)
        post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **hk)
        torch.cuda.synchronize()
        fM_r, lsF_r, logZ_r = tp.forward_banded(*args, em, **hk)
        post_r = tp.backward_posterior(fM_r, lsF_r, logZ_r, *args, em, **hk)
        d_post, d_fwd = check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r,
                                  post_r, f"pairhmm band {band} "
                                  f"({args[0].shape[0]} pairs x "
                                  f"{args[0].shape[1]} rows)")
        errs["pairhmm_fwd"] = max(errs.get("pairhmm_fwd", 0.0), d_fwd)
        errs["pairhmm_bwd"] = max(errs.get("pairhmm_bwd", 0.0), d_post)

    # pecan pieces: a divergence-trained p_match, MUM-split pieces of up
    # to PHASE2_HMM_ROWS rows at bands 1024-4096, and band 16384
    # (use_banding off)
    p5 = tp5.Hmm5Params(p_match=0.7)
    em5 = torch.from_numpy(p5.emissions()).to(dev)
    for band, n, lo_len, hi_len in ((1024, 4, 1100, PHASE2_HMM_ROWS),
                                    (2048, 2, 1600, PHASE2_HMM_ROWS),
                                    (4096, 2, 1800, PHASE2_HMM_ROWS),
                                    (16384, 2, 600, 1000)):
        pairs = ragged_pairs(band + 11, n, lo_len, hi_len, band,
                             sub=0.2, indel=0.06)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        args = to_device(packed, dev)
        # max_live as posterior_pairs_banded5 passes it
        live_w = banded_cuda.live_width(args[3], band)
        hk = dict(band=band, params=p5)
        fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em5, **hk,
                                                   max_live=live_w)
        post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em5, **hk,
                                          max_live=live_w)
        torch.cuda.synchronize()
        fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em5, **hk)
        post_r = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em5,
                                         **hk)
        d_post, _d_fwd = check_hmm(
            fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, post_r,
            f"pairhmm5 band {band} ({args[0].shape[0]} pairs x "
            f"{args[0].shape[1]} rows, longest {int(args[2].max())})")
        log(f"pairhmm5 band {band}: {hmm5_cells_line(args, band, live_w)}; "
            f"lsF max|diff| {float((lsF - lsF_r).abs().max()):.3g}, max "
            f"posterior {float(post.max()):.4f}")
        errs["pairhmm5_fwd"] = max(errs.get("pairhmm5_fwd", 0.0),
                                   float((fM - fM_r).abs().max()))
        errs["pairhmm5_bwd"] = max(errs.get("pairhmm5_bwd", 0.0), d_post)


def phase_main_path(dev):
    """The 600 kb five-genome regression through the port."""
    import numpy as np
    import torch
    from cactus_tpu_torch import progressive
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, cuda_build, pairhmm_cuda
    from cactus_tpu_torch.phases.hal import (hal_stats, hal_validate,
                                             write_hal2maf)
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.testutil.comparator import score_pairs
    from cactus_tpu_torch.utils.trees import parse_newick

    tree = parse_newick(EVOLVER_MAMMALS_NEWICK)
    t0 = time.time()
    sim = evolver.simulate(tree, root_len=ROOT_LEN, seed=41)
    leaves = tree.leaf_names()
    genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in leaves}
    log(f"simulated 5 genomes from a {ROOT_LEN} bp root in "
        f"{time.time() - t0:.1f} s")

    def cells3(args, kw):
        q = args[0]
        return q.shape[0] * q.shape[1] * kw["band"]

    recorders = [
        # banded_dp checks max_live (a device sync) before its launch
        # function: the events bracket the launch
        Recorder(banded_cuda, "banded_dp", cells3, attr="launch_banded_dp",
                 keep_calls=True),
        # the traceback's and the backward pass's inputs are made again
        # from the banded_dp and pairhmm_fwd calls: keeping them would
        # hold every call's largest dirs / fM tensor on the card
        Recorder(banded_cuda, "banded_traceback", None),
        Recorder(pairhmm_cuda, "pairhmm_fwd", cells3, keep_calls=True),
        Recorder(pairhmm_cuda, "pairhmm_bwd", None),
    ]
    # cells of banded batches that took the native C++ route instead
    native_cells = [0]
    native_fn = tb.align_pairs_native

    def native_spy(pairs, submat, gap, band):
        native_cells[0] += sum(len(q) for q, _t in pairs) * band
        return native_fn(pairs, submat, gap, band)

    # banded_dp's cells: query rows x band, live, and P x M x band
    kernel_cells, live_cells, band_cells = [0], [0], [0]
    dp_rec = recorders[0]

    def dp_cells(args, kw):
        P, M = args[0].shape
        kernel_cells[0] += int(args[2].sum()) * kw["band"]
        live_cells[0] += banded_cuda.live_cells(*args[2:5], M, kw["band"])
        band_cells[0] += P * M * kw["band"]
        return cells3(args, kw)

    dp_rec.cells_of = dp_cells
    for rec in recorders:
        rec.install()
    tb.align_pairs_native = native_spy
    torch.cuda.reset_peak_memory_stats(dev)
    # the counts go to 0 just before the main path and are read just after
    cuda_build.reset_launches()
    t0 = time.time()
    try:
        result = progressive.ProgressiveAligner(
            tree, genomes, tree_workers=2, device=dev,
            log=lambda m: print(f"  [align] {m}", file=sys.stderr,
                                flush=True)).run()
        torch.cuda.synchronize()
    finally:
        launches = cuda_build.launches()
        for rec in recorders:
            rec.remove()
        tb.align_pairs_native = native_fn
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"main path: ProgressiveAligner.run {wall:.1f} s wall, device peak "
        f"{peak / 1e6:.0f} MB allocated, kernel launches {launches}")
    kernel_ms = {r.name: r.device_ms() for r in recorders}
    log("device time inside the kernel calls (CUDA events): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in kernel_ms.items())
        + f"; {sum(kernel_ms.values()) / 1e3 / wall:.2%} of the wall")
    for ev in ("mr", "anc2", "anc1", "root"):
        tm = result.steps[ev].timings
        log(f"  step {ev}: " + " ".join(
            f"{k}={tm[k]:.1f}s" for k in ("blast", "caf", "bar", "reference"))
            + f" device_peak={tm.get('device_peak_mb', 0):.0f}MB")
    share = kernel_cells[0] / max(1, kernel_cells[0] + native_cells[0])
    log(f"banded cells (sum of query rows x band): {kernel_cells[0]} through "
        f"banded_dp, {native_cells[0]} through native C++; kernel share "
        f"{share:.4f}")
    log(f"banded_dp on the main path: {live_cells[0]} live cells of "
        f"{band_cells[0]} band cells (P x M x band; "
        f"{live_cells[0] / max(1, band_cells[0]):.2%} live)")
    dp_calls = [(a.elapsed_time(b), list(args[0].shape), kw["band"],
                 kw["max_live"])
                for (a, b), (args, kw) in zip(dp_rec.events, dp_rec.calls)]
    by_band: dict = {}
    for ms, _shape, band, _live in dp_calls:
        ms_b, n_b = by_band.get(band, (0.0, 0))
        by_band[band] = (ms_b + ms, n_b + 1)
    log("banded_dp event time by band: " + ", ".join(
        f"{band}: {ms:.1f} ms in {n_b} calls"
        for band, (ms, n_b) in sorted(by_band.items())))
    log("longest banded_dp calls (ms [P, M] band max_live kernel): "
        + "; ".join(f"{ms:.3f} {shape} {band} {live} "
                    f"{banded_cuda.dp_kernel(live)}"
                    for ms, shape, band, live in sorted(dp_calls,
                                                        reverse=True)[:6]))
    for name in DEFAULT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if native_cells[0]:
        raise AssertionError("banded batches bypassed the CUDA kernel")

    t0 = time.time()
    recalls, precisions = [], []
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            a, b = leaves[i], leaves[j]
            s = score_pairs(sim.truth_pairs_arr(a, b),
                            progressive.leaf_pairs_arr(result, a, b))
            log(f"  {a} ~ {b}: recall {s.recall:.4f} precision "
                f"{s.precision:.4f}")
            recalls.append(s.recall)
            precisions.append(s.precision)
            if not (s.recall > 0.80 and s.precision > 0.85):
                raise AssertionError(f"pair {a}~{b} below the gate: {s}")
    avg = (float(np.mean(recalls)) + float(np.mean(precisions))) / 2
    log(f"accuracy: mean recall {np.mean(recalls):.4f}, mean precision "
        f"{np.mean(precisions):.4f}, average {avg:.4f} (gate >= 0.89)")
    if avg < 0.89:
        raise AssertionError(f"average accuracy {avg} < 0.89")
    errs = hal_validate(result)
    if errs:
        raise AssertionError("hal_validate: " + "; ".join(errs[:5]))
    rows = {r["genome"]: r for r in hal_stats(result)}
    for anc in ("mr", "anc1", "anc2", "root"):
        if not 0.8 * ROOT_LEN < rows[anc]["length"] < 1.2 * ROOT_LEN:
            raise AssertionError(f"ancestor {anc} length "
                                 f"{rows[anc]['length']} off the root scale")
    out_dir = tempfile.mkdtemp(prefix="smoke_maf_",
                               dir=os.path.join(HERE, "cactus_tpu_torch",
                                                "_build"))
    try:
        maf = os.path.join(out_dir, "evolver600k.maf")
        write_hal2maf(maf, result, None)
        size = os.path.getsize(maf)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"scored and exported the MAF ({size} bytes) in "
        f"{time.time() - t0:.1f} s")
    if size <= 0:
        raise AssertionError("empty MAF")
    return launches, {r.name: r for r in recorders}


def kernel_row(name, source, replaces, launches, errs, ms, plain_ms, bytes_,
               ops, ops_rate, shape, replayed_ms) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the memory rate and the operations over their peak rate.
    replayed_ms is the path's calls of the kernel replayed one at a time
    (`replay_calls`; None for the wide routes, whose path is phase 8's
    few calls at the timed shapes)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    out = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name], max_abs_err=errs.get(name, 0.0),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, shape=shape, replayed_ms=replayed_ms)
    log(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']})"
        + (f"; the path's calls replayed {replayed_ms:.3f} ms"
           if replayed_ms is not None else ""))
    return out


def check_traceback_plain(got, dirs, m, n, lo, end_mat, S, what):
    """banded_traceback's (moves, counts) against banded_traceback_plain
    on the same inputs (equal)."""
    import torch
    from cactus_tpu_torch.ops import banded_cuda
    mv_r, ct_r = banded_cuda.banded_traceback_plain(dirs, m, n, lo, end_mat,
                                                    S)
    if not (torch.equal(got[0], mv_r) and torch.equal(got[1], ct_r)):
        raise AssertionError(f"banded_traceback differs from the host "
                             f"traceback on {what}")


def measure(recorders, launches, errs, dev):
    """Each kernel and its plain version on the main path's largest
    inputs for it, beside the bound for the same work, and every call of
    the path replayed one at a time."""
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda, pairhmm_cuda
    from cactus_tpu_torch.ops import pairhmm as tp

    rows = []

    def row(name, source, replaces, ms, plain_ms, bytes_, ops, ops_rate,
            shape, replayed_ms):
        rows.append(kernel_row(name, source, replaces, launches, errs, ms,
                               plain_ms, bytes_, ops, ops_rate, shape,
                               replayed_ms))

    # banded_dp
    (q, t, m, n, lo, sub), kw = recorders["banded_dp"].best
    P, M = q.shape
    B = kw["band"]
    fn = recorders["banded_dp"].fn
    plain_kw = {k: v for k, v in kw.items() if k != "max_live"}
    ref = tb.banded_align_batch(q, t, m, n, lo, sub, **plain_kw)
    if not banded_live_equal(fn(q, t, m, n, lo, sub, **kw), ref, m, n, lo):
        raise AssertionError("banded_dp differs from its plain version on "
                             "the main path's inputs (live cells)")
    del ref
    ms = time_ms(lambda: fn(q, t, m, n, lo, sub, **kw), 20)
    plain_ms = time_ms(lambda: tb.banded_align_batch(q, t, m, n, lo, sub,
                                                     **plain_kw), 1)
    rows_, used = int(m.sum()), int((m > 0).sum())
    live = banded_cuda.live_cells(m, n, lo, M, B)
    max_live = kw["max_live"]
    log(f"banded_dp at [{P}, {M}, {B}]: max_live {max_live}, the "
        f"{banded_cuda.dp_kernel(max_live)} kernel, "
        f"{banded_cuda.launch_threads(B, max_live, P)} threads a block, "
        f"{banded_cuda.occupancy(B, max_live, P)} resident blocks an SM; "
        f"{live} live cells of {P * M * B} band cells ({rows_ * B} in rows "
        f"1..m)")
    # the band-cell bound: every band cell of the rows 1..m, as the
    # kernel computed them before it skipped the dead ones
    old_ops = (banded_cuda.BANDED_OPS_PER_CELL * rows_ * B
               + banded_cuda.BANDED_OPS_PER_PAIR * P)
    old_bytes = rows_ + rows_ + used * B + 12 * P + 144 + rows_ * B + 16 * P
    old_ms = max(old_ops / INT32_OPS_PER_S, old_bytes / HBM_BYTES_PER_S)
    log(f"banded_dp band-cell bound (rows 1..m x band): {old_ms * 1e3:.4f} "
        "ms")
    calls = recorders["banded_dp"].calls

    def dp_shape(a, k):
        return list(a[0].shape) + [k["band"]]

    # each call's kernel as banded_dp_launch picks it from max_live
    dp_groups: dict = {}
    dp_replayed = replay_calls(
        "banded_dp", calls, lambda a, k: (lambda: fn(*a, **k)),
        lambda a, k: (k["band"], banded_cuda.dp_kernel(k["max_live"])),
        dp_shape, "band and kernel", dp_groups)
    # the live cells: q's bases of the rows 1..m, the t_shift bytes they
    # read (columns j = 0..n), the scalars and the matrix in; a direction
    # byte a live cell and the end scores out
    t_bytes = int((n.long() + 1)[m > 0].sum())
    row("banded_dp", "cactus_tpu_torch/csrc/banded.cu",
        "cactus_tpu/ops/banded_pallas.py:44", ms, plain_ms,
        rows_ + t_bytes + 12 * P + 144 + live + 16 * P,
        banded_cuda.BANDED_OPS_PER_CELL * live
        + banded_cuda.BANDED_OPS_PER_PAIR * P, INT32_OPS_PER_S,
        [P, M, B], dp_replayed)
    # beside the ops bound: the latency line of this call and of the
    # path's longest-row call (the band-128 gap fills), and the replayed
    # band-128 total
    band128 = [v for g, v in dp_groups.items() if g[0] == 128]
    lat_ms, lat_what = (banded_warp_latency(m, n, B, max_live)
                        if banded_cuda.dp_kernel(max_live) == "warp"
                        else (None, "the block kernel"))
    log(f"banded_dp row: bound {rows[-1]['bound_ms']:.4f} ms (operations); "
        + (f"latency line {lat_ms:.4f} ms ({lat_what}), {ms / lat_ms:.2f}x; "
           if lat_ms else f"no latency line ({lat_what}); ")
        + f"band-128 calls replayed {sum(v[0] for v in band128):.3f} ms in "
        f"{sum(v[1] for v in band128)} calls")
    warp_calls = [c for c in calls
                  if banded_cuda.dp_kernel(c[1]["max_live"]) == "warp"]
    if warp_calls:
        a, k = max(warp_calls, key=lambda c: int(c[0][2].max()))
        long_ms = time_ms(lambda: fn(*a, **k), 20)
        long_rows = int(a[2].max())
        long_lat, long_what = banded_warp_latency(a[2], a[3], k["band"],
                                                  k["max_live"])
        log(f"banded_dp at the longest-row call {dp_shape(a, k)} max_live "
            f"{k['max_live']} (the warp kernel): {long_ms:.4f} ms, "
            f"{long_ms * 1e3 / long_rows:.4f} us a row of {long_rows}; "
            f"latency line {long_lat:.4f} ms ({long_what}), "
            f"{long_ms / long_lat:.2f}x")

    # banded_traceback: each call's inputs are banded_dp's outputs on the
    # same call, made again, with S as _align_pairs_cuda derives it
    tb_fn = recorders["banded_traceback"].fn
    step_ns, step_what = smem_step_ns()
    walks = []        # (longest walk, steps, shape, call index) a call

    def tb_timed(a, k):
        dirs, _s, em_ = fn(*a, **k)
        S = traceback_cap(a[2], a[3])
        got = tb_fn(dirs, a[2], a[3], a[4], em_, S)
        check_traceback_plain(got, dirs, a[2], a[3], a[4], em_, S,
                              f"the main path's call {dp_shape(a, k)}")
        ct = got[1]
        walks.append((int(ct.max()), int(ct.clamp_min(0).sum()),
                      dp_shape(a, k) + [S], len(walks)))
        return lambda: tb_fn(dirs, a[2], a[3], a[4], em_, S)

    tb_replayed = replay_calls(
        "banded_traceback", calls, tb_timed, lambda a, k: k["band"],
        lambda a, k: dp_shape(a, k) + [traceback_cap(a[2], a[3])], "band")
    log(f"banded_traceback on the main path: every replayed call equal to "
        f"the host traceback; {sum(w[1] for w in walks)} steps walked "
        f"(sum of counts) in {len(walks)} calls; "
        f"{sum(1 for w in walks if w[0] < 0)} calls with a walk past the "
        "band or S")

    def tb_measure(a, k, what):
        """(ms, plain ms, steps, longest walk, S) of one call."""
        dirs, _s, em_ = fn(*a, **k)
        S = traceback_cap(a[2], a[3])
        got = tb_fn(dirs, a[2], a[3], a[4], em_, S)
        check_traceback_plain(got, dirs, a[2], a[3], a[4], em_, S, what)
        ms = time_ms(lambda: tb_fn(dirs, a[2], a[3], a[4], em_, S), 20)
        plain_ms = time_ms(lambda: banded_cuda.banded_traceback_plain(
            dirs, a[2], a[3], a[4], em_, S), 1)
        ct = got[1]
        return ms, plain_ms, int(ct.clamp_min(0).sum()), int(ct.max()), S

    # the call with the longest walk: a walk is a chain of dependent
    # steps, so its latency line is the longest walk x one shared step
    longest = max(walks)
    a, k = calls[longest[3]]
    ms_w, plain_w, steps_w, walk_w, S_w = tb_measure(
        a, k, "the main path's longest-walk call")
    bytes_w = 2 * steps_w + 20 * a[0].shape[0]
    log(f"banded_traceback at its longest-walk call {dp_shape(a, k)} S "
        f"{S_w}: kernel {ms_w:.4f} ms, plain {plain_w:.4f} ms; longest walk "
        f"{walk_w} steps, {steps_w} steps in all; latency line {walk_w} x "
        f"{step_ns:.2f} ns = {walk_w * step_ns / 1e6:.4f} ms ({step_what}); "
        f"byte bound {bytes_w / HBM_BYTES_PER_S * 1e3:.6f} ms")
    # the table's row: banded_dp's largest call (the most dirs bytes)
    a, k = recorders["banded_dp"].best
    ms, plain_ms, steps, walk, S = tb_measure(
        a, k, "the main path's largest call")
    P = a[0].shape[0]
    log(f"banded_traceback at {dp_shape(a, k)} S {S}: longest walk {walk} "
        f"steps, latency line {walk * step_ns / 1e6:.4f} ms ({step_what})")
    # reads the walked direction bytes and the per-pair scalars, writes
    # one move byte per step and the counts
    row("banded_traceback", "cactus_tpu_torch/csrc/banded.cu",
        "cactus_tpu/ops/banded.py:303", ms, plain_ms,
        2 * steps + 20 * P, 8 * steps, INT32_OPS_PER_S,
        dp_shape(a, k) + [S], tb_replayed)

    # pairhmm_fwd / pairhmm_bwd
    args, kw = recorders["pairhmm_fwd"].best
    q, t, m, n, lo, em = args
    P, M = q.shape
    B = kw["band"]
    fwd = recorders["pairhmm_fwd"].fn
    bwd = recorders["pairhmm_bwd"].fn
    fM, lsF, logZ = fwd(*args, **kw)
    post = bwd(fM, lsF, logZ, *args, **kw)
    fM_r, lsF_r, logZ_r = tp.forward_banded(*args, **kw)
    post_r = tp.backward_posterior(fM_r, lsF_r, logZ_r, *args, **kw)
    d_post, d_fwd = check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r,
                              post_r, f"pairhmm on the main path's largest "
                              f"inputs {[P, M, B]}")
    errs["pairhmm_bwd"] = max(errs.get("pairhmm_bwd", 0.0), d_post)
    errs["pairhmm_fwd"] = max(errs.get("pairhmm_fwd", 0.0), d_fwd)
    del fM_r, lsF_r, logZ_r, post_r
    rows_, live = int(m.sum()), int((m > 0).sum())
    true_cells = rows_ * B
    # the rows the pairs use, as for banded_dp; float32 cells out (fM) and
    # in again (fM read by the backward pass, post written)
    in_bytes = rows_ + rows_ + live * B + 12 * P + 144

    def check_replayed(a, k, fM_, lsF_, logZ_, post_):
        ref = tp.forward_banded(*a, **k)
        got = check_hmm(fM_, lsF_, logZ_, post_, *ref,
                        tp.backward_posterior(*ref, *a, **k),
                        f"pairhmm replayed call {list(a[0].shape)} band "
                        f"{k['band']}", quiet=True)
        errs["pairhmm_bwd"] = max(errs["pairhmm_bwd"], got[0])
        errs["pairhmm_fwd"] = max(errs["pairhmm_fwd"], got[1])

    fwd_replayed, bwd_replayed = replay_hmm("pairhmm",
                                            recorders["pairhmm_fwd"].calls,
                                            fwd, bwd, dev, check_replayed)
    log(f"pairhmm: every replayed call within the tolerances (largest "
        f"posterior gap {errs['pairhmm_bwd']:.3g}, log(fM) + lsF gap "
        f"{errs['pairhmm_fwd']:.3g})")
    # a launch holds a few pairs whose rows depend on each other: its
    # latency line is the longest pair's rows x the dependent steps a row
    # cannot avoid (the in-row affine scan, 2 ceil(log2 B), and the band
    # maximum once per 8 rows, ceil(log2 B) / 8), one warp-shuffle
    # latency each (SMEM_STEP_CYCLES at the card's maximum SM clock)
    step_ns, step_what = smem_step_ns()
    longest = int(m.max())
    lg = max(1, (B - 1).bit_length())
    steps_row = 2 * lg + lg / 8
    latency_ms = longest * steps_row * step_ns / 1e6
    for name, ms_fn, plain_fn, bytes_, flops, replayed in (
            ("pairhmm_fwd", lambda: fwd(*args, **kw),
             lambda: tp.forward_banded(*args, **kw),
             in_bytes + 4 * true_cells + 4 * rows_ + 4 * P,
             pairhmm_cuda.PAIRHMM_FWD_FLOPS_PER_CELL, fwd_replayed),
            ("pairhmm_bwd", lambda: bwd(fM, lsF, logZ, *args, **kw),
             lambda: tp.backward_posterior(fM, lsF, logZ, *args, **kw),
             in_bytes + 4 * true_cells + 4 * rows_ + 4 * P + 4 * true_cells,
             pairhmm_cuda.PAIRHMM_BWD_FLOPS_PER_CELL, bwd_replayed)):
        ms = time_ms(ms_fn, 10)
        plain_ms = time_ms(plain_fn, 1)
        row(name, "cactus_tpu_torch/csrc/pairhmm.cu",
            "cactus_tpu/ops/pairhmm_pallas.py:"
            + ("108" if name == "pairhmm_fwd" else "183"), ms, plain_ms,
            bytes_, flops * true_cells, FP32_OPS_PER_S, [P, M, B], replayed)
        rows[-1].update(us_per_row=ms * 1e3 / longest)
        log(f"{name} at {[P, M, B]}: {ms * 1e3 / longest:.4f} us a row of "
            f"the longest pair ({longest} rows); latency line {longest} x "
            f"{steps_row:.3f} steps x {step_ns:.2f} ns = {latency_ms:.4f} ms "
            f"({step_what}), {ms / latency_ms:.2f}x; byte bound "
            f"{rows[-1]['bound_ms']:.6f} ms")
    log("no single PyTorch call computes the banded affine DP, its "
        "traceback or the pair-HMM passes: library_ms is null")
    return rows


def on_device(args, dev):
    """A kept call's arguments on the card (host copies moved back)."""
    import torch
    return tuple(x.to(dev) if torch.is_tensor(x) else x for x in args)


def replay_hmm(name, calls, fwd, bwd, dev, check=None):
    """A pair-HMM's forward calls replayed one at a time, then its
    backward passes, each on the forward pass's outputs for the same call
    made again (untimed); check(args, kw, fM, lsF, logZ, post), where
    given, holds each call's outputs to the plain versions.  Returns the
    two totals in ms."""
    def shape(a, k):
        return list(a[0].shape) + [k["band"]]

    def fwd_timed(a, k):
        a = on_device(a, dev)
        return lambda: fwd(*a, **k)

    def bwd_timed(a, k):
        a = on_device(a, dev)
        fM, lsF, logZ = fwd(*a, **k)
        if check is not None:
            check(a, k, fM, lsF, logZ, bwd(fM, lsF, logZ, *a, **k))
        return lambda: bwd(fM, lsF, logZ, *a, **k)

    group = (lambda a, k: k["band"])
    return (replay_calls(f"{name}_fwd", calls, fwd_timed, group, shape,
                         "band"),
            replay_calls(f"{name}_bwd", calls, bwd_timed, group, shape,
                         "band"))


def phase_pecan(dev):
    """The pecan path on the human-dog pair: 60 kb against the JAX
    package's CPU reading, then 600 kb against the gate's floors."""
    import torch
    from cactus_tpu_torch import progressive
    from cactus_tpu_torch.config import Config
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.ops import cuda_build, pairhmm5_cuda
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.testutil.comparator import score_pairs
    from cactus_tpu_torch.utils.trees import parse_newick

    def run(root_len):
        tree = parse_newick(PECAN_NEWICK)
        t0 = time.time()
        sim = evolver.simulate(tree, root_len=root_len, seed=41)
        a, b = tree.leaf_names()
        genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
                   for ev in (a, b)}
        log(f"pecan {root_len} bp: simulated {a} ({len(sim.genomes[a].codes)}"
            f" bp) and {b} ({len(sim.genomes[b].codes)} bp) in "
            f"{time.time() - t0:.1f} s")
        cfg = Config.default()
        cfg.bar.partial_order_alignment = False
        work = {"cells": 0, "padded": 0, "band": 0, "calls": 0, "live": 0,
                "computed": 0}
        lock = threading.Lock()

        def cells5(args, kw):
            q, m = args[0], args[2]
            live, computed, _band = hmm5_cells(args, kw["band"],
                                               kw["max_live"])
            with lock:
                work["cells"] += int(m.sum()) * kw["band"]
                work["padded"] += q.shape[0] * q.shape[1] * kw["band"]
                work["band"] = max(work["band"], kw["band"])
                work["calls"] += 1
                work["live"] += live
                work["computed"] += computed
            return q.shape[0] * q.shape[1] * kw["band"]

        # the backward pass's inputs are made again from the forward
        # calls (keeping them would hold each call's fM on the card)
        recorders = [Recorder(pairhmm5_cuda, "pairhmm5_fwd", cells5,
                              keep_calls=True),
                     Recorder(pairhmm5_cuda, "pairhmm5_bwd", None)]
        for rec in recorders:
            rec.install()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the counts go to 0 just before the path and are read just after
        cuda_build.reset_launches()
        t0 = time.time()
        try:
            result = progressive.ProgressiveAligner(
                tree, genomes, config=cfg, device=dev,
                log=lambda msg: print(f"  [pecan] {msg}", file=sys.stderr,
                                      flush=True)).run()
            torch.cuda.synchronize()
        finally:
            launches = cuda_build.launches()
            for rec in recorders:
                rec.remove()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        tm = result.steps["root"].timings
        s = score_pairs(sim.truth_pairs_arr(a, b),
                        progressive.leaf_pairs_arr(result, a, b))
        kernel_ms = {r.name: r.device_ms() for r in recorders}
        log(f"pecan {root_len} bp: ProgressiveAligner.run {wall:.1f} s wall "
            "(blast/caf/bar/reference " + "/".join(
                f"{tm[k]:.1f}" for k in ("blast", "caf", "bar", "reference"))
            + f" s), device peak {peak / 1e6:.0f} MB allocated; recall "
            f"{s.recall:.4f} precision {s.precision:.4f}")
        log(f"pecan {root_len} bp: kernel launches {launches}; 5-state "
            f"pair-HMM: {work['calls']} batches, {work['cells']} query-row x "
            f"band cells ({work['padded']} padded), {work['live']} live "
            f"cells of {work['computed']} computed, widest band "
            f"{work['band']}; device time in the calls "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in kernel_ms.items()))
        for name in PECAN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"the pecan path at {root_len} bp never "
                                     f"launched {name}")
        return launches, {r.name: r for r in recorders}, s

    _l, _r, s = run(PECAN_SMALL_LEN)
    ref_r, ref_p = JAX_CPU_PECAN_60K
    log(f"pecan {PECAN_SMALL_LEN} bp against the JAX package's CPU reading "
        f"{ref_r:.4f} / {ref_p:.4f}: recall {s.recall - ref_r:+.4f}, "
        f"precision {s.precision - ref_p:+.4f} (tolerance {PECAN_TOL})")
    if (abs(s.recall - ref_r) > PECAN_TOL
            or abs(s.precision - ref_p) > PECAN_TOL):
        raise AssertionError(f"pecan {PECAN_SMALL_LEN} bp: {s} is not within "
                             f"{PECAN_TOL} of the JAX package's CPU reading")
    launches, recorders, s = run(PECAN_ROOT_LEN)
    if not (s.recall > 0.80 and s.precision > 0.85):
        raise AssertionError(f"pecan {PECAN_ROOT_LEN} bp below the gate's "
                             f"per-pair floors: {s}")
    return launches, recorders


def hmm5_bytes(args, B):
    """Bytes a 5-state pass reads and writes for the rows the pairs use:
    q and the t_shift window of each used row, the per-pair scalars and
    the emissions in; fM (fwd out, bwd in), lsF and logZ."""
    q, m = args[0], args[2]
    P = q.shape[0]
    rows_, live = int(m.sum()), int((m > 0).sum())
    return (rows_ + rows_ + live * B + 12 * P + 144, rows_ * B,
            4 * rows_ + 4 * P)


def hmm5_cells(args, band, max_live):
    """(live cells, computed cells, band cells) of a 5-state call: the
    cells of the pairs' live windows (rows 1..m, columns 0..n), the cells
    the kernels compute (rows 1..m x the lanes' cover for this max_live)
    and the band cells of rows 1..m, which the kernels computed before
    they kept to the windows."""
    from cactus_tpu_torch.ops import banded_cuda, pairhmm5_cuda
    q, m, n, lo = args[0], args[2], args[3], args[4]
    rows = int(m.sum())
    cover = (pairhmm5_cuda.launch_threads(max_live)
             * pairhmm5_cuda.cells_per_lane(max_live))
    return (banded_cuda.live_cells(m, n, lo, q.shape[1], band), rows * cover,
            rows * band)


def hmm5_cells_line(args, band, max_live) -> str:
    from cactus_tpu_torch.ops import pairhmm5_cuda
    live, computed, band_cells = hmm5_cells(args, band, max_live)
    return (f"max_live {max_live}, {pairhmm5_cuda.launch_threads(max_live)} "
            f"threads x {pairhmm5_cuda.cells_per_lane(max_live)} cells a "
            f"lane; {live} live cells of {computed} computed ({band_cells} "
            "band cells in rows 1..m)")


def hmm5_row_steps(max_live) -> int:
    """The dependent steps a 5-state row cannot avoid, one warp-shuffle
    latency each: the lanes' affine scan (5 levels and the exclusive
    shift), the row maximum (5 levels) and the neighbour lane's cell (1);
    with several warps, the carry walk over up to nw - 1 warps' maps and
    the barrier (1)."""
    from cactus_tpu_torch.ops import pairhmm5_cuda
    nw = pairhmm5_cuda.launch_threads(max_live) // 32
    return 12 + (nw if nw > 1 else 0)


def measure_pecan(recorders, launches, errs, dev):
    """The 5-state kernels and their plain versions on the pecan path's
    largest inputs, beside the bound for the same work."""
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    from cactus_tpu_torch.ops import pairhmm5_cuda

    args, kw = recorders["pairhmm5_fwd"].best
    P, M = args[0].shape
    B = kw["band"]
    # the plain versions take no max_live
    pkw = {k: v for k, v in kw.items() if k != "max_live"}
    # the launches alone: the wrappers' max_live check reads n_len back (a
    # device sync) before each launch where max_live is below the band,
    # which would put host gaps between the timed launches
    fwd = pairhmm5_cuda.launch_pairhmm5_fwd
    bwd = pairhmm5_cuda.launch_pairhmm5_bwd
    fM, lsF, logZ = fwd(*args, **kw)
    post = bwd(fM, lsF, logZ, *args, **kw)
    # the plain versions take tens of seconds here: each is run and timed
    # once, and its output is the reference
    plain = {}
    plain_fwd_ms = time_ms(
        lambda: plain.update(f=tp5.forward_banded5(*args, **pkw)), 1,
        warmup=False)
    fM_r, lsF_r, logZ_r = plain["f"]
    plain_bwd_ms = time_ms(
        lambda: plain.update(b=tp5.backward_posterior5(fM_r, lsF_r, logZ_r,
                                                       *args, **pkw)), 1,
        warmup=False)
    d_post, _d_fwd = check_hmm(
        fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, plain["b"],
        f"pairhmm5 on the pecan path's largest inputs ({P} pairs x {M} "
        f"rows, band {B})")
    errs["pairhmm5_bwd"] = max(errs.get("pairhmm5_bwd", 0.0), d_post)
    errs["pairhmm5_fwd"] = max(errs.get("pairhmm5_fwd", 0.0),
                               float((fM - fM_r).abs().max()))
    del fM_r, lsF_r, logZ_r, post, plain

    def check_replayed(a, k, fM_, lsF_, logZ_, post_):
        pk = {x: v for x, v in k.items() if x != "max_live"}
        ref = tp5.forward_banded5(*a, **pk)
        shape = list(a[0].shape) + [k["band"]]
        got = check_hmm(fM_, lsF_, logZ_, post_, *ref,
                        tp5.backward_posterior5(*ref, *a, **pk),
                        f"pairhmm5 replayed call {shape}", quiet=True)
        errs["pairhmm5_bwd"] = max(errs["pairhmm5_bwd"], got[0])
        errs["pairhmm5_fwd"] = max(errs["pairhmm5_fwd"],
                                   float((fM_ - ref[0]).abs().max()))
        log(f"pairhmm5 replayed call {shape}: posterior gap {got[0]:.3g}, "
            f"log(fM) + lsF gap {got[1]:.3g}; "
            + hmm5_cells_line(a, k["band"], k["max_live"]))

    fwd_replayed, bwd_replayed = replay_hmm(
        "pairhmm5", recorders["pairhmm5_fwd"].calls, fwd, bwd, dev,
        check_replayed)
    log(f"pairhmm5: every replayed call within the tolerances (largest "
        f"posterior gap {errs['pairhmm5_bwd']:.3g})")
    in_bytes, cells, scal = hmm5_bytes(args, B)
    live, computed, band_cells = hmm5_cells(args, B, kw["max_live"])
    log(f"pairhmm5 at [{P}, {M}, {B}]: "
        + hmm5_cells_line(args, B, kw["max_live"]))
    # a launch's pairs run side by side; its latency line is the longest
    # pair's rows x the dependent steps of a row, one warp-shuffle latency
    # each (SMEM_STEP_CYCLES at the card's maximum SM clock)
    step_ns, step_what = smem_step_ns()
    longest = int(args[2].max())
    steps_row = hmm5_row_steps(kw["max_live"])
    latency_ms = longest * steps_row * step_ns / 1e6
    rows = []
    for name, fn, plain_ms, bytes_, flops, replayed, line in (
            ("pairhmm5_fwd", lambda: fwd(*args, **kw), plain_fwd_ms,
             in_bytes + 4 * cells + scal,
             pairhmm5_cuda.PAIRHMM5_FWD_FLOPS_PER_CELL, fwd_replayed, "56"),
            ("pairhmm5_bwd", lambda: bwd(fM, lsF, logZ, *args, **kw),
             plain_bwd_ms, in_bytes + 4 * cells + scal + 4 * cells,
             pairhmm5_cuda.PAIRHMM5_BWD_FLOPS_PER_CELL, bwd_replayed,
             "143")):
        ms = time_ms(fn, 5)
        rows.append(kernel_row(
            name, "cactus_tpu_torch/csrc/pairhmm5.cu",
            f"cactus_tpu/ops/pairhmm5_pallas.py:{line}", launches, errs, ms,
            plain_ms, bytes_, flops * live, FP32_OPS_PER_S, [P, M, B],
            replayed))
        rows[-1].update(us_per_row=ms * 1e3 / longest)
        log(f"{name} at {[P, M, B]}: {ms * 1e3 / longest:.4f} us a row of "
            f"the longest pair ({longest} rows); latency line {longest} x "
            f"{steps_row} steps x {step_ns:.2f} ns = {latency_ms:.4f} ms "
            f"({step_what}), {ms / latency_ms:.2f}x; bound "
            f"{rows[-1]['bound_ms']:.6f} ms")
    log("no single PyTorch call computes the 5-state pair-HMM passes: "
        "library_ms is null")
    return rows


# ---------------------------------------------------------------- POA

def poa_dag(rng, n, branchy=0.3, forward=2):
    """A bubbled DAG whose node order is not topological: `forward`
    predecessors point at higher indices, as add_alignment makes them."""
    import numpy as np
    bases = rng.integers(0, 4, n).astype(np.uint8)
    preds = np.full((n, 4), -1, np.int32)
    for v in range(1, n):
        preds[v, 0] = v - 1
        k = 1
        while k < 4 and v > 2 and rng.random() < branchy:
            preds[v, k] = int(rng.integers(0, v - 1))
            k += 1
    for _ in range(forward):
        v = int(rng.integers(1, n - 2))
        free = np.flatnonzero(preds[v] < 0)
        if len(free):
            preds[v, free[0]] = int(rng.integers(v + 1, n))
    return bases, preds


def poa_batch(seed, P, n, l, band, chain):
    """P problems with ragged queries (l, l-7, ...) padded to l+1 codes:
    chains followed by source pad nodes with band offsets stepping by 0
    or 1, or bubbled DAGs with offsets jumping by up to 3, where the band
    is narrower than the query."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bases = np.zeros((P, n), np.uint8)
    preds = np.full((P, n, 4), -1, np.int32)
    off = np.zeros((P, n), np.int32)
    q_ext = np.full((P, l + 1), 5, np.uint8)
    l_len = np.zeros(P, np.int32)
    for i in range(P):
        li = max(1, l - 7 * (i % 8))
        if chain:
            real = max(1, n - 5 * (i % 8))
            bases[i, :real] = rng.integers(0, 4, real)
            preds[i, 1:real, 0] = np.arange(real - 1)
        else:
            bases[i], preds[i] = poa_dag(rng, n)
        q_ext[i, 1:li + 1] = rng.integers(0, 4, li)
        l_len[i] = li
        if band < li + 1:
            steps = rng.integers(0, 2 if chain else 4, n)
            steps[0] = 0
            off[i] = np.minimum(np.cumsum(steps), li + 1 - band)
    return bases, preds, off, q_ext, l_len


def poa_offset_batch(seed, P, N, lq, band, chain, n_lo=1, jump=2500,
                     far=60, step=400):
    """P problems whose band (B < L + 1) moves with the query: ragged
    queries (problem 0 has lq bases, the others lq - 3000 .. lq) and real
    node counts (problem 0 fills the bin, the others n_lo .. N, source pad
    nodes after them).  Chains step their band offset by 0 or 1 and have
    one middle source whose offset jumps by `jump`; DAGs keep v - 1 in
    slot 0 at a step of 0, 1 or up to `step` (a few steps back by up to
    step / 8), a predecessor 2-8 nodes back in slot 1, one up to `far`
    nodes back in slot 2 and, on some nodes, a forward one (p > v, read
    as NEG rows) in slot 3, so that a predecessor cell lies up to
    thousands of cells away.  Offsets are clipped to 0 .. L + 1 - B.
    Returns (bases, preds, off, q_ext, l_len, n_nodes) numpy arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bases = np.zeros((P, N), np.uint8)
    preds = np.full((P, N, 4), -1, np.int32)
    off = np.zeros((P, N), np.int32)
    q_ext = np.full((P, lq + 1), 5, np.uint8)
    l_len = np.zeros(P, np.int32)
    n_nodes = np.zeros(P, np.int32)
    for i in range(P):
        n = N if i == 0 else int(rng.integers(n_lo, N + 1))
        li = lq if i == 0 else int(rng.integers(max(1, lq - 3000), lq + 1))
        bases[i, :n] = rng.integers(0, 4, n)
        preds[i, 1:n, 0] = np.arange(n - 1)
        cap = max(0, li + 1 - band)
        if chain:
            steps = rng.integers(0, 2, n)
            if n > 4:
                preds[i, n // 2, 0] = -1          # a middle source
                steps[n // 2] = jump
        else:
            kind = rng.random(n)
            steps = np.where(kind < 0.3, 0, np.where(
                kind < 0.5, 1, np.where(
                    kind < 0.9, rng.integers(2, step + 1, n),
                    -rng.integers(1, max(2, step // 8 + 1), n))))
            for v in range(3, n):
                preds[i, v, 1] = v - int(rng.integers(2, min(8, v) + 1))
                preds[i, v, 2] = int(rng.integers(max(0, v - far), v - 1))
                if v + 1 < n and rng.random() < 0.15:
                    preds[i, v, 3] = int(rng.integers(v + 1, n))
        steps[0] = 0
        o = np.zeros(n, np.int64)
        for v in range(1, n):
            o[v] = min(max(o[v - 1] + steps[v], 0), cap)
        off[i, :n] = o
        q_ext[i, 1:li + 1] = rng.integers(0, 4, li)
        l_len[i], n_nodes[i] = li, n
    return bases, preds, off, q_ext, l_len, n_nodes


def poa_live_equal(got, ref, off, l_len, n_nodes, band) -> bool:
    """poa_chain / poa_affine outputs (H, dirs, ends) against the plain
    version's: H and dirs on the live cells (ops/poa_cuda.py::live_mask),
    ends on the real nodes, bit-equal."""
    import torch
    from cactus_tpu_torch.ops import poa_cuda
    live = poa_cuda.live_mask(off, l_len, n_nodes, band)
    real = (torch.arange(off.shape[1], device=off.device)[None, :]
            < n_nodes.long()[:, None])
    return (torch.equal(got[0][live], ref[0][live])
            and torch.equal(got[1][live], ref[1][live])
            and torch.equal(got[2][real], ref[2][real]))


def poa_linear_live_equal(got, ref, n_nodes, l_len) -> bool:
    """poa_linear's outputs (H, dirs, ends) against the plain version's:
    H and dirs on the live cells (ops/poa_cuda.py::linear_live_mask),
    ends on the real nodes when l_len is the whole query, bit-equal."""
    import torch
    from cactus_tpu_torch.ops import poa_cuda
    N, W = ref[0].shape
    live = poa_cuda.linear_live_mask(N, W - 1, n_nodes, l_len,
                                     ref[0].device)
    return (torch.equal(got[0][live], ref[0][live])
            and torch.equal(got[1][live], ref[1][live])
            and (l_len != W - 1
                 or torch.equal(got[2][:n_nodes], ref[2][:n_nodes])))


def poa_node_steps(name, shape) -> int:
    """The dependent steps a node of poa_chain / poa_affine / poa_linear
    cannot avoid, one warp-shuffle latency each: the neighbour cells of
    the previous row (1), the team's max-scan (log2 of its lanes a warp)
    and its exclusive shift (1), the E of the cell left of each lane (1;
    not for poa_linear, whose linear gaps have no E state); with several
    warps a problem the barrier (1), or two for poa_affine, whose next
    node reads the rows the other warps wrote.  shape: the team shape
    (ops/poa_cuda.py::team_shape)."""
    import math
    _C, TL, NW = shape
    steps = (2 if name == "poa_linear" else 3) + int(math.log2(
        TL if NW == 1 else 32))
    if NW > 1:
        steps += 2 if name == "poa_affine" else 1
    return steps


def phase_poa_kernels_vs_plain(dev, errs):
    """The three POA kernels against their plain versions, bit for bit."""
    import numpy as np
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import poa_cuda
    from cactus_tpu_torch.ops import poa as tpoa

    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)
    for k, (name, P, n, l, band) in enumerate(POA_SWEEP_CASES):
        inputs = poa_batch(k, P, n, l, band, chain=name == "poa_chain")
        if poa_cuda.chain_certified(inputs[1], inputs[2]) != (
                name == "poa_chain"):
            raise AssertionError(f"{name} case {k}: wrong certificate")
        args = [torch.from_numpy(x).to(dev) for x in inputs] + [sub]
        n_nodes = poa_used(args, band)[0].int()
        max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                       n_nodes.cpu().numpy(), band)
        got = getattr(poa_cuda, name)(*args, band=band, **POA_GAPS,
                                      n_nodes=n_nodes, max_live=max_live)
        torch.cuda.synchronize()
        ref = tpoa.poa_align_scan_affine(*args, band=band, **POA_GAPS)
        if not poa_live_equal(got, ref, args[2], args[4], n_nodes, band):
            raise AssertionError(f"{name} P {P} N {n} L {l} B {band}: H, "
                                 "dirs or ends differ from the plain "
                                 "version on the live cells")
        errs[name] = 0.0
        live = int(poa_cuda.live_mask(args[2], args[4], n_nodes, band).sum())
        log(f"{name} ({P} problems x {n} nodes, L up to {l}, band {band}, "
            f"max_live {max_live}): H and dirs bit-equal on the {live} live "
            f"cells of {P * n * band}, ends on the real nodes")
    for n, l, seed in ((64, 100, 1), (1024, 2048, 2)):
        rng = np.random.default_rng(seed)
        bases, preds = poa_dag(rng, n, forward=4)
        q = rng.integers(0, 4, l).astype(np.uint8)
        args = [torch.from_numpy(x).to(dev) for x in (bases, preds, q)]
        kw = dict(gap=30, match=10, mismatch=-15)
        got = poa_cuda.poa_linear(*args, **kw)
        torch.cuda.synchronize()
        ref = tpoa.poa_align_scan(*args, **kw)
        for what, g, r in zip(("H", "dirs", "ends"), got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"poa_linear N {n} L {l}: {what} "
                                     "differs from the plain version")
        # the live extents poa_align passes: the graph's nodes and the
        # query's columns inside a padded grid
        n_live, l_live = n - 7, l - 29
        qp = args[2].clone()
        qp[l_live:] = 5
        pr = args[1].clone()
        pr[n_live:] = -1
        pr[pr >= n_live] = -1
        got = poa_cuda.poa_linear(args[0], pr, qp, **kw, n_nodes=n_live,
                                  l_len=l_live)
        ref = tpoa.poa_align_scan(args[0], pr, qp, **kw)
        if not poa_linear_live_equal(got, ref, n_live, l_live):
            raise AssertionError(f"poa_linear N {n} L {l} (n {n_live}, "
                                 f"l_len {l_live}): H or dirs differ from "
                                 "the plain version on the live cells")
        errs["poa_linear"] = 0.0
        log(f"poa_linear ({n} nodes, L {l}): H, dirs and ends bit-equal; "
            f"with n_nodes {n_live} and l_len {l_live} (team "
            f"{poa_team(poa_cuda.team_shape(l_live + 1, 'poa_linear', 1))}) "
            "H and dirs bit-equal on the live cells")


def _score_all_pairs(sim, result, leaves, what):
    """(average, recalls, precisions) over every leaf pair, each pair
    held to the gate's floors."""
    import numpy as np
    from cactus_tpu_torch import progressive
    from cactus_tpu_torch.testutil.comparator import score_pairs
    recalls, precisions = [], []
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            a, b = leaves[i], leaves[j]
            s = score_pairs(sim.truth_pairs_arr(a, b),
                            progressive.leaf_pairs_arr(result, a, b))
            log(f"  {what} {a} ~ {b}: recall {s.recall:.4f} precision "
                f"{s.precision:.4f}")
            recalls.append(s.recall)
            precisions.append(s.precision)
            if not (s.recall > 0.80 and s.precision > 0.85):
                raise AssertionError(f"{what} pair {a}~{b} below the gate: "
                                     f"{s}")
    avg = (float(np.mean(recalls)) + float(np.mean(precisions))) / 2
    return avg, recalls, precisions


def leaf_pairs_digest(result, leaves) -> str:
    """sha256 of every leaf pair's aligned position pairs (the sets the
    accuracy reading scores), in pair order: equal digests, equal
    alignments between the leaves."""
    import numpy as np
    from cactus_tpu_torch import progressive
    digest = hashlib.sha256()
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            arr = np.ascontiguousarray(progressive.leaf_pairs_arr(
                result, leaves[i], leaves[j]))
            digest.update(f"{leaves[i]}~{leaves[j]}:{arr.shape}".encode())
            digest.update(arr.tobytes())
    return digest.hexdigest()


def phase_poa(dev):
    """The poa engine on the evolverMammals tree and on the star tree."""
    import torch
    from cactus_tpu_torch import progressive
    from cactus_tpu_torch.config import Config
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.ops import cuda_build, poa_cuda
    from cactus_tpu_torch.ops import poa as tpoa
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick

    def cells_poa(args, kw):
        P, N = args[0].shape
        return P * N * kw["band"]

    all_launches, recorders = {}, {}
    for name, (nwk, root_len, workers, must) in POA_RUNS.items():
        tree = parse_newick(nwk)
        t0 = time.time()
        sim = evolver.simulate(tree, root_len=root_len, seed=41)
        leaves = tree.leaf_names()
        genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
                   for ev in leaves}
        log(f"poa {name}: simulated {len(leaves)} genomes from a {root_len} "
            f"bp root in {time.time() - t0:.1f} s")
        cfg = Config.default()
        cfg.bar.msa_engine = "poa"
        work = {"problems": 0, "used": 0, "padded": 0, "Nb": 0, "B": 0}
        lock = threading.Lock()
        prepare = tpoa._affine_prepare

        def prepare_spy(graph, seq, *a, **kw):
            out = prepare(graph, seq, *a, **kw)
            with lock:
                work["problems"] += 1
                work["used"] += out["N"] * min(out["B"], out["L"] + 1)
                work["padded"] += out["Nb"] * out["B"]
                work["Nb"] = max(work["Nb"], out["Nb"])
                work["B"] = max(work["B"], out["B"])
            return out

        # every call's inputs as host copies, for the replay
        recs = [Recorder(poa_cuda, k, cells_poa, keep_calls="host")
                for k in ("poa_chain", "poa_affine")]
        for rec in recs:
            rec.install()
        tpoa._affine_prepare = prepare_spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the counts go to 0 just before the path and are read just after
        cuda_build.reset_launches()
        t0 = time.time()
        try:
            result = progressive.ProgressiveAligner(
                tree, genomes, config=cfg, tree_workers=workers, device=dev,
                log=lambda msg: print(f"  [poa {name}] {msg}",
                                      file=sys.stderr, flush=True)).run()
            torch.cuda.synchronize()
        finally:
            launches = cuda_build.launches()
            tpoa._affine_prepare = prepare
            for rec in recs:
                rec.remove()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"poa {name}: ProgressiveAligner.run {wall:.1f} s wall, device "
            f"peak {peak / 1e6:.0f} MB allocated, kernel launches "
            f"{launches}")
        for ev, st in result.steps.items():
            tm = st.timings
            log(f"  step {ev}: " + " ".join(
                f"{k}={tm[k]:.1f}s" for k in ("blast", "caf", "bar",
                                              "reference")))
        log(f"poa {name}: {work['problems']} POA problems, "
            f"{work['used']} cells used (real nodes x min(B, L+1)) of "
            f"{work['padded']} padded (P x Nb x B, "
            f"{work['used'] / max(1, work['padded']):.1%}); largest Nb "
            f"{work['Nb']}, largest B {work['B']}; device time in the calls "
            + ", ".join(f"{r.name} {r.device_ms():.1f} ms" for r in recs))
        for k in must:
            if launches[k] <= 0:
                raise AssertionError(f"the poa {name} path never launched "
                                     f"{k}")
        avg, _r, _p = _score_all_pairs(sim, result, leaves, f"poa {name}")
        log(f"poa {name}: leaf pair sets sha256 "
            f"{leaf_pairs_digest(result, leaves)}")
        ref = JAX_CPU_POA_AVG[name]
        log(f"poa {name}: average {avg:.4f} against the JAX package's CPU "
            f"reading {ref:.4f} ({avg - ref:+.4f}, tolerance {POA_TOL}; gate "
            ">= 0.89)")
        if avg < 0.89 or abs(avg - ref) > POA_TOL:
            raise AssertionError(f"poa {name}: average {avg:.4f} is below "
                                 f"0.89 or not within {POA_TOL} of {ref}")
        # a kernel's launches and timed input come from the first run
        # that must launch it (poa_chain: the evolverMammals path)
        for rec in recs:
            if rec.name in must and rec.name not in recorders:
                all_launches[rec.name] = launches[rec.name]
                recorders[rec.name] = rec
    return all_launches, recorders


def phase_poa_linear(dev):
    """poa_msa without params (the linear-gap DP, kernel 5) on seeded
    groups of 3-6 related sequences: it must launch poa_linear and build
    the graphs the CPU run builds."""
    import numpy as np
    import torch
    from cactus_tpu_torch.ops import cuda_build, poa_cuda
    from cactus_tpu_torch.ops import poa as tpoa

    rng = np.random.default_rng(41)
    groups = []
    for _ in range(4):
        root = rng.integers(0, 4, int(rng.integers(100, 400))).astype(np.uint8)
        groups.append([mutate(rng, root, sub=0.05, indel=0.03)
                       for _m in range(int(rng.integers(3, 7)))])
    rec = Recorder(poa_cuda, "poa_linear",
                   lambda a, kw: kw["n_nodes"] * (kw["l_len"] + 1),
                   keep_calls="host")
    rec.install()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.time()
    try:
        graphs = [tpoa.poa_msa(g, device=dev) for g in groups]
        torch.cuda.synchronize()
    finally:
        launches = cuda_build.launches()
        rec.remove()
    wall = time.time() - t0
    if launches["poa_linear"] <= 0:
        raise AssertionError("poa_msa without params never launched "
                             "poa_linear")
    for g, seqs in zip(graphs, groups):
        c = tpoa.poa_msa(seqs, device="cpu")
        if not (g.bases == c.bases and g.preds == c.preds
                and g.group_of == c.group_of and len(g.walks) == len(c.walks)
                and all(np.array_equal(a, b)
                        for a, b in zip(g.walks, c.walks))):
            raise AssertionError("poa_msa on the card built another graph "
                                 "than on the CPU")
    log(f"poa_msa without params: {len(groups)} groups of "
        f"{[len(g) for g in groups]} sequences in {wall:.1f} s, "
        f"{launches['poa_linear']} poa_linear launches, graphs (bases, "
        "preds, groups, walks) identical to the CPU run's")
    return {"poa_linear": launches["poa_linear"]}, {"poa_linear": rec}


def poa_used(args, band):
    """Per problem of an affine POA launch: the real nodes (up to its
    last node with a predecessor: pad nodes are sources at the end),
    min(B, L+1) columns, and the predecessors past the first over the
    real nodes."""
    import torch
    preds, l_len = args[1], args[4]
    N = preds.shape[1]
    idx = torch.arange(N, device=preds.device)
    has = (preds >= 0).any(dim=2)
    real = torch.where(has, idx, 0).amax(dim=1) + 1
    cols = torch.clamp(l_len.long() + 1, max=band)
    extra = ((preds >= 0).sum(dim=2) - 1).clamp(min=0)
    extra = torch.where(idx[None, :] < real[:, None], extra, 0).sum(dim=1)
    return real, cols, extra


def poa_teams_by_bin(name, calls, dev) -> str:
    """The team shapes a path's calls ran, by bin, and for poa_affine
    where each bin's history rows lived (shared memory or global
    scratch)."""
    from cactus_tpu_torch.ops import poa_cuda
    seen = {}
    for a, kw in calls:
        P, N = a[0].shape
        shape = poa_cuda.team_shape(kw["max_live"], name, P)
        what = poa_team(shape)
        if name == "poa_affine":
            what += (", rows in shared memory"
                     if poa_cuda.affine_rows_in_smem(P, N, kw["max_live"],
                                                     shape, dev)
                     else ", rows in global scratch")
        seen.setdefault((N, kw["band"]), set()).add(what)
    return "; ".join(f"{k}: {' / '.join(sorted(v))}"
                     for k, v in sorted(seen.items()))


def poa_launch_kw(kw, dev):
    """A recorded poa_chain / poa_affine call's keywords for its wrapper:
    n_nodes on the card, max_live as the path passed it."""
    out = dict(kw)
    out["n_nodes"] = kw["n_nodes"].to(dev)
    return out


def poa_work(args, kw):
    """(live cells, bytes, int32 operations) of an affine POA call on its
    live cells: bases, preds, off of each real node, the query codes of
    its live columns, the lengths, n and the matrix in; H and dirs of the
    live cells and ends of the real nodes out; POA_AFFINE_OPS_PER_CELL a
    live cell plus POA_AFFINE_OPS_PER_EXTRA_PRED a further predecessor."""
    import torch
    from cactus_tpu_torch.ops import poa_cuda
    preds, off, l_len = args[1], args[2], args[4]
    n_nodes, B = kw["n_nodes"].to(off.device), kw["band"]
    P = off.shape[0]
    live = poa_cuda.live_mask(off, l_len, n_nodes, B)
    per_node = live.sum(dim=2)
    cells = int(per_node.sum())
    real = int(n_nodes.long().sum())
    cols = int(torch.clamp(l_len.long() + 1, max=B).sum())
    extra = ((preds >= 0).sum(dim=2) - 1).clamp(min=0)
    bytes_ = (real * (1 + 16 + 4 + 4) + cols + 8 * P + 144
              + cells * poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL)
    ops = (poa_cuda.POA_AFFINE_OPS_PER_CELL * cells
           + poa_cuda.POA_AFFINE_OPS_PER_EXTRA_PRED
           * int((extra * per_node).sum()))
    return cells, bytes_, ops


def poa_linear_work(preds, n_nodes: int, l_len: int):
    """(live cells, bytes, int32 operations) of a poa_linear call on its
    live cells: each real node's base and predecessor slots and the query
    codes in; H, dirs of the live cells and ends out;
    POA_LINEAR_OPS_PER_CELL a live cell plus POA_LINEAR_OPS_PER_PRED a
    used predecessor slot and live column."""
    from cactus_tpu_torch.ops import poa_cuda
    cells = n_nodes * (l_len + 1)
    slots = int((preds[:n_nodes] >= 0).sum(dim=1).clamp(min=1).sum())
    bytes_ = (n_nodes * (1 + 16) + l_len
              + cells * poa_cuda.POA_LINEAR_OUT_BYTES_PER_CELL + 4 * n_nodes)
    ops = (poa_cuda.POA_LINEAR_OPS_PER_CELL * cells
           + poa_cuda.POA_LINEAR_OPS_PER_PRED * slots * (l_len + 1))
    return cells, bytes_, ops


def poa_team(shape) -> str:
    """A team shape (ops/poa_cuda.py::team_shape), for logs."""
    C, TL, NW = shape
    return (f"{C} cells a lane x {TL} lanes" + (f" x {NW} warps" if NW > 1
                                                 else "")
            + f" (cover {C * TL * NW})")


def measure_poa(recorders, launches, errs, dev):
    """The three POA kernels and their plain versions on the largest
    inputs their paths gave them, beside the bound for the same work (on
    the live cells for poa_affine and poa_chain, with a latency line: the
    longest problem's real nodes x a node's dependent steps), and each
    path's calls replayed one at a time, by bin, each held to the plain
    version on its live cells."""
    import torch
    from cactus_tpu_torch.ops import poa as tpoa
    from cactus_tpu_torch.ops import poa_cuda

    rows = []

    def replayed(name, shape_of, timed):
        return replay_calls(name, recorders[name].calls, timed,
                            lambda a, k: tuple(shape_of(a, k)[-2:]),
                            shape_of, "bin")

    step_ns, step_what = smem_step_ns()
    for name in ("poa_affine", "poa_chain"):
        # the wrapper with the path's max_live: no device sync before its
        # launch, as on the path
        launch = getattr(poa_cuda, name)

        def timed(a, k, name=name, launch=launch):
            # each replayed call is held to the plain version first
            a = on_device(a, dev)
            k = poa_launch_kw(k, dev)
            pk = {x: v for x, v in k.items()
                  if x not in ("n_nodes", "max_live")}
            if not poa_live_equal(launch(*a, **k),
                                  tpoa.poa_align_scan_affine(*a, **pk),
                                  a[2], a[4], k["n_nodes"], k["band"]):
                raise AssertionError(f"{name} differs from its plain version "
                                     "on a replayed call's live cells")
            return lambda: launch(*a, **k)

        args, kw = recorders[name].best
        args = on_device(args, dev)
        kw = poa_launch_kw(kw, dev)
        pkw = {x: v for x, v in kw.items() if x not in ("n_nodes", "max_live")}
        P, N = args[0].shape
        B = kw["band"]
        got = launch(*args, **kw)
        plain = {}
        plain_ms = time_ms(lambda: plain.update(
            r=tpoa.poa_align_scan_affine(*args, **pkw)), 1, warmup=False)
        if not poa_live_equal(got, plain["r"], args[2], args[4],
                              kw["n_nodes"], B):
            raise AssertionError(f"{name} differs from its plain version "
                                 "on its path's largest input")
        errs[name] = 0.0
        del got, plain
        ms = time_ms(lambda: launch(*args, **kw), 10)
        cells, bytes_, ops = poa_work(args, kw)
        line = {"poa_affine": "cactus_tpu/ops/poa_pallas.py:397",
                "poa_chain": "cactus_tpu/ops/poa_pallas.py:915"}[name]
        total = replayed(name, lambda a, k: [*a[0].shape, k["band"]], timed)
        log(f"{name}: every replayed call bit-equal to the plain version on "
            "its live cells; teams by bin: " + poa_teams_by_bin(
                name, recorders[name].calls, dev))
        rows.append(kernel_row(name, "cactus_tpu_torch/csrc/poa.cu", line,
                               launches, errs, ms, plain_ms, bytes_, ops,
                               INT32_OPS_PER_S, [P, N, B], total))
        longest = int(kw["n_nodes"].max())
        shape = poa_cuda.team_shape(kw["max_live"], name, P)
        steps = poa_node_steps(name, shape)
        latency_ms = longest * steps * step_ns / 1e6
        log(f"{name} at {[P, N, B]}: max_live {kw['max_live']}, team "
            f"{poa_team(shape)}; {cells} live cells of "
            f"{P * N * B} band cells; latency line {longest} nodes x {steps} "
            f"steps x {step_ns:.2f} ns = {latency_ms:.4f} ms ({step_what}), "
            f"{ms / latency_ms:.2f}x; bound {rows[-1]['bound_ms']:.6f} ms")

    (bases, preds, q), kw = recorders["poa_linear"].best
    bases, preds, q = on_device((bases, preds, q), dev)
    fn = recorders["poa_linear"].fn
    # the plain version takes no live extents
    pkw = {x: v for x, v in kw.items() if x not in ("n_nodes", "l_len")}
    got = fn(bases, preds, q, **kw)
    plain = {}
    plain_ms = time_ms(lambda: plain.update(
        r=tpoa.poa_align_scan(bases, preds, q, **pkw)), 1, warmup=False)
    if not poa_linear_live_equal(got, plain["r"], kw["n_nodes"],
                                 kw["l_len"]):
        raise AssertionError("poa_linear differs from its plain version "
                             "on its path's largest input (live cells)")
    errs["poa_linear"] = 0.0
    ms = time_ms(lambda: fn(bases, preds, q, **kw), 20)
    N, L = kw["n_nodes"], kw["l_len"]
    cells, bytes_, ops = poa_linear_work(preds, N, L)

    def lin_timed(a, k):
        # each replayed call is held to the plain version first
        a = on_device(a, dev)
        pk = {x: v for x, v in k.items() if x not in ("n_nodes", "l_len")}
        if not poa_linear_live_equal(fn(*a, **k),
                                     tpoa.poa_align_scan(*a, **pk),
                                     k["n_nodes"], k["l_len"]):
            raise AssertionError("poa_linear differs from its plain version "
                                 "on a replayed call's live cells")
        return lambda: fn(*a, **k)

    row = kernel_row(
        "poa_linear", "cactus_tpu_torch/csrc/poa.cu",
        "cactus_tpu/ops/poa_pallas.py:42", launches, errs, ms, plain_ms,
        bytes_, ops, INT32_OPS_PER_S,
        [int(bases.shape[0]), int(q.shape[0]) + 1],
        replayed("poa_linear", lambda a, k: [a[0].shape[0],
                                             a[2].shape[0] + 1], lin_timed))
    rows.append(row)
    shape = poa_cuda.team_shape(L + 1, "poa_linear", 1)
    steps = poa_node_steps("poa_linear", shape)
    latency_ms = N * steps * step_ns / 1e6
    log(f"poa_linear: every replayed call bit-equal to the plain version on "
        f"its live cells; at [{bases.shape[0]}, {q.shape[0] + 1}] n_nodes "
        f"{N}, l_len {L}, team {poa_team(shape)}: {cells} live cells of "
        f"{bases.shape[0] * (q.shape[0] + 1)} in the grid; "
        f"{ms * 1e3 / N:.4f} us a node; latency line {N} nodes x {steps} "
        f"steps x {step_ns:.2f} ns = {latency_ms:.4f} ms ({step_what}), "
        f"{ms / latency_ms:.2f}x")
    log("no single PyTorch call computes a POA DP: library_ms is null")
    return rows


# ---------------------------------------------------------------- wide rows

# phase 8's widths, past each kernel's widest narrow launch: a POA query of
# 20,000 bases against graphs of about 60 nodes (rows of 20,001 live cells,
# band 32768), a 3-state band of 32768 and a 5-state window of 70,001
# cells (band 131072), each with a 300-base query inside the long target
WIDE_POA_L = 20000
WIDE_POA_BAND = 32768
WIDE_HMM_QUERY = 300
WIDE_HMM_BAND = 32768
WIDE_HMM_TARGET = 20000
WIDE_HMM5_BAND = 131072
WIDE_HMM5_TARGET = 70000
# the 5-state copies start 10,000 bases into their targets
WIDE_HMM5_AT = 10000
# a 64-row query copied 10,000 bases into a 140,000-base target at band
# 262144: past the 131,072 cells the 5-state cluster kernels hold in
# shared memory
WIDE_HMM5_GLOBAL_QUERY = 64
WIDE_HMM5_GLOBAL_TARGET = 140000
WIDE_HMM5_GLOBAL_BAND = 262144
# the long 5-state pairs' gap regime (Hmm5Params fields): a long gap that
# decays as 0.9999 a base, so that the copy's path stays in float32's
# range in both passes and the long pairs' posteriors reach 1 (at the
# default 0.9966 they are 0 in the plain version and the kernels alike
# once the target passes ~60,000 bases, wherever the copy sits; at
# 0.99995 float32 sums over the 140,000-base gap miss float64's logZ by
# 1e-5 relative in either order, LOGZ_RTOL itself)
WIDE_HMM5_GAPS = dict(extend_long=0.9999, switch_sl=1e-5, switch_ls=1e-5)
# the long 3-state pair's gap regime (HmmParams fields): a gap that extends
# at 0.999 a base, so that the copy's path through the 20,000-base target
# stays in float32's normal range in both passes and the long pair's
# posterior reaches 1; at the default 0.79 a 10,000-base gap costs
# 0.79^10000, the long pair's posterior is 0 in the plain version and the
# kernels alike, and its plain fM passes 1e-30 on about 1,000 of a row's
# 32,768 band cells only, so the checks would compare zeros past them
WIDE_HMM_GAPS = dict(epsilon=0.999)
WIDE_KERNELS = ("poa_wide", "poa_linear_wide", "pairhmm_fwd_wide",
                "pairhmm_bwd_wide", "pairhmm5_fwd_wide", "pairhmm5_bwd_wide")


def embedded_pair(rng, m, n, at):
    """A query of m bases and a target of n bases holding a mutated copy of
    it from position `at`."""
    import numpy as np
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = np.concatenate([rng.integers(0, 4, at).astype(np.uint8),
                        mutate(rng, q), rng.integers(0, 4, n)
                        .astype(np.uint8)])[:n]
    return q, t


def hits_agree(got, ref, what):
    """Hit lists of a pair-HMM path (kernel) against the plain
    posterior's: the same (query, target) pairs on at least 99% of the
    plain version's hits (a hit whose posterior lies within the kernels'
    tolerance of gamma may fall either side).  Logs and returns the
    agreeing share."""
    same = total = 0
    for g, r in zip(got, ref):
        gs = {(i, j) for i, j, _p in g}
        rs = {(i, j) for i, j, _p in r}
        same += len(gs & rs)
        total += max(len(gs), len(rs))
    share = same / max(1, total)
    log(f"{what}: {same} of {total} hits equal to the plain posterior's")
    if share < 0.99 or total == 0:
        raise AssertionError(f"{what}: hits agree on {share:.4f} < 0.99 of "
                             f"{total}")
    return share


def cluster_shape_of(model, max_live) -> dict:
    """The cluster a wide pair-HMM launch ("pairhmm" or "pairhmm5") takes
    for max_live."""
    from cactus_tpu_torch.ops import pairhmm5_cuda, pairhmm_cuda
    wrapper = pairhmm5_cuda if model == "pairhmm5" else pairhmm_cuda
    return wrapper.cluster_shape(max_live)


def cluster_line(max_live, model="pairhmm5") -> str:
    """The cluster a wide pair-HMM launch takes for max_live."""
    sh = cluster_shape_of(model, max_live)
    return (f"cluster of {sh['ctas']} CTAs x {sh['threads']} threads x "
            f"{sh['cells']} cells a lane, state rows in "
            + ("shared memory" if sh["smem"] else "global scratch"))


def hmm_cluster_row_steps(model, max_live) -> int:
    """The dependent steps of a row on a pair-HMM's cluster kernels, one
    warp-shuffle latency each.  5-state: the lanes' affine scan (5
    levels and the exclusive shift), warp 0's scan of the warps' maps
    (6), its walk over the CTAs before (after) it (ctas - 1), the row
    maximum over a warp and over the CTAs (5 + 5), the neighbour lane's
    cell (1) and the two block barriers and the cluster barrier (3).
    3-state: the lanes' chain scan (5 and the shift), warp 0's fold of
    the CTA's nw warp totals (nw), each thread's fold of the totals of
    the CTAs and warps before (after) it (ctas - 1 + nw - 1), and the
    block barrier and the cluster barrier (2); its row maxima wait for
    the step's end, off the chain."""
    sh = cluster_shape_of(model, max_live)
    if model == "pairhmm5":
        return 25 + sh["ctas"]
    return 6 + 2 * (sh["threads"] // 32) + sh["ctas"]


def window_span_share(fM_r, live) -> float:
    """The share of a pair's window positions (cell k = j - jlo(i) of a
    row's live window, `live` the pair's (M, B) mask) at which its plain
    fM passes 1e-30 in some row: how much of the window, and so of the
    cluster's CTAs, a forward check on those cells reaches."""
    import torch
    on = (fM_r > 1e-30) & live
    b = torch.arange(live.shape[1], device=live.device)
    first = torch.where(live, b, live.shape[1]).amin(1, keepdim=True)
    k = (b[None, :] - first)[on]
    width = int(live.sum(1).max())
    return torch.unique(k).numel() / max(1, width)


def long_pair_seen(what, hits, ref_hits, post_r, fM_r, live) -> float:
    """A wide-route check must see its long pair, not zeros: hits in the
    kernels' run and in the plain one, the plain posterior's maximum
    above 0.5 and plain fM above 1e-30 at 90% of the positions of the
    pair's live window or more (`window_span_share`).  Logs and returns
    that share."""
    share = window_span_share(fM_r, live)
    top = float(post_r.max())
    log(f"{what}: {len(hits)} hits, the plain posterior {len(ref_hits)} "
        f"(its maximum {top:.4f}); plain fM above 1e-30 at "
        f"{share:.4f} of the live window's positions")
    if not (hits and ref_hits) or top <= 0.5 or share < 0.9:
        raise AssertionError(f"{what}: the check does not see the long pair "
                             f"({len(hits)} / {len(ref_hits)} hits, plain "
                             f"posterior maximum {top}, window share "
                             f"{share:.4f})")
    return share


def wide_hmm5_global(call, timed):
    """Times phase 8's 5-state call past the cluster's shared-memory cover
    (held to the plain versions with the path's other calls) and logs it
    beside its plain versions' times."""
    if call is None:
        raise AssertionError("phase 8: no 5-state call took the cluster "
                             "kernels' global-scratch instance")
    args, kw, plain_f, plain_b = call
    P, M = args[0].shape
    longest = int(args[2].max())
    fM, lsF, logZ = timed[0](*args, **kw)
    ms_f = time_ms(lambda: timed[0](*args, **kw), 3)
    ms_b = time_ms(lambda: timed[1](fM, lsF, logZ, *args, **kw), 3)
    log(f"pairhmm5 wide route past the shared-memory cover at "
        f"{[P, M, kw['band']]}, max_live {kw['max_live']} "
        f"({cluster_line(kw['max_live'])}): fwd {ms_f:.3f} ms, bwd "
        f"{ms_b:.3f} ms ({ms_f * 1e3 / longest:.2f} / "
        f"{ms_b * 1e3 / longest:.2f} us a row of {longest}); plain "
        f"{plain_f:.1f} / {plain_b:.1f} ms")


# phase 8's direct poa_affine call where the band moves (B < L + 1): three
# bubbled DAGs of up to 64 nodes against queries of about 40,000 bases at
# band 32768, predecessor cells up to thousands of cells away
# (`poa_offset_batch`)
WIDE_POA_OFFSET_L = 40000
WIDE_POA_OFFSET_SEED = 173


def wide_poa_offsets(dev):
    """Phase 8's direct poa_affine call on moving band offsets
    (`poa_offset_batch`): it must take the wide route, launch poa_wide
    once and equal the plain version on the live cells; logs its time."""
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import cuda_build, poa_cuda
    from cactus_tpu_torch.ops import poa as tpoa
    inputs = poa_offset_batch(WIDE_POA_OFFSET_SEED, 3, 64, WIDE_POA_OFFSET_L,
                              WIDE_POA_BAND, chain=False, n_lo=40)
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], WIDE_POA_BAND)
    if poa_cuda.poa_route(max_live) != "wide":
        raise AssertionError("phase 8: the offset call is not on the wide "
                             "route")
    a = [torch.from_numpy(x).to(dev) for x in inputs]
    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)
    kw = dict(band=WIDE_POA_BAND, **POA_GAPS)
    n0 = cuda_build.launches()["poa_wide"]
    got = poa_cuda.poa_affine(*a[:5], sub, **kw, n_nodes=a[5],
                              max_live=max_live)
    torch.cuda.synchronize()
    if cuda_build.launches()["poa_wide"] != n0 + 1:
        raise AssertionError("phase 8: the offset call did not launch "
                             "poa_wide once")
    plain = {}
    plain_ms = time_ms(lambda: plain.update(r=tpoa.poa_align_scan_affine(
        *a[:5], sub, **kw)), 1, warmup=False)
    if not poa_live_equal(got, plain["r"], a[2], a[4], a[5], WIDE_POA_BAND):
        raise AssertionError("phase 8: poa_affine on moving band offsets "
                             "differs from the plain version on the live "
                             "cells")
    del got, plain
    ms = time_ms(lambda: poa_cuda.poa_affine(
        *a[:5], sub, **kw, n_nodes=a[5], max_live=max_live), 3)
    longest = int(inputs[5].max())
    log(f"phase 8: poa_affine on moving band offsets at "
        f"{[*inputs[0].shape, WIDE_POA_BAND]} (queries "
        f"{inputs[4].tolist()}, n_nodes {inputs[5].tolist()}, max_live "
        f"{max_live}, {poa_cluster_line(max_live)}, DAG predecessors up to "
        f"{poa_max_shift(inputs)} cells away): bit-equal to the plain "
        f"version on the live cells; {ms:.4f} ms, {ms * 1e3 / longest:.2f} "
        f"us a node; plain {plain_ms:.1f} ms")


def poa_max_shift(inputs) -> int:
    """The largest |off[v] - off[p]| over the real nodes' predecessors
    p < v of a poa_offset_batch."""
    _b, preds, off, _q, _l, n_nodes = inputs
    return max((abs(int(off[p, v]) - int(off[p, u]))
                for p in range(off.shape[0]) for v in range(int(n_nodes[p]))
                for u in preds[p, v] if 0 <= u < v), default=0)


WIDE_SEED = 88


def wide_poa_inputs(rng):
    """Phase 8's POA inputs, the first draws of rng (WIDE_SEED): a chain
    graph of 60 bases, a bubbled graph of it and a mutated copy (the poa
    engine's poa_msa on the CPU), and a WIDE_POA_L-base query holding a
    mutated copy 9,000 bases in."""
    import numpy as np
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import poa as tpoa
    seed60 = rng.integers(0, 4, 60).astype(np.uint8)
    chain_g = tpoa.PoaGraph.from_sequence(seed60)
    bub_g = tpoa.poa_msa([seed60, mutate(rng, seed60, sub=0.15, indel=0.1)],
                         params=PoaParams(), device="cpu")
    if max(len(ps) for ps in bub_g.preds) < 2:
        raise AssertionError("phase 8: the bubbled graph has no bubble")
    query = np.concatenate([rng.integers(0, 4, 9000).astype(np.uint8),
                            mutate(rng, seed60),
                            rng.integers(0, 4, WIDE_POA_L).astype(np.uint8)]
                           )[:WIDE_POA_L]
    return chain_g, bub_g, query


def poa_cluster_line(max_live, linear=False) -> str:
    """The cluster a wide POA launch takes for max_live, for logs."""
    from cactus_tpu_torch.ops import poa_cuda
    sh = poa_cuda.cluster_shape(max_live, linear=linear)
    return (f"cluster of {sh['ctas']} CTAs x {sh['threads']} threads x "
            f"{sh['cells']} cells a lane, the cells in "
            + ("registers" if sh["registers"] else "global scratch"))


def poa_cluster_node_steps(max_live, linear=False) -> int:
    """The dependent steps of a node on a POA cluster kernel, one
    warp-shuffle latency each: the previous row's neighbour cells (1),
    the lanes' max-scan (5 levels) and its exclusive shift (1), the block
    barrier (1), warp 0's fold of its CTA's warp totals (5) and its push
    (1), the cluster barrier (1), each thread's walk over the totals of
    the CTAs and warps before it (ctas - 1 + warps - 1), and for the
    affine kernel the E of the cell left of each lane (1).  A DAG's round
    of history loads is not counted."""
    from cactus_tpu_torch.ops import poa_cuda
    sh = poa_cuda.cluster_shape(max_live, linear=linear)
    return (15 + (0 if linear else 1) + sh["ctas"] - 1
            + sh["threads"] // 32 - 1)


def phase_wide(dev, errs):
    """Phase 8, the wide routes (widths past each kernel's widest narrow
    launch).  The path: the entry points a user calls, at those widths,
    with the launch counts set to 0 just before and read just after:
    poa_align_affine of a 20,000-base query against a chain graph and a
    bubbled graph (poa_chain's and poa_affine's wide route, poa_wide),
    poa_align (poa_linear_wide), posterior_pairs_banded at band 32768 and
    posterior_pairs_banded5 at band 131072 (max_live 70,001) and band
    262144 (max_live 140,001, the cluster kernels' global-scratch
    instance); each must
    launch its wide kernels, the POA traceback ops must equal the CPU
    run's, and the hits the plain posterior's (`hits_agree`).  Recorders
    keep every call the path makes of the kernels' wrappers; each
    recorded call, on either route, is then held to its plain version on
    the same inputs (POA bit-equal on the live cells, pair-HMMs by
    check_hmm), and the largest wide call of each kernel is timed with
    CUDA events beside the bound for the same work.  Returns the
    kernels-line rows."""
    import numpy as np
    import torch
    from cactus_tpu_torch.ops import banded_cuda, cuda_build, pairhmm5_cuda
    from cactus_tpu_torch.ops import pairhmm_cuda, poa_cuda
    from cactus_tpu_torch.ops import pairhmm as tp
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    from cactus_tpu_torch.ops import poa as tpoa

    rng = np.random.default_rng(WIDE_SEED)
    chain_g, bub_g, query = wide_poa_inputs(rng)
    pairs3 = [embedded_pair(rng, WIDE_HMM_QUERY, WIDE_HMM_TARGET,
                            WIDE_HMM_TARGET // 2)]
    pairs3 += ragged_pairs(3, 1, 200, 260, WIDE_HMM_BAND)
    pairs5 = [embedded_pair(rng, WIDE_HMM_QUERY, WIDE_HMM5_TARGET,
                            WIDE_HMM5_AT)]
    pairs5 += ragged_pairs(5, 1, 100, 140, WIDE_HMM5_BAND)
    pairs5g = [embedded_pair(rng, WIDE_HMM5_GLOBAL_QUERY,
                             WIDE_HMM5_GLOBAL_TARGET, WIDE_HMM5_AT)]
    pairs5g += ragged_pairs(7, 1, 40, 64, WIDE_HMM5_GLOBAL_BAND)
    hp = tp.HmmParams(**WIDE_HMM_GAPS)
    hp5 = tp5.Hmm5Params(p_match=0.8, **WIDE_HMM5_GAPS)

    def grid_cells(a, k):
        return a[0].shape[0] * a[0].shape[1] * k["band"]

    recs = {
        "pairhmm": Recorder(pairhmm_cuda, "pairhmm_fwd", grid_cells,
                            keep_calls=True),
        "pairhmm5": Recorder(pairhmm5_cuda, "pairhmm5_fwd", grid_cells,
                             keep_calls=True),
        **{k: Recorder(poa_cuda, k, grid_cells, keep_calls="host")
           for k in ("poa_chain", "poa_affine")},
        "poa_linear": Recorder(poa_cuda, "poa_linear",
                               lambda a, k: k["n_nodes"] * (k["l_len"] + 1),
                               keep_calls="host")}
    for rec in recs.values():
        rec.install()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.time()
    try:
        ops = [tpoa.poa_align_affine(g, query, device=dev)
               for g in (chain_g, bub_g)]
        ops += [tpoa.poa_align(g, query, device=dev)
                for g in (chain_g, bub_g)]
        hits3 = tp.posterior_pairs_banded(pairs3, hp, band=WIDE_HMM_BAND,
                                          device=dev)
        hits5 = tp5.posterior_pairs_banded5(pairs5, hp5,
                                            band=WIDE_HMM5_BAND, device=dev)
        hits5g = tp5.posterior_pairs_banded5(
            pairs5g, hp5, band=WIDE_HMM5_GLOBAL_BAND, device=dev)
        torch.cuda.synchronize()
    finally:
        launches = cuda_build.launches()
        for rec in recs.values():
            rec.remove()
    wall = time.time() - t0
    log(f"phase 8 path (the wide routes through their entry points): "
        f"{wall:.1f} s, launches " + ", ".join(
            f"{k} {launches[k]}" for k in WIDE_KERNELS))
    for name in WIDE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"phase 8 never launched {name}")
    ref_ops = [tpoa.poa_align_affine(g, query, device="cpu")
               for g in (chain_g, bub_g)]
    ref_ops += [tpoa.poa_align(g, query, device="cpu")
                for g in (chain_g, bub_g)]
    if ops != ref_ops:
        raise AssertionError("phase 8: a wide POA alignment differs from "
                             "the CPU run's")
    log("phase 8: poa_align_affine and poa_align (chain and bubbled graph) "
        f"of a {WIDE_POA_L}-base query: traceback ops equal to the CPU run's")

    def plain_hits(pairs, band, plain, pack_kw):
        packed, t = tp.pack_to_device(pairs, band, dev, **pack_kw)
        return tp.banded_hits(plain(t), pairs, packed["lo"], 0.5)

    def plain5(band):
        def run(t):
            kw = dict(band=band, params=hp5)
            em = torch.from_numpy(hp5.emissions()).to(dev)
            return tp5.backward_posterior5(
                *tp5.forward_banded5(*t, em, **kw), *t, em, **kw)
        return run

    # the 3-state pairs' plain versions, batched as the path batches them
    packed3, t3 = tp.pack_to_device(pairs3, WIDE_HMM_BAND, dev, min_batch=8,
                                    min_rows=256)
    kw3 = dict(band=WIDE_HMM_BAND, delta=hp.delta, epsilon=hp.epsilon)
    em3 = torch.from_numpy(hp.emissions()).to(dev)
    fwd3 = tp.forward_banded(*t3, em3, **kw3)
    post3 = tp.backward_posterior(*fwd3, *t3, em3, **kw3)
    ref3 = tp.banded_hits(post3, pairs3, packed3["lo"], 0.5)
    hits_agree(hits3, ref3, f"posterior_pairs_banded at band {WIDE_HMM_BAND}")
    live3 = banded_cuda.live_mask(*t3[2:5], t3[0].shape[1], WIDE_HMM_BAND)
    long_pair_seen(f"phase 8: the {WIDE_HMM_TARGET}-base 3-state pair at "
                   f"band {WIDE_HMM_BAND}", hits3[0], ref3[0], post3[0],
                   fwd3[0][0], live3[0])
    del fwd3, post3, live3
    for hits, pairs, band in ((hits5, pairs5, WIDE_HMM5_BAND),
                              (hits5g, pairs5g, WIDE_HMM5_GLOBAL_BAND)):
        ref = plain_hits(pairs, band, plain5(band), {})
        hits_agree(hits, ref, f"posterior_pairs_banded5 at band {band}")
        # the check must see the long pair's posterior, not zeros
        for k, (_q, t) in enumerate(pairs):
            if len(t) > pairhmm5_cuda.PAIRHMM5_MAX_CELLS:
                log(f"phase 8: the {len(t)}-base pair at band {band}: "
                    f"{len(hits[k])} hits, the plain posterior "
                    f"{len(ref[k])}")
                if not (hits[k] and ref[k]):
                    raise AssertionError(
                        f"phase 8: the {len(t)}-base pair at band {band} "
                        "has no hit")

    rows = []
    # poa_wide: the path's poa_chain and poa_affine calls (one problem of
    # about 60 nodes and a 20,000-base query each, band 32768)
    best = None
    for name in ("poa_chain", "poa_affine"):
        launch = recs[name].fn
        for a, k in recs[name].calls:
            a = on_device(a, dev)
            k = poa_launch_kw(k, dev)
            pk = {x: v for x, v in k.items()
                  if x not in ("n_nodes", "max_live")}
            route = poa_cuda.poa_route(k["max_live"])
            got = launch(*a, **k)
            plain = {}
            plain_ms = time_ms(lambda: plain.update(
                r=tpoa.poa_align_scan_affine(*a, **pk)), 1, warmup=False)
            if not poa_live_equal(got, plain["r"], a[2], a[4], k["n_nodes"],
                                  k["band"]):
                raise AssertionError(f"phase 8: {name} ({route} route) "
                                     "differs from the plain version on a "
                                     "path call's live cells")
            del got, plain
            cells = poa_work(a, k)[0]
            log(f"phase 8: {name} path call at {[*a[0].shape, k['band']]}, "
                f"max_live {k['max_live']} ({route} route): bit-equal to the "
                f"plain version on its {cells} live cells")
            if route == "wide":
                ms = time_ms(lambda: launch(*a, **k), 3)
                longest = int(k["n_nodes"].max())
                graph = "chain" if name == "poa_chain" else "DAG"
                log(f"poa_wide as {name} ({graph} graph) at "
                    f"{[*a[0].shape, k['band']]}, max_live "
                    f"{k['max_live']} ({poa_cluster_line(k['max_live'])}): "
                    f"{ms:.4f} ms, {ms * 1e3 / longest:.2f} us a node "
                    f"({longest} nodes); plain {plain_ms:.1f} ms")
                if best is None or cells > best[0]:
                    best = (cells, name, a, k, plain_ms)
    if best is None:
        raise AssertionError("phase 8: no POA affine call on the wide route")
    wide_poa_offsets(dev)
    errs["poa_wide"] = 0.0
    _cells, name, args, kw, plain_ms = best
    launch = getattr(poa_cuda, name)
    ms = time_ms(lambda: launch(*args, **kw), 3)
    cells, bytes_, ops_ = poa_work(args, kw)
    P, N = args[0].shape
    longest = int(kw["n_nodes"].max())
    log(f"poa_wide as {name} at {[P, N, kw['band']]}, max_live "
        f"{kw['max_live']}: {ms * 1e3 / longest:.2f} us a node of the "
        f"longest problem ({longest} nodes)")
    step_ns, step_what = smem_step_ns()
    steps = poa_cluster_node_steps(kw["max_live"])
    latency_ms = longest * steps * step_ns / 1e6
    log(f"poa_wide: {poa_cluster_line(kw['max_live'])}; latency line "
        f"{longest} x {steps} steps x {step_ns:.2f} ns = {latency_ms:.4f} ms "
        f"({step_what}), {ms / latency_ms:.2f}x")
    rows.append(kernel_row(
        "poa_wide", "cactus_tpu_torch/csrc/poa_cluster.cu",
        {"poa_affine": "cactus_tpu/ops/poa_pallas.py:397",
         "poa_chain": "cactus_tpu/ops/poa_pallas.py:915"}[name], launches,
        errs, ms, plain_ms, bytes_, ops_, INT32_OPS_PER_S,
        [P, N, kw["band"]], None))

    # poa_linear_wide: poa_align's call (the query padded to a power of
    # two, the live extents n_nodes and l_len)
    best = None
    launch = recs["poa_linear"].fn
    for a, k in recs["poa_linear"].calls:
        a = on_device(a, dev)
        pk = {x: v for x, v in k.items() if x not in ("n_nodes", "l_len")}
        route = poa_cuda.poa_route(k["l_len"] + 1)
        got = launch(*a, **k)
        plain = {}
        plain_ms = time_ms(lambda: plain.update(
            r=tpoa.poa_align_scan(*a, **pk)), 1, warmup=False)
        if not poa_linear_live_equal(got, plain["r"], k["n_nodes"],
                                     k["l_len"]):
            raise AssertionError(f"phase 8: poa_linear ({route} route) "
                                 "differs from the plain version on a path "
                                 "call's live cells")
        del got, plain
        log(f"phase 8: poa_linear path call at [{a[0].shape[0]}, "
            f"{a[2].shape[0] + 1}], n_nodes {k['n_nodes']}, l_len "
            f"{k['l_len']} ({route} route): bit-equal to the plain version "
            "on the live cells")
        cells = k["n_nodes"] * (k["l_len"] + 1)
        if route == "wide" and (best is None or cells > best[0]):
            best = (cells, a, k, plain_ms)
    if best is None:
        raise AssertionError("phase 8: no poa_linear call on the wide route")
    errs["poa_linear_wide"] = 0.0
    _cells, args, kw, plain_ms = best
    ms = time_ms(lambda: launch(*args, **kw), 3)
    n, L = kw["n_nodes"], kw["l_len"]
    cells, bytes_, ops_ = poa_linear_work(args[1], n, L)
    shape = [int(args[0].shape[0]), int(args[2].shape[0]) + 1]
    log(f"poa_linear_wide at {shape}, n_nodes {n}, l_len {L}: {cells} live "
        f"cells; {ms * 1e3 / n:.2f} us a node")
    steps = poa_cluster_node_steps(L + 1, linear=True)
    latency_ms = n * steps * step_ns / 1e6
    log(f"poa_linear_wide: {poa_cluster_line(L + 1, linear=True)}; latency "
        f"line {n} x {steps} steps x {step_ns:.2f} ns = {latency_ms:.4f} ms "
        f"({step_what}), {ms / latency_ms:.2f}x")
    rows.append(kernel_row(
        "poa_linear_wide", "cactus_tpu_torch/csrc/poa_cluster.cu",
        "cactus_tpu/ops/poa_pallas.py:42", launches, errs, ms, plain_ms,
        bytes_, ops_, INT32_OPS_PER_S, shape, None))

    # the pair-HMMs: every forward call of the path, its backward pass on
    # the kernel's own forward outputs, against the plain versions; the
    # 5-state kernels are timed through their launch functions, which
    # take the path's max_live without checking it again (a device sync)
    for model, route_of, bwd, timed, pf, pb, flops, lines in (
            ("pairhmm", lambda k: pairhmm_cuda.pairhmm_route(k["band"]),
             pairhmm_cuda.pairhmm_bwd,
             (pairhmm_cuda.launch_pairhmm_fwd,
              pairhmm_cuda.launch_pairhmm_bwd),
             tp.forward_banded,
             tp.backward_posterior,
             (pairhmm_cuda.PAIRHMM_FWD_FLOPS_PER_CELL,
              pairhmm_cuda.PAIRHMM_BWD_FLOPS_PER_CELL),
             ("cactus_tpu/ops/pairhmm_pallas.py:108",
              "cactus_tpu/ops/pairhmm_pallas.py:183")),
            ("pairhmm5", lambda k: pairhmm5_cuda.pairhmm5_route(
                k["max_live"]),
             pairhmm5_cuda.pairhmm5_bwd,
             (pairhmm5_cuda.launch_pairhmm5_fwd,
              pairhmm5_cuda.launch_pairhmm5_bwd),
             tp5.forward_banded5,
             tp5.backward_posterior5,
             (pairhmm5_cuda.PAIRHMM5_FWD_FLOPS_PER_CELL,
              pairhmm5_cuda.PAIRHMM5_BWD_FLOPS_PER_CELL),
             ("cactus_tpu/ops/pairhmm5_pallas.py:56",
              "cactus_tpu/ops/pairhmm5_pallas.py:143"))):
        fwd = recs[model].fn
        best, gaps, scratch_call = None, [0.0, 0.0], None
        for args, kw in recs[model].calls:
            pkw = {x: v for x, v in kw.items() if x != "max_live"}
            P, M = args[0].shape
            route = route_of(kw)
            fM, lsF, logZ = fwd(*args, **kw)
            post = bwd(fM, lsF, logZ, *args, **kw)
            plain = {}
            plain_f = time_ms(lambda: plain.update(f=pf(*args, **pkw)), 1,
                              warmup=False)
            plain_b = time_ms(lambda: plain.update(
                b=pb(*plain["f"], *args, **pkw)), 1, warmup=False)
            what = f"band {kw['band']}" + (
                f", max_live {kw['max_live']}" if "max_live" in kw else "")
            if route == "wide":
                what += ", " + cluster_line(kw["max_live"], model)
            d_post, d_fwd = check_hmm(
                fM, lsF, logZ, post, *plain["f"], plain["b"],
                f"phase 8: {model} path call at {[P, M, kw['band']]} "
                f"({what}, {route} route, {int((args[2] > 0).sum())} "
                "pairs)")
            del fM, lsF, logZ, post, plain
            if route == "wide":
                gaps = [max(gaps[0], d_fwd), max(gaps[1], d_post)]
                cells = P * M * kw["band"]
                if model == "pairhmm5" and not pairhmm5_cuda.cluster_shape(
                        kw["max_live"])["smem"]:
                    # timed apart: the kernels line keeps the path's
                    # largest call on the shared-memory rows
                    scratch_call = (args, kw, plain_f, plain_b)
                elif best is None or cells > best[0]:
                    best = (cells, args, kw, plain_f, plain_b)
        if best is None:
            raise AssertionError(f"phase 8: no {model} call on the wide "
                                 "route")
        errs[f"{model}_fwd_wide"], errs[f"{model}_bwd_wide"] = gaps
        _cells, args, kw, plain_f, plain_b = best
        P, M = args[0].shape
        band = kw["band"]
        m = args[2]
        rows_, used = int(m.sum()), int((m > 0).sum())
        live = banded_cuda.live_cells(m, args[3], args[4], M, band)
        # the rows the pairs use: q, the t_shift window of each row, the
        # scalars and the emissions in; fM (and post) out, lsF and logZ
        in_bytes = rows_ + rows_ + used * band + 12 * P + 144
        out_bytes = 4 * rows_ * band + 4 * rows_ + 4 * P
        longest = int(m.max())
        if model == "pairhmm5":
            wide_hmm5_global(scratch_call, timed)
        step_ns, step_what = smem_step_ns()
        steps_row = hmm_cluster_row_steps(model, kw["max_live"])
        latency_ms = longest * steps_row * step_ns / 1e6
        fM, lsF, logZ = fwd(*args, **kw)
        for k, (name, fn, plain_ms, bytes_) in enumerate((
                (f"{model}_fwd_wide", lambda: timed[0](*args, **kw),
                 plain_f, in_bytes + out_bytes),
                (f"{model}_bwd_wide",
                 lambda: timed[1](fM, lsF, logZ, *args, **kw), plain_b,
                 in_bytes + out_bytes + 4 * rows_ * band))):
            ms = time_ms(fn, 3)
            source = f"cactus_tpu_torch/csrc/{model}.cu"
            rows.append(kernel_row(name, source, lines[k], launches, errs,
                                   ms, plain_ms, bytes_, flops[k] * live,
                                   FP32_OPS_PER_S, [P, M, band], None))
            rows[-1].update(us_per_row=ms * 1e3 / longest)
            log(f"{name} at {[P, M, band]}: {ms * 1e3 / longest:.2f} us a "
                f"row of the longest pair ({longest} rows); {live} live "
                f"cells of {rows_ * band} band cells in rows 1..m")
            log(f"{name}: {cluster_line(kw['max_live'], model)}; latency "
                f"line {longest} x {steps_row} steps x {step_ns:.2f} ns = "
                f"{latency_ms:.4f} ms ({step_what}), "
                f"{ms / latency_ms:.2f}x")
        del fM, lsF, logZ
    log("no single PyTorch call computes these DPs: library_ms is null")
    return rows


# ---------------------------------------------------------------- pangenome

# phase 9's inputs: the pangenome builder on the 4 haplotypes of a star
# tree, seed 23: star mode at 100 kb (the host graph emission's cost grows
# faster than the bases: at 200 kb the star run took 94.7 s on the H100,
# and the script with phase 11 1097 s of its 1200), sv and refmap modes at
# 20 kb, and the two-chromosome split of tests/test_pangenome.py
PAN_NEWICK = "(a:0.02,b:0.02,c:0.02,d:0.02)root;"
PAN_SEED = 23
PAN_STAR_LEN = 100_000
PAN_SMALL_LEN = 20_000
PAN_REF = "a"
# the 2D layout's files hold random draws (the JAX package's threefry
# bits, here a host torch generator's), so each .lay.tsv is held by its
# layout_stress instead of a digest: every coordinate finite, and the
# stress within PAN_LAYOUT_RTOL of the JAX package's layout_2d run on the
# port's draws for the same graph and seed (the JAX package's CPU reading
# on the same pairs; tests/layout_control_report.py shows that the
# port's CPU layout meets it and that the initial layout and a
# scatter-sum step fail it)
PAN_LAYOUT_SUFFIXES = (".lay.tsv", ".draw.png")
PAN_LAYOUT_RTOL = 0.01
# the JAX package's CPU output of each phase 9 run (sha256 of each file,
# the layout_stress of each layout on the port's draws):
# `JAX_PLATFORMS=cpu python tests/pangenome_digest_report.py`
PAN_DIGESTS = {'gfa_index': {'graph.dist': 'd34cf68dc5f3fdb02af4dcbef089cc5dae33c2b37c64acf8a7a83a7ebf3f7f2f',
               'graph.gbz': '7b7813999b6a42f94909a6a897006801260f854f232bd75947b036ce3e77435c',
               'graph.min': '503953ddcd09296ba3db29e6c35c48eaaca23afd33e77510f69dd1245b6c37f7',
               'snarls.json': 'fad7e302438c9880ed29ed841c83306f328e33139ba31aa6242462098dc90345',
               'stats.json': 'c072dbe51496c08cb0c60f167deed6ea8b6f950ba77eda140503ea4f561435a9'},
 'gfa_vcf': {'graph.vcf': '395dbbdc1d1a84f49cb6e362384bff4cc7de0fafd8f067aa2957774e65e9c657'},
 'gfa_viz': {'graph.lay.tsv': {'stress': 344.930603},
             'graph.png': '02d6c39df0c2051e3361634c06175d201da7e2875628fda1429703b3d4902ce4'},
 'patch': {'b.patched.fa': '21101f664c5c71bf1da4d8fc74c33f88cb12dd26a71e953fccc95c502acaea7d',
           'patch_report.json': '1d9e9a771d0d2dc64cfa9b669c924f0e4b936643502739ee7efbd4853f00e472'},
 'refmap': {'clipped.bed': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
            'exclusions.tsv': '52696fc52082f3d462f06c5e21817a628a10f4abb55d5e0179c22b30da61ae05',
            'exclusions.tsv.json': 'b696eafad8828e50f6ba3377784f711a14b691ee856c166ab0bad86a8c4acb62',
            'filtered.bed': '756a6995286a0aa5d1bed70b6bd5479e1c74c3e5bf575287121d495f1bc51c28',
            'graph_stats.json': '4aabdebff29ed787c0c25aa1a99f46d11afcac37565d66efaecc68ab604eda66',
            'pangenome.bub.vcf': '46a17a832cb7388ec145c715084c47b4ed0c00113428f097db49b0ec345fc08f',
            'pangenome.clip.gfa': 'ca0a909c89b27c5ef7c542ec04094ece2a94b987c30cb018f52e6d62638fd22f',
            'pangenome.clip.viz.png': 'd4d5fa7c9a443ee331a35b321dad5ef54ae480f0196ae9aa66a3651a1ee62f39',
            'pangenome.dist': '9a48ee5f48ef59bc3b00afa8f2ee786b8d37c823c0aecbfb69b5160be64b4a0b',
            'pangenome.filter.gfa': '3e991577c98dd9fcf0eb7d7676201b101391b2e958116d702f1a50bcf472223d',
            'pangenome.gbz': 'fcfffbebe3138646750c236613899aebdde756308e83ce66611ea3abb5571684',
            'pangenome.gfa': 'ca0a909c89b27c5ef7c542ec04094ece2a94b987c30cb018f52e6d62638fd22f',
            'pangenome.lay.tsv': {'stress': 37.403427},
            'pangenome.min': '2c3185f04dca60dc7f45ad0fed4699fe15375026e21c658c0d67720f997c738e',
            'pangenome.vcf': 'a96719820aa084dd3d4de00ef5a2d6d5e0c6962c24115e1de8c48aa65652efa5',
            'pangenome.viz.png': 'd4d5fa7c9a443ee331a35b321dad5ef54ae480f0196ae9aa66a3651a1ee62f39',
            'pangenome.wave.vcf': '943a33f63f77e0183d4fa6dee0b922090bba335924b5911e05e69ddfd7043736',
            'snarls.json': 'e20066133961fbd12611c42b00129218f953ea2bfe29c7dced94e2fbe5ff9735'},
 'split': {'contig_assignment.tsv': '41f8dc575355e0eb201e5c223c013a2d4decd8959fe06c92e153c4a954a60692',
           'pangenome_stats.json': '697e8c0e80715f212444d31d2361f2937456008bcc7078d56899e368a10f0c97',
           'ref.chr1/clipped.bed': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
           'ref.chr1/exclusions.tsv': '38463440dc54363a49b399996ee2cd2fab44ad3bc6f45f698136b124ca2f3d44',
           'ref.chr1/exclusions.tsv.json': '4435c8b5d957b91f399fa8eea9e7620fc093d19b3a548f5003a0070f454ef339',
           'ref.chr1/filtered.bed': '86ec3f81de3ec7dd757aeb63533b0a9298825596d6cebcb6d1a9f80c21ce01c7',
           'ref.chr1/graph_stats.json': 'a0bc9c51bc3243b1770ba105f90d246aa3837c30a1ee1af85c64ecab7868e971',
           'ref.chr1/pangenome.bub.vcf': 'bb5c02030a75222db0d5e5d6df366607ca449248271fcc9043b6ac7038993695',
           'ref.chr1/pangenome.clip.gfa': '920c726c57d8d9f732c8c6905df67980b6333892ff64cf93801adb48f1dc6bed',
           'ref.chr1/pangenome.clip.viz.png': '501a0dab701f0e337a9732c21baecb0c7f75406181bc5383aa61b606f5f2823b',
           'ref.chr1/pangenome.dist': '0fc68573d45d7f33c72f2bc8527cb7072451826d9cce68c41a0b7922de776877',
           'ref.chr1/pangenome.filter.gfa': 'b783e298254dc0e278e1fa54cd6536bf2e8f41b74a4cab523d68f7110ae28486',
           'ref.chr1/pangenome.gbz': '7b80c1dd83eb221bc33f84d0217679bbf9e09c3298ad42685b9def0af61a02fd',
           'ref.chr1/pangenome.gfa': '920c726c57d8d9f732c8c6905df67980b6333892ff64cf93801adb48f1dc6bed',
           'ref.chr1/pangenome.lay.tsv': {'stress': 0.007279},
           'ref.chr1/pangenome.min': 'b589f28adab435ac5290be3561100dddfdc2dc8594093624fc015a8489ed0813',
           'ref.chr1/pangenome.vcf': 'bb5c02030a75222db0d5e5d6df366607ca449248271fcc9043b6ac7038993695',
           'ref.chr1/pangenome.viz.png': '501a0dab701f0e337a9732c21baecb0c7f75406181bc5383aa61b606f5f2823b',
           'ref.chr1/pangenome.wave.vcf': '052b7aba98caf6e0dc8bee82a726f532f5f10108dcf58b84632ea9c129663828',
           'ref.chr1/snarls.json': 'd4b7ffd3192992d23109effade5be08f240eb1a60b48672030c7a25a9ef688bf',
           'ref.chr2/clipped.bed': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
           'ref.chr2/exclusions.tsv': '5b0b9f77a111e054d23edc78badb45b1d0f19461ebb8a01accddbb86efd9c4dc',
           'ref.chr2/exclusions.tsv.json': '4482b3c601938a28e472ee8070ae7550bcf2ea1c16c99c635066252222455883',
           'ref.chr2/filtered.bed': '17e06bab2e287f3c6d85af2ced48f3eb7ccb58ea28de15bce5601b4ca6dec304',
           'ref.chr2/graph_stats.json': '7f5f29948bebf20aec50c280d07efc12318fa8eca2663cb30a610c71e9c6f0f6',
           'ref.chr2/pangenome.bub.vcf': '0b1a578c9326f32cdc5e552b6b903c39bc0856a3bd002c8383eadf8c73b651ce',
           'ref.chr2/pangenome.clip.gfa': 'db2af6edf64284f6500d2b9f61cfcbd0594b7f64a2e265b8367bbc057cb68a39',
           'ref.chr2/pangenome.clip.viz.png': '691db47f6d67b362d75447b8e487ccc4c6f6b419888c4d737c7eab91877623df',
           'ref.chr2/pangenome.dist': 'c73031529a81f6e7971dbca76ccfc250231ad397bbb57091bc3652ef29ec6a53',
           'ref.chr2/pangenome.filter.gfa': '884962bbab0169c398b7926337f977b8271d3d54e64e8ed63b704fefecf2ae7c',
           'ref.chr2/pangenome.gbz': 'b3db680f05fbfe2fa6dc13589e29ab2e25be40114ee33b6b7d4760af79c55a96',
           'ref.chr2/pangenome.gfa': 'db2af6edf64284f6500d2b9f61cfcbd0594b7f64a2e265b8367bbc057cb68a39',
           'ref.chr2/pangenome.lay.tsv': {'stress': 0.001325},
           'ref.chr2/pangenome.min': '0e388d10d6e3d4088b17459d3f57c8de80385bda4e421987e66dd5804f67ce11',
           'ref.chr2/pangenome.vcf': '0b1a578c9326f32cdc5e552b6b903c39bc0856a3bd002c8383eadf8c73b651ce',
           'ref.chr2/pangenome.viz.png': '691db47f6d67b362d75447b8e487ccc4c6f6b419888c4d737c7eab91877623df',
           'ref.chr2/pangenome.wave.vcf': 'f5ecb98c76363bfd3136362174c4338d6c0e7aa3b9f7ea1ada9c6f22ab65974a',
           'ref.chr2/snarls.json': '7aa3f2905f92657cfb8068de0c842af6f48be002b9d840e21041fdf38ddfc6bf'},
 'star': {'clipped.bed': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
          'exclusions.tsv': '6ff295aa7b33c5e16e213c58a0f879e6d603e6eaaf3df5fae653cdb1d7d6760e',
          'exclusions.tsv.json': '97b32e35005ca043f0976108303d32a208bbbe03ef5272cd952429d11ccf4425',
          'filtered.bed': '256164d78b8ec912e74dfd61cad922f11258f69ad448f9d58b08bf98d980650a',
          'graph_stats.json': '7837f6d04333b2878ffa6b3ae7e5b8e213dc8aa56552b366c36a9ead8e6fa719',
          'pangenome.bub.vcf': '1fff2950e08109cf782dc0b4c74f217a57ffd54b664a4e0a51a8cab13f11782f',
          'pangenome.clip.gfa': '56d792fda4577b0fcf08085c6cc63cc49a548288730c79c8cd3150625b310eb7',
          'pangenome.clip.viz.png': '02d6c39df0c2051e3361634c06175d201da7e2875628fda1429703b3d4902ce4',
          'pangenome.dist': 'd34cf68dc5f3fdb02af4dcbef089cc5dae33c2b37c64acf8a7a83a7ebf3f7f2f',
          'pangenome.filter.gfa': '929de1438bf7ff9b99f38006be7ab989333608395a9342b5ba3b406046e11577',
          'pangenome.gbz': '7b7e56cdd86188540aebb4165fdd71c49e44d72ec6b23b8d8c2951e8c5d8f7e4',
          'pangenome.gfa': '56d792fda4577b0fcf08085c6cc63cc49a548288730c79c8cd3150625b310eb7',
          'pangenome.lay.tsv': {'stress': 344.930603},
          'pangenome.min': '503953ddcd09296ba3db29e6c35c48eaaca23afd33e77510f69dd1245b6c37f7',
          'pangenome.vcf': '395dbbdc1d1a84f49cb6e362384bff4cc7de0fafd8f067aa2957774e65e9c657',
          'pangenome.viz.png': '02d6c39df0c2051e3361634c06175d201da7e2875628fda1429703b3d4902ce4',
          'pangenome.wave.vcf': '0ae3333cdcd87a6fe935bb30a01c91a372456dadf501301c2907d8e9a85e847d',
          'snarls.json': 'fad7e302438c9880ed29ed841c83306f328e33139ba31aa6242462098dc90345'},
 'sv': {'clipped.bed': 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
        'exclusions.tsv': '52696fc52082f3d462f06c5e21817a628a10f4abb55d5e0179c22b30da61ae05',
        'exclusions.tsv.json': 'b696eafad8828e50f6ba3377784f711a14b691ee856c166ab0bad86a8c4acb62',
        'filtered.bed': '756a6995286a0aa5d1bed70b6bd5479e1c74c3e5bf575287121d495f1bc51c28',
        'graph_stats.json': '001ebd4d5f6861efa387eec1f01495730285c2e46e28e55576e3bc2293424f8f',
        'graphmap.paf': 'd948d9703505bbef8c5c9833d854dae44c3f1e99cfff9bedf3de59192856fb11',
        'minigraph_order.json': '6e790eb078990a3c99fb01b0dcd85963c945ea6cd047cc543fd61d60e54b2c7e',
        'pangenome.bub.vcf': '46a17a832cb7388ec145c715084c47b4ed0c00113428f097db49b0ec345fc08f',
        'pangenome.clip.gfa': '21eb78619ca217a8130bc90932a30869376233e7fc82136c29093dc51bc6d54e',
        'pangenome.clip.viz.png': 'd4d5fa7c9a443ee331a35b321dad5ef54ae480f0196ae9aa66a3651a1ee62f39',
        'pangenome.dist': '5f02ee73136be8488beaf7bf62820bf878d8f18118e8fcf7e72493a2ba5e8c82',
        'pangenome.filter.gfa': '5a72de9b98ac5ba7184ba56a471b4f6c7a365eb91333565cf1207a4a9174e9a8',
        'pangenome.gbz': 'c48146109510570bc2f3fadb0164d802ad439702d811c6cbe0395f0a4eba316f',
        'pangenome.gfa': '21eb78619ca217a8130bc90932a30869376233e7fc82136c29093dc51bc6d54e',
        'pangenome.lay.tsv': {'stress': 37.192348},
        'pangenome.min': 'ae1e0092bc66fae6833a82fcc4dd3ed8adbc6ae0892f048e0b1416cdd343f92d',
        'pangenome.raw.gfa': 'da4266415dff1d9bb3bcf5ce4b11b207cca741a776e942d46145f220d8085188',
        'pangenome.vcf': 'a96719820aa084dd3d4de00ef5a2d6d5e0c6962c24115e1de8c48aa65652efa5',
        'pangenome.viz.png': 'd4d5fa7c9a443ee331a35b321dad5ef54ae480f0196ae9aa66a3651a1ee62f39',
        'pangenome.wave.vcf': '943a33f63f77e0183d4fa6dee0b922090bba335924b5911e05e69ddfd7043736',
        'snarls.json': '2fc1e13ce4d9cc62e2ce938bdae0d2a82fba5673b857ba56d637554216cd30f3',
        'sv_graph.rgfa': '9dd23c5846f94f9102d10192b0aa2b0a0fc50fcf31e6579c31030858210e5df0'}}


def pan_inputs(work, evolver, parse_newick, Sequence):
    """Phase 9's inputs under `work`, made with the given package's
    evolver and Sequence: {"star": seqfile, "small": seqfile} and the
    genomes of the two-chromosome split."""
    import numpy as np
    seqfiles = {}
    for name, root_len in (("star", PAN_STAR_LEN), ("small", PAN_SMALL_LEN)):
        sim = evolver.simulate(parse_newick(PAN_NEWICK), root_len=root_len,
                               seed=PAN_SEED)
        seqfiles[name] = evolver.write_seqfile(
            sim, os.path.join(work, f"in_{name}"))
    rng = np.random.default_rng(9)
    chr1 = rng.integers(0, 4, 8000).astype(np.uint8)
    chr2 = rng.integers(0, 4, 8000).astype(np.uint8)

    def mutate(x, seed):
        r = np.random.default_rng(seed)
        m = r.random(len(x)) < 0.02
        return np.where(m, (x + 1) % 4, x).astype(np.uint8)

    split = {
        "ref": {"ref.chr1": Sequence("ref.chr1", chr1),
                "ref.chr2": Sequence("ref.chr2", chr2)},
        "s1": {"s1.tig1": Sequence("s1.tig1", mutate(chr1, 1)),
               "s1.tig2": Sequence("s1.tig2", mutate(chr2, 2))},
        "s2": {"s2.tig1": Sequence("s2.tig1", mutate(chr1, 3)),
               "s2.junk": Sequence("s2.junk",
                                   rng.integers(0, 4, 3000).astype(np.uint8))},
    }
    return seqfiles, split


def pan_cli_runs(seqfiles, work):
    """[(run, argv of the pangenome verb)]: star mode on the 100 kb input,
    sv and refmap modes on the 20 kb one."""
    def argv(run, sf, *mode):
        return ["pangenome", seqfiles[sf], os.path.join(work, run),
                "--reference", PAN_REF, *mode]
    return [("star", argv("star", "star")),
            ("sv", argv("sv", "small", "--mode", "sv")),
            ("refmap", argv("refmap", "small", "--mode", "refmap"))]


def pan_staged_argvs(seqfiles, work):
    """The sv run again, one `--stage` a process (its files must equal
    the monolithic run's)."""
    return [["pangenome", seqfiles["small"], os.path.join(work, "sv_staged"),
             "--reference", PAN_REF, "--mode", "sv", "--stage", stage]
            for stage in ("minigraph", "graphmap", "align", "join")]


def pan_verb_runs(work):
    """[(run, argv)] of the gfa and patch verbs on the star run's GFA; makes
    the directories the verbs write files into."""
    gfa = os.path.join(work, "star", "pangenome.gfa")
    for d in ("gfa_vcf", "gfa_viz"):
        os.makedirs(os.path.join(work, d), exist_ok=True)
    return [("gfa_index", ["gfa", "index", gfa,
                           os.path.join(work, "gfa_index")]),
            ("gfa_vcf", ["gfa", "vcf", gfa,
                         os.path.join(work, "gfa_vcf", "graph.vcf")]),
            ("gfa_viz", ["gfa", "viz", gfa,
                         os.path.join(work, "gfa_viz", "graph.png")]),
            ("patch", ["patch", gfa, "b", os.path.join(work, "patch"),
                       "--donors", "a,c"])]


def pan_layout_graph(lay, read_gfa, gfa=None):
    """(graph, reference walk) a .lay.tsv was laid out on: the
    pangenome.gfa beside it and its graph_stats.json's reference, or `gfa`
    and its first walk (the gfa viz verb's default)."""
    root = os.path.dirname(lay)
    if gfa is not None:
        g = read_gfa(gfa)
        return g, sorted(g.walks)[0]
    with open(os.path.join(root, "graph_stats.json")) as fh:
        ref = json.load(fh)["reference"]
    return read_gfa(os.path.join(root, "pangenome.gfa")), ref


def pan_digests(outdir, layout2d=None, read_gfa=None, gfa=None) -> dict:
    """{path under outdir: sha256} of every file a run wrote but its
    layout files, and {path of each .lay.tsv: {"stress", "finite"}}: its
    layout_stress and whether every coordinate is finite
    (`pan_layout_graph` names the graph each is read against; a directory
    with layout files needs layout2d and read_gfa)."""
    import numpy as np
    out = {}
    for root, _dirs, files in sorted(os.walk(outdir)):
        for f in sorted(files):
            path = os.path.join(root, f)
            rel = os.path.relpath(path, outdir)
            if f.endswith(PAN_LAYOUT_SUFFIXES[1]):
                continue
            if f.endswith(PAN_LAYOUT_SUFFIXES[0]):
                g, ref = pan_layout_graph(path, read_gfa, gfa)
                X = layout2d.read_lay(path)
                out[rel] = {
                    "stress": round(layout2d.layout_stress(g, X, ref_name=ref),
                                    6),
                    "finite": bool(np.isfinite(X).all())}
                continue
            out[rel] = sha256_of(path)
    return out


def sha256_of(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def pan_mismatches(got: dict, pinned: dict) -> list[str]:
    """What of a run's files differs from its pinned readings."""
    bad = [f"{k}: missing" for k in sorted(set(pinned) - set(got))]
    bad += [f"{k}: not pinned" for k in sorted(set(got) - set(pinned))]
    for k in sorted(set(got) & set(pinned)):
        g, p = got[k], pinned[k]
        if isinstance(p, str):
            if g != p:
                bad.append(f"{k}: sha256 {g[:16]}... != pinned {p[:16]}...")
        elif not g["finite"]:
            bad.append(f"{k}: a coordinate is not finite")
        elif not abs(g["stress"] / p["stress"] - 1) <= PAN_LAYOUT_RTOL:
            bad.append(f"{k}: layout_stress {g['stress']} is not within "
                       f"{PAN_LAYOUT_RTOL} of the JAX package's "
                       f"{p['stress']} on the same draws")
    return bad


class Spans:
    """Wall seconds by span of one run: wraps functions (module attributes,
    methods, classmethods) with timers; a call inside another timed call
    counts only in the outer span.  `results` keeps each span's return
    values."""

    def __init__(self):
        self.secs: dict[str, float] = {}
        self.results: dict[str, list] = {}
        self.open: list[str] = []
        self.undo = []

    def wrap(self, owner, attr, span):
        raw = (owner.__dict__[attr] if isinstance(owner, type)
               else getattr(owner, attr))
        fn = getattr(owner, attr) if isinstance(raw, classmethod) else raw

        def timed(*args, **kw):
            if self.open:
                self.open.append(span)
                try:
                    return fn(*args, **kw)
                finally:
                    self.open.pop()
            self.open.append(span)
            t0 = time.time()
            try:
                out = fn(*args, **kw)
                self.results.setdefault(span, []).append(out)
                return out
            finally:
                self.open.pop()
                self.secs[span] = self.secs.get(span, 0.0) + time.time() - t0

        setattr(owner, attr,
                staticmethod(timed) if isinstance(raw, classmethod) else timed)
        self.undo.append((owner, attr, raw))

    def remove(self):
        for owner, attr, raw in reversed(self.undo):
            setattr(owner, attr, raw)
        self.undo = []


# bytes of plain output (dirs, or fM and post) a concatenated group of
# kept calls may make at once in `check_banded_calls` / `check_pairhmm_calls`
CHECK_GROUP_BYTES = 4 << 30


def call_groups(calls, bytes_of):
    """The indices of kept calls (host copies) whose plain versions can
    run as one batch: the same rows, keyword arguments (max_live aside,
    which only the kernel takes) and last argument (the score table), cut
    so that a group's plain output stays under CHECK_GROUP_BYTES.  A
    pair's plain result does not depend on the rest of its batch."""
    by_key: dict = {}
    for i, (a, k) in enumerate(calls):
        key = (a[0].shape[1], a[-1].numpy().tobytes(),
               tuple(sorted((x, v) for x, v in k.items() if x != "max_live")))
        by_key.setdefault(key, []).append(i)
    groups = []
    for idxs in by_key.values():
        cur, size = [], 0
        for i in idxs:
            b = bytes_of(*calls[i])
            if cur and size + b > CHECK_GROUP_BYTES:
                groups.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += b
        groups.append(cur)
    return groups


def concat_calls(calls, idxs, dev):
    """A group's arguments as one batch on the card: the per-pair tensors
    concatenated, the last argument (the score table) shared."""
    import torch
    first = calls[idxs[0]][0]
    return tuple(torch.cat([calls[i][0][j] for i in idxs]).to(dev)
                 for j in range(len(first) - 1)) + (first[-1].to(dev),)


def check_banded_calls(run, dp, launches, dev) -> list[str]:
    """Every banded_dp call one `recorded_run` kept, launched again on
    its inputs and held to the plain version (one plain batch a
    `call_groups` group): the live cells, end scores and end states
    equal; then banded_traceback on that output, with the move capacity
    the path gives it (`traceback_cap`), equal to the host traceback.
    The path launches the traceback once after each banded_dp call.
    Returns the calls that differ."""
    import torch
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import banded_cuda
    bad = []
    if launches["banded_traceback"] != launches["banded_dp"]:
        bad.append(f"{run}: {launches['banded_traceback']} banded_traceback "
                   f"launches for {launches['banded_dp']} banded_dp "
                   "launches")
    plain_s = [0.0, 0.0]
    groups = call_groups(dp.calls, lambda a, k: a[0].numel() * k["band"])
    for idxs in groups:
        kw = {x: v for x, v in dp.calls[idxs[0]][1].items()
              if x != "max_live"}
        t0 = time.time()
        ref = tb.banded_align_batch(*concat_calls(dp.calls, idxs, dev), **kw)
        plain_s[0] += time.time() - t0
        row = 0
        for i in idxs:
            a, k = dp.calls[i]
            a = on_device(a, dev)
            rows = slice(row, row + a[0].shape[0])
            row = rows.stop
            got = dp.fn(*a, **k)
            if not banded_live_equal(got, tuple(x[rows] for x in ref),
                                     *a[2:5]):
                bad.append(f"{run}: banded_dp call {i} at "
                           f"{[*a[0].shape, k['band']]} differs from the "
                           "plain version on the live cells")
            tb_args = (got[0], *a[2:5], got[2], traceback_cap(a[2], a[3]))
            moves, counts = banded_cuda.banded_traceback(*tb_args)
            t0 = time.time()
            want = banded_cuda.banded_traceback_plain(*tb_args)
            plain_s[1] += time.time() - t0
            if not (torch.equal(moves, want[0])
                    and torch.equal(counts, want[1])):
                bad.append(f"{run}: banded_traceback after banded_dp call "
                           f"{i} at {list(a[0].shape)} differs from the "
                           "host traceback")
        del ref
    kernels = [banded_cuda.dp_kernel(k["max_live"]) for _a, k in dp.calls]
    log(f"  {run}: {len(dp.calls)} banded_dp calls ({kernels.count('warp')} "
        f"on the warp kernel, {kernels.count('block')} on the block kernel), "
        f"each launched again on its recorded inputs with banded_traceback "
        f"on its output: "
        f"{'every one equal to' if not bad else 'NOT all equal to'} the "
        f"plain versions ({len(groups)} plain banded batches "
        f"{plain_s[0]:.1f} s, host tracebacks {plain_s[1]:.1f} s)")
    return bad


def check_pairhmm_calls(run, fwd, launches, dev) -> list[str]:
    """Every pairhmm_fwd call one `recorded_run` kept, launched again on
    its inputs with pairhmm_bwd on its outputs, and held to the plain
    versions (one plain batch a `call_groups` group): the posterior
    within HMM_ATOL and logZ within LOGZ_RTOL, as `check_hmm` holds them.
    The forward values are read, not held: at cells some 1e-30 below
    their row's maximum neither float32 version is accurate (against the
    plain steps run in float64, both are off by up to 18 in log space on
    the human-dog pair's calls: tests/pairhmm_float64_report.py); the log
    names the largest gap and the largest plain fM among the cells past
    FWD_LOG_ATOL.  Returns the calls that differ."""
    import torch
    from cactus_tpu_torch.ops import pairhmm as tp
    from cactus_tpu_torch.ops import pairhmm_cuda
    bad, gaps, past = [], [0.0, 0.0], [0, 0.0]
    if launches["pairhmm_bwd"] != launches["pairhmm_fwd"]:
        bad.append(f"{run}: {launches['pairhmm_bwd']} pairhmm_bwd launches "
                   f"for {launches['pairhmm_fwd']} pairhmm_fwd launches")
    t0 = time.time()
    groups = call_groups(fwd.calls, lambda a, k: 8 * a[0].numel() * k["band"])
    for idxs in groups:
        kw = fwd.calls[idxs[0]][1]
        cat = concat_calls(fwd.calls, idxs, dev)
        ref = tp.forward_banded(*cat, **kw)
        ref = (*ref, tp.backward_posterior(*ref, *cat, **kw))
        del cat
        row = 0
        for i in idxs:
            a, k = fwd.calls[i]
            a = on_device(a, dev)
            rows = slice(row, row + a[0].shape[0])
            row = rows.stop
            fM, lsF, logZ = fwd.fn(*a, **k)
            post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *a, **k)
            fM_r, lsF_r = ref[0][rows], ref[1][rows]
            try:
                got = check_hmm(fM, lsF, logZ, post,
                                *(x[rows] for x in ref),
                                f"{run}: pairhmm call {i} at "
                                f"{[*a[0].shape, k['band']]}", quiet=True,
                                hold_forward=False)
            except AssertionError as err:
                bad.append(str(err))
                continue
            gaps = [max(g, x) for g, x in zip(gaps, got)]
            far = (fM_r > 1e-30) & (((torch.log(fM) + lsF[..., None])
                                     - (torch.log(fM_r) + lsF_r[..., None]))
                                    .abs() > FWD_LOG_ATOL)
            if bool(far.any()):
                past = [past[0] + int(far.sum()),
                        max(past[1], float(fM_r[far].max()))]
        del ref
    log(f"  {run}: {len(fwd.calls)} pairhmm_fwd calls, each launched again "
        f"on its recorded inputs with pairhmm_bwd: "
        f"{'every one within' if not bad else 'NOT all within'} the "
        f"posterior and logZ tolerances of the plain versions (largest "
        f"posterior gap {gaps[0]:.3g}); forward values, read: largest "
        f"log(fM) + lsF gap {gaps[1]:.3g}, {past[0]} cells past "
        f"{FWD_LOG_ATOL}, their largest plain fM {past[1]:.3g} of its row "
        f"maximum; {len(groups)} plain batches, {time.time() - t0:.1f} s")
    return bad


def recorded_run(dev, fn, dp_cells=None, hmm=False):
    """fn() in process, with the launch counts set to 0 just before it
    and read just after, and Recorders keeping every banded_dp call (with
    hmm also every pairhmm_fwd call) as host copies, for
    `check_recorded`; dp_cells(args, kw), where given, sees each
    banded_dp call.  Returns (fn's result, launches, wall seconds, device
    peak bytes, the Recorders by kernel)."""
    import torch
    from cactus_tpu_torch.ops import banded_cuda, cuda_build, pairhmm_cuda
    recs = {"banded_dp": Recorder(banded_cuda, "banded_dp", dp_cells,
                                  attr="launch_banded_dp", keep_calls="host")}
    if hmm:
        recs["pairhmm_fwd"] = Recorder(pairhmm_cuda, "pairhmm_fwd", None,
                                       keep_calls="host")
    for rec in recs.values():
        rec.install()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_build.reset_launches()
    t0 = time.time()
    try:
        out = fn()
        torch.cuda.synchronize(dev)
    finally:
        launches = cuda_build.launches()
        for rec in recs.values():
            rec.remove()
    return (out, launches, time.time() - t0,
            torch.cuda.max_memory_allocated(dev), recs)


def check_recorded(run, recs, launches, dev) -> list[str]:
    """The calls a `recorded_run` kept, each held to its plain version."""
    bad = check_banded_calls(run, recs["banded_dp"], launches, dev)
    if "pairhmm_fwd" in recs:
        bad += check_pairhmm_calls(run, recs["pairhmm_fwd"], launches, dev)
    return bad


def pan_run(dev, run, fn, outdir, pinned, spans_of):
    """One in-process run of phase 9 through `recorded_run`, every
    banded_dp and banded_traceback call held to its plain version after
    the run (`check_recorded`).  Logs the run's wall split, device peak
    and banded_dp calls (band, live cells, whether inside vcfwave), and
    returns its launches and the mismatches of its calls and files
    against their plain versions and pinned readings."""
    from cactus_tpu_torch.ops import banded_cuda
    from cactus_tpu_torch.pangenome import layout2d
    from cactus_tpu_torch.pangenome.graph import read_gfa
    spans = spans_of()
    dp_calls = []          # (band, live cells, inside vcfwave) a call

    def dp_cells(args, kw):
        P, M = args[0].shape
        dp_calls.append((kw["band"], banded_cuda.live_cells(
            *args[2:5], M, kw["band"]), "vcfwave" in spans.open))
        return P * M * kw["band"]

    try:
        _out, launches, wall, peak, recs = recorded_run(dev, fn, dp_cells)
    finally:
        spans.remove()
    ran = {k: v for k, v in launches.items() if v}
    log(f"phase 9 {run}: {wall:.1f} s wall, device peak {peak / 1e6:.0f} MB "
        f"allocated, kernel launches {ran}")
    for result in spans.results.get("align", []):
        tm = result.steps["_pan_root_"].timings
        log(f"  {run} alignment phases (AncestorStep.timings): " + " ".join(
            f"{k}={tm[k]:.1f}s" for k in ("blast", "caf", "bar",
                                          "reference")))
    log(f"  {run} wall split: " + " ".join(
        f"{k}={v:.1f}s" for k, v in spans.secs.items())
        + f" other={wall - sum(spans.secs.values()):.1f}s")
    for name in ("pairhmm_fwd", "pairhmm_bwd"):
        log(f"  {run}: {name} {'ran' if launches[name] else 'did not run'} "
            f"({launches[name]} launches)")
    if dp_calls:
        wave = [c for c in dp_calls if c[2]]
        log(f"  {run} banded_dp: {len(dp_calls)} launches, "
            f"{sum(c[1] for c in dp_calls)} live cells, widest band "
            f"{max(c[0] for c in dp_calls)}; the vcfwave batch: "
            + (f"{len(wave)} launches at band {sorted({c[0] for c in wave})}, "
               f"{sum(c[1] for c in wave)} live cells" if wave else "none"))
    bad = check_recorded(run, recs, launches, dev)
    got = pan_digests(outdir, layout2d, read_gfa)
    for rel, val in sorted(got.items()):
        if isinstance(val, dict):
            p = pinned.get(rel, {})
            log(f"  {run} {rel}: layout_stress {val['stress']} (the JAX "
                f"package's on the same draws {p.get('stress')}), "
                f"{'every' if val['finite'] else 'NOT every'} coordinate "
                "finite")
    return launches, bad + [f"{run}/{m}" for m in pan_mismatches(got,
                                                                pinned)]


def phase_pangenome(dev):
    """The pangenome builder through the port on the card (the module
    docstring's phase 9)."""
    from cactus_tpu_torch import cli, progressive
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.pangenome import (driver, giraffe, indexes,
                                            layout2d, minigraph, vcf, viz)
    from cactus_tpu_torch.pangenome.graph import read_gfa
    from cactus_tpu_torch.phases import blast, caf
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick

    work = tempfile.mkdtemp(prefix="smoke_pan_",
                            dir=os.path.join(HERE, "cactus_tpu_torch",
                                             "_build"))

    def spans_of():
        sp = Spans()
        for owner, attr, span in (
                (progressive.ProgressiveAligner, "run", "align"),
                (minigraph, "build_sv_graph", "minigraph"),
                (minigraph, "graphmap", "graphmap"),
                (blast, "align_genomes", "refmap"),
                (caf, "run_caf", "caf"),
                (driver, "split_by_chromosome", "split"),
                (driver, "collapse_shared_affixes", "normalize"),
                (vcf, "write_vcf", "vcf"), (vcf, "vcfwave", "vcfwave"),
                (indexes, "save_gbz", "indexes"),
                (indexes, "snarls", "indexes"),
                (giraffe.MinimizerIndex, "build", "indexes"),
                (giraffe.DistanceIndex, "build", "indexes"),
                (viz, "viz", "viz"), (layout2d, "layout_2d", "layout"),
                (layout2d, "write_lay", "layout"),
                (layout2d, "draw", "layout")):
            sp.wrap(owner, attr, span)
        return sp

    failures, star_launches = [], None
    try:
        t0 = time.time()
        seqfiles, split = pan_inputs(work, evolver, parse_newick, Sequence)
        log(f"phase 9 inputs: {PAN_NEWICK} at {PAN_STAR_LEN} and "
            f"{PAN_SMALL_LEN} bp, seed {PAN_SEED}, and the two-chromosome "
            f"split, in {time.time() - t0:.1f} s")
        runs = [(run, (lambda argv=argv: cli.main(argv)), argv[2])
                for run, argv in pan_cli_runs(seqfiles, work)]
        out = os.path.join(work, "split")
        runs.append(("split", lambda: driver.run_pangenome_split(
            split, "ref", out, log=lambda m: print(
                f"  [split] {m}", file=sys.stderr, flush=True)), out))
        for run, fn, outdir in runs:
            launches, bad = pan_run(dev, run, fn, outdir, PAN_DIGESTS[run],
                                    spans_of)
            failures += bad
            if run == "star":
                star_launches = launches
        for name in ("banded_dp", "banded_traceback"):
            if not star_launches or star_launches[name] <= 0:
                failures.append(f"star: {name} was never launched")
        # the gfa and patch verbs on the star run's GFA, and the sv run
        # one --stage a process, in subprocesses side by side
        t0 = time.time()
        gfa = os.path.join(work, "star", "pangenome.gfa")
        staged_err: list = []

        def staged():
            try:
                for argv in pan_staged_argvs(seqfiles, work):
                    run_cli(argv, " ".join(argv[:1] + argv[3:]))
            except (AssertionError, subprocess.TimeoutExpired) as e:
                staged_err.append(e)

        thread = threading.Thread(target=staged)
        thread.start()
        procs = {run: subprocess.Popen(
            [sys.executable, "-m", "cactus_tpu_torch", *argv], cwd=HERE,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for run, argv in pan_verb_runs(work)}
        try:
            for run, proc in procs.items():
                _out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    failures.append(f"{run} exited {proc.returncode}: "
                                    f"{err[-2000:]}")
                    continue
                got = pan_digests(os.path.join(work, run), layout2d,
                                  read_gfa, gfa=gfa)
                failures += [f"{run}/{m}"
                             for m in pan_mismatches(got, PAN_DIGESTS[run])]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            thread.join()
        if staged_err:
            failures.append(f"sv --stage: {staged_err[0]}")
        else:
            got = pan_digests(os.path.join(work, "sv_staged"), layout2d,
                              read_gfa)
            failures += [f"sv_staged/{m}"
                         for m in pan_mismatches(got, PAN_DIGESTS["sv"])]
        log(f"phase 9: gfa index|vcf|viz and patch on the star GFA, and sv "
            f"one --stage a process, in subprocesses: "
            f"{time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("phase 9: kernel calls or outputs differ from "
                             "their plain versions or the JAX package's "
                             "pinned CPU readings:\n  "
                             + "\n  ".join(failures))
    log("phase 9: every banded_dp and banded_traceback call of the runs "
        "equals its plain version, every file of the star, sv (monolithic "
        "and staged), refmap and split runs and of the gfa and patch verbs "
        "equals the JAX package's CPU output (sha256), and every layout "
        "holds its readings")


# ---------------------------------------------- phase 10: the pipeline

# phase 10's inputs: one sequence of PIPE_MASK_LEN bases with planted
# repeat families for the masker's k-mer count,
# two related PIPE_JOIN_LEN sequences for the device seed join (their
# q + t reaches PIPE_JOIN_THRESHOLD, the size past which the JAX package
# joins on the device and not on the host), phase 3's five genomes for
# `preprocess` and phase 5's two-genome tree for the plan and verbs, with
# repeat families planted in both (evolver's genomes have none)
PIPE_SEED = 31
# 64 Mb (human chr20's size class) took phase 10 past its 90 s aim (102 s
# in the first chip run, the CPU's count 20.4 s of it): cut to 32 Mb
PIPE_MASK_LEN = 32_000_000
PIPE_JOIN_LEN = 2_000_000
PIPE_JOIN_THRESHOLD = 4_000_000
PIPE_PAIR_NEWICK = "(a:0.05,b:0.05)root;"
PIPE_PREPROCESS_OPTS = ("--lastz-mask", "--tandem-mask", "--satellite",
                        "softmask")
PIPE_BLAST_MODES = {"blast": (), "blast_fastga": ("--fastga",),
                    "blast_minimap2": ("--minimap2",)}
# the JAX package's CPU output of each phase 10 run (sha256 of each file;
# "stats" of the stats verb's standard output):
# `JAX_PLATFORMS=cpu python tests/pipeline_digest_report.py`
PIPE_DIGESTS = {'align_mask': 'f820341951d420ec73b6188a7b2fb4572d96b64ac7e03c6198a497e74b39d70f',
 'align_mask_human_dog': 'd0fc34d2b8ab12e41ed81627879dce72f10ff012bca65b25979eb4393886cada',
 'blast': '9df1b5c0bbf8df9ea5a827e2c7576e787e56101d0644401d116af3c79e1ff58a',
 'blast_fastga': '3281e87dca7d45f50ddf84a1abfa96cd9304a95e835b30a7ae9c8038162be8f2',
 'blast_minimap2': 'd3cd3aa2f31cd23a0b30e7d3442628979332d8699cef9e3f27e4adf203c2687f',
 'plan': 'f1016d0f4dfee00b277c94535d24cbfbffc84d2742f50ac4e3a6bd582cf72fab',
 'preprocess': {'simCow_chr6.fa': 'e082485ab0dc60cbe2acae5fd9fd69c7cd700122bd8bb7b16550b1b2d4d2450b',
                'simCow_chr6.satellites.bed': 'b5a524d71e1dc5b8f53030c5d1455d2175065a8a71978da5e85ace407b47f179',
                'simDog_chr6.fa': 'afb4660dd3fab788a50ac149e5b46bef90ffc0b25176a8fd89a59a71e1795730',
                'simDog_chr6.satellites.bed': '479264be77909ecc25a6b40b353d3f38615af0838259c27b0c3a4ae00229dbbe',
                'simHuman_chr6.fa': '1d8a0908e6b07b692e370066095a0aa5e1714d2e6adcd1b7be5cae02137ff0a7',
                'simHuman_chr6.satellites.bed': '7a91d5ac824eeb0c2aa05185eecb37f63b4c85b0b8af9458676394d2bcf80b0d',
                'simMouse_chr6.fa': '4ab900d04f34bf09a3038900dd162e2cf36b0630a148ae607c533c74ebf50b77',
                'simMouse_chr6.satellites.bed': 'ee7878b97fc04bf7405eec9075e1cca1ccd6d3d1cf1056382680e5b08ad9da3c',
                'simRat_chr6.fa': 'e7eab0270390424b656ba351136beebd411c9b552fee2372e33f5ee7d30f6d4a',
                'simRat_chr6.satellites.bed': '76bdb3119fb07e398e7944e5494bbb331cbf11cec7616a527e211246d6b740b7'},
 'stats': 'e8064f92061c822338cea8d222bf7ddc7c80238b20bdf459d34d6cfccf676e1f'}


def repeat_codes(n, seed, families=((300, 1000, 0.12), (6000, 60_000, 0.15),
                                    (2000, 40_000, 0.05)),
                 gap_every=640_000):
    """n random bases with repeat families planted (unit length, one copy
    every so many bases, substitution rate of a copy: Alu-, L1- and
    young-family-like) and 10 kb runs of N (assembly gaps)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    for unit_len, every, div in families:
        unit = rng.integers(0, 4, unit_len, dtype=np.uint8)
        m = n // every
        starts = rng.integers(0, n - unit_len, m)
        idx = (starts[:, None] + np.arange(unit_len)).ravel()
        vals = np.tile(unit, m)
        sub = rng.random(len(vals)) < div
        vals[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
        codes[idx] = vals
    if gap_every:
        for at in rng.integers(0, n - 10_000, n // gap_every):
            codes[at:at + 10_000] = 4
    return codes


def join_pair(seed=PIPE_SEED, n=PIPE_JOIN_LEN):
    """Two related n-base sequences (5% substitutions, 1% indels) sharing
    80 copies of a 300 bp repeat (1% diverged), so that the join's
    per-k-mer cap (max_occ 64) binds."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = repeat_codes(n + 60_000, seed, families=((300, n // 80, 0.01),),
                        gap_every=0)
    t = mutate(rng, base, sub=0.05, indel=0.01)[:n]
    return np.ascontiguousarray(base[:n]), t


def plant_repeats(sim, seed):
    """Plant repeat families into every genome of an evolver run: a young
    family (300 bp, 3% diverged copies, one every 6 kb) that the k-mer
    count masks, an old one (1 kb, 20% diverged, one every 12 kb) that
    it mostly misses, a 40 bp tandem array and an alpha-satellite-like
    array (171 bp x 8) in each sequence.  The families' units are shared
    by all genomes, the copies' places are each genome's own."""
    import numpy as np
    rng = np.random.default_rng(seed)
    units = [(rng.integers(0, 4, n, dtype=np.uint8), every, div)
             for n, every, div in ((300, 6000, 0.03), (1000, 12_000, 0.2))]
    tandem = rng.integers(0, 4, 40, dtype=np.uint8)
    alpha = rng.integers(0, 4, 171, dtype=np.uint8)
    for name in sorted(sim.genomes):
        codes = sim.genomes[name].codes.copy()
        L = len(codes)
        for unit, every, div in units:
            for at in rng.integers(0, L - len(unit), max(1, L // every)):
                copy = unit.copy()
                sub = rng.random(len(unit)) < div
                copy[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
                codes[at:at + len(unit)] = copy
        codes[L // 4:L // 4 + 400] = np.tile(tandem, 10)
        codes[L // 2:L // 2 + 171 * 8] = np.tile(alpha, 8)
        sim.genomes[name].codes = codes


def pipe_inputs(work, evolver, parse_newick):
    """Phase 10's seqfiles under `work`, made with the given package's
    evolver, with repeats planted (`plant_repeats`): {"mammals": phase
    3's five genomes, "pair": phase 5's tree and seed at 24 kb, so that
    its sequences pass the masker's 20 kb contig floor, "human_dog":
    phase 4's pair at 100 kb, whose masked alignment reaches the
    pair-HMM}."""
    seqfiles = {}
    for name, newick, root_len, seed in (
            ("mammals", EVOLVER_MAMMALS_NEWICK, ROOT_LEN, 41),
            ("pair", PIPE_PAIR_NEWICK, 24_000, 7),
            ("human_dog", PECAN_NEWICK, 100_000, 41)):
        sim = evolver.simulate(parse_newick(newick), root_len=root_len,
                               seed=seed)
        plant_repeats(sim, PIPE_SEED)
        seqfiles[name] = evolver.write_seqfile(
            sim, os.path.join(work, f"in_{name}"))
    return seqfiles


def pipe_verb_runs(seqfiles, work):
    """[(run, argv, the file it writes, the kernels it must launch)] of
    `align --mask --maf` on the human-dog pair (its nested refinement
    reaches the pair-HMM) and on the pair seqfile, and of the `blast`
    verb in each aligner mode on the pair seqfile."""
    runs = []
    for run, sf in (("align_mask_human_dog", "human_dog"),
                    ("align_mask", "pair")):
        out = os.path.join(work, f"{run}.maf")
        runs.append((run, ["align", seqfiles[sf], os.path.join(work, run),
                           "--mask", "--maf", out], out,
                     DEFAULT_KERNELS if sf == "human_dog"
                     else ("banded_dp", "banded_traceback")))
    for run, opts in PIPE_BLAST_MODES.items():
        out = os.path.join(work, f"{run}.paf")
        runs.append((run, ["blast", seqfiles["pair"], out, "--events", "a,b",
                           *opts], out, ("banded_dp", "banded_traceback")))
    return runs


def python_on_path(work, args=""):
    """Environment whose `python` runs this interpreter (a script, not a
    link, so that a virtual environment stays on) with `args` after the
    command's own, and that imports the checkout's packages (prepare's
    plan runs `python -m <package>`)."""
    bindir = os.path.join(work, "bin")
    os.makedirs(bindir, exist_ok=True)
    wrapper = os.path.join(bindir, "python")
    with open(wrapper, "w") as fh:
        fh.write(f'#!/bin/sh\nexec {sys.executable} "$@" {args}\n')
    os.chmod(wrapper, 0o755)
    return dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"],
                PYTHONPATH=HERE)


def run_plan(package, seqfile, outdir, work, env, timeout=600):
    """`python -m <package> prepare seqfile outdir --script plan.sh`, then
    `sh plan.sh`, in subprocesses; returns (the plan's commands, wall
    seconds)."""
    script = os.path.join(work, "plan.sh")
    t0 = time.time()
    for argv in ([sys.executable, "-m", package, "prepare", seqfile, outdir,
                  "--script", script], ["sh", script]):
        proc = subprocess.run(argv, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(argv[:4])} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(script) as fh:
        cmds = [ln.strip() for ln in fh
                if ln.strip() and not ln.startswith("#")
                and not ln.startswith("set ")]
    return cmds, time.time() - t0


def phase_mask(dev):
    """Phase 10, step 1: the masker's k-mer count at a chromosome's size,
    on the card and on the CPU."""
    import torch
    from cactus_tpu_torch.preprocessor import masking
    t0 = time.time()
    codes = repeat_codes(PIPE_MASK_LEN, PIPE_SEED)
    log(f"phase 10 mask input: {PIPE_MASK_LEN} bases with planted repeat "
        f"families, seed {PIPE_SEED}, in {time.time() - t0:.1f} s")
    masking.kmer_counts_mask(codes[:1 << 20], device=dev)   # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    got = masking.kmer_counts_mask(codes, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    # the device part alone (upload, hashes, sort, counts), by CUDA events
    busy = time_ms(lambda: masking.kmer_start_mask(codes, 13, 8, dev), 3)
    t0 = time.time()
    want = masking.kmer_counts_mask(codes, device="cpu")
    cpu_wall = time.time() - t0
    if not (got.shape == want.shape and (got == want).all()):
        raise AssertionError(f"phase 10: the card's mask differs from the "
                             f"CPU's at {int((got != want).sum())} positions")
    log(f"phase 10 mask: kmer_counts_mask (k 13, max_count 8, dilate 10) "
        f"on {PIPE_MASK_LEN} bases equal on the card and the CPU; masked "
        f"{want.mean():.4f}; card {wall:.3f} s wall, of it the device part "
        f"(kmer_start_mask: upload, hashes, sort, counts) {busy:.3f} ms by "
        f"CUDA events, the rest host work; device peak {peak / 1e6:.0f} MB "
        f"over the input; CPU {cpu_wall:.2f} s")


def phase_join(dev):
    """Phase 10, step 3: the device seed join at q + t = 4 Mb against the
    host join; each align_contig_pair run through `recorded_run`.
    Returns the kernel calls that differ from their plain versions and
    the kernels a run never launched."""
    import dataclasses

    import numpy as np
    from cactus_tpu_torch.config import Config
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.ops import seeds
    from cactus_tpu_torch.phases import blast
    q, t = join_pair()
    qs, ts = Sequence("q", q), Sequence("t", t)
    cfg = Config.default().blast
    dev_cfg = dataclasses.replace(cfg, seed=dataclasses.replace(
        cfg.seed, device_join_threshold=PIPE_JOIN_THRESHOLD))
    joins, batches, host = [], [], []
    real_join, real_batch = blast._device_join_batch, seeds.seed_join_batch
    real_anchors = blast.anchors_for_tasks

    def join_spy(tasks, idxs, out, *a, **kw):
        t0 = time.time()
        real_join(tasks, idxs, out, *a, **kw)
        joins.append((time.time() - t0, [out[i] for i in idxs]))

    def batch_spy(*a, **kw):
        batches.append((tuple(a[0].shape), kw["max_anchors"], a, kw))
        return real_batch(*a, **kw)

    def anchors_spy(tasks, *a, **kw):
        t0 = time.time()
        out = real_anchors(tasks, *a, **kw)
        host.append((time.time() - t0, out))
        return out

    bad, runs = [], {}
    for run, c, spies in (
            ("join device", dev_cfg, ((blast, "_device_join_batch", join_spy),
                                      (seeds, "seed_join_batch", batch_spy))),
            ("join host", cfg, ((blast, "anchors_for_tasks", anchors_spy),))):
        for owner, attr, spy in spies:
            setattr(owner, attr, spy)
        try:
            runs[run] = recorded_run(dev, lambda c=c: blast.align_contig_pair(
                qs, ts, "q", "t", c, device=dev))
        finally:
            blast._device_join_batch, seeds.seed_join_batch = real_join, \
                real_batch
            blast.anchors_for_tasks = real_anchors
        _recs, launches, wall, peak, recorders = runs[run]
        log(f"phase 10 {run}: align_contig_pair {wall:.1f} s wall, device "
            f"peak {peak / 1e6:.0f} MB, kernel launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        bad += check_recorded(run, recorders, launches, dev)
        bad += [f"{run}: {name} was never launched"
                for name in ("banded_dp", "banded_traceback")
                if launches[name] <= 0]
    # the join's device work alone, each sub-batch by CUDA events
    join_ms = sum(time_ms(lambda a=a, kw=kw: real_batch(*a, **kw), 3)
                  for _shape, _cap, a, kw in batches)
    if len(joins) != 1:
        raise AssertionError(f"phase 10: _device_join_batch ran "
                             f"{len(joins)} times at q + t = "
                             f"{len(q) + len(t)} (threshold "
                             f"{PIPE_JOIN_THRESHOLD}), not once")
    join_s, dev_anchors = joins[0]
    host_join, host = host[0]
    diff = [i for i, ((dq, dt), (hq, ht)) in enumerate(zip(dev_anchors, host))
            if not (np.array_equal(dq, hq) and np.array_equal(dt, ht))]
    if diff or len(dev_anchors) != len(host):
        raise AssertionError(f"phase 10: the device join's anchors differ "
                             f"from the host join's on tasks {diff}")
    dev_recs, host_recs = runs["join device"][0], runs["join host"][0]
    if [r.to_line() for r in dev_recs] != [r.to_line() for r in host_recs]:
        raise AssertionError("phase 10: the PAF records of the device-join "
                             "run differ from the host-join run's")
    per_task = blast.join_bytes_per_task(
        batches[0][0][1], batches[0][0][1], batches[0][1])
    log(f"phase 10 join: {len(q)} + {len(t)} bases, 2 strand tasks, "
        f"{len({b[:2] for b in batches})} bin(s), {len(batches)} "
        f"sub-batch(es) {[b[:2] for b in batches]} (shape, capacity); "
        f"anchors {[len(a[0]) for a in dev_anchors]} equal to the host "
        f"join's; device join {join_s:.3f} s (host copies included; "
        f"seed_join_batch's device work {join_ms:.3f} ms by CUDA events) "
        f"against the host join's {host_join:.3f} s; {len(dev_recs)} PAF "
        f"records equal; the budget counts {per_task / 1e6:.0f} MB a task")
    return bad


def phase_preprocess(dev, seqfile, out):
    """Phase 10, step 2: `preprocess --lastz-mask --tandem-mask --satellite
    softmask` on phase 3's five genomes through `recorded_run`; returns
    the kernel calls that differ from their plain versions, the kernels
    it never launched and the files that differ from the JAX package's."""
    from cactus_tpu_torch import cli
    rc, launches, wall, peak, recs = recorded_run(dev, lambda: cli.main(
        ["preprocess", seqfile, out, *PIPE_PREPROCESS_OPTS]))
    ran = {k: v for k, v in launches.items() if v}
    log(f"phase 10 preprocess {' '.join(PIPE_PREPROCESS_OPTS)} on 5 genomes "
        f"({ROOT_LEN} bp root): exit {rc}, {wall:.1f} s wall, device peak "
        f"{peak / 1e6:.0f} MB, kernel launches {ran}")
    bad = check_recorded("preprocess", recs, launches, dev)
    bad += [f"preprocess/{m}" for m in pan_mismatches(
        pan_digests(out), PIPE_DIGESTS["preprocess"])]
    for name in ("banded_dp", "banded_traceback"):
        if launches[name] <= 0:
            bad.append(f"preprocess: {name} was never launched")
    return bad + ([f"preprocess exited {rc}"] if rc else [])


def phase_plan_and_verbs(dev, seqfiles, work):
    """Phase 10, step 4: prepare's plan run by `sh` in `python -m
    cactus_tpu_torch` subprocesses, and beside it, in process through
    `recorded_run`, `align --mask --maf` and the blast verb in three
    modes, then the stats verb on the plan's store (a subprocess);
    returns the kernel calls that differ from their plain versions, the
    kernels a run never launched and what differs from the JAX package's
    output."""
    from cactus_tpu_torch import cli
    from cactus_tpu_torch.hal_archive import HalArchive
    env = python_on_path(work)
    plan_out = os.path.join(work, "plan")
    bad, plan = [], {}

    def planned():
        try:
            plan["cmds"], plan["secs"] = run_plan(
                "cactus_tpu_torch", seqfiles["pair"], plan_out, work, env)
        except (AssertionError, subprocess.TimeoutExpired) as e:
            plan["err"] = e

    t0 = time.time()
    thread = threading.Thread(target=planned)
    thread.start()
    try:
        for run, argv, out, need in pipe_verb_runs(seqfiles, work):
            rc, launches, wall, _peak, recs = recorded_run(
                dev, lambda argv=argv: cli.main(argv),
                hmm="pairhmm_fwd" in need)
            log(f"phase 10 {run}: exit {rc}, {wall:.1f} s wall, kernel "
                f"launches { {k: v for k, v in launches.items() if v} }")
            bad += check_recorded(run, recs, launches, dev)
            bad += [f"{run}: {name} was never launched" for name in need
                    if launches[name] <= 0]
            if rc:
                bad.append(f"{run} exited {rc}")
            elif sha256_of(out) != PIPE_DIGESTS[run]:
                bad.append(f"{run}: {os.path.basename(out)} sha256 "
                           f"{sha256_of(out)[:16]}... != pinned "
                           f"{PIPE_DIGESTS[run][:16]}...")
    finally:
        thread.join()
    verbs_secs = time.time() - t0
    if "err" in plan:
        return bad + [f"plan: {plan['err']}"]
    cmds = plan["cmds"]
    bad += [f"plan command runs another package: {c}" for c in cmds
            if not c.startswith("python -m cactus_tpu_torch ")]
    maf = os.path.join(plan_out, "out.maf")
    if sha256_of(maf) != PIPE_DIGESTS["plan"]:
        bad.append(f"plan: out.maf sha256 {sha256_of(maf)[:16]}... != "
                   f"pinned {PIPE_DIGESTS['plan'][:16]}...")
    arc = HalArchive.open(os.path.join(plan_out, "out.hal"))
    errs = arc.validate()
    if sorted(arc.genomes()) != ["a", "b", "root"] or errs:
        bad.append(f"plan: out.hal reads back as genomes {arc.genomes()}, "
                   f"validate {errs[:5]}")
    proc = subprocess.run([sys.executable, "-m", "cactus_tpu_torch",
                           "stats", plan_out], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=300)
    got = hashlib.sha256(proc.stdout.encode()).hexdigest()
    if proc.returncode != 0 or got != PIPE_DIGESTS["stats"]:
        bad.append(f"stats exited {proc.returncode}, stdout sha256 "
                   f"{got[:16]}... (pinned {PIPE_DIGESTS['stats'][:16]}...)")
    log(f"phase 10 plan: {len(cmds)} commands, each `python -m "
        f"cactus_tpu_torch`: " + "; ".join(c.split(" ", 4)[3] for c in cmds)
        + f"; prepare + sh plan.sh {plan['secs']:.1f} s; beside it, in "
        f"process, align --mask --maf and blast (default, --fastga, "
        f"--minimap2), {verbs_secs:.1f} s for all; stats on the plan's "
        f"store")
    return bad


def phase_pipeline(dev):
    """The step-by-step pipeline through the port on the card (the module
    docstring's phase 10)."""
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick
    phase_mask(dev)
    work = tempfile.mkdtemp(prefix="smoke_pipe_",
                            dir=os.path.join(HERE, "cactus_tpu_torch",
                                             "_build"))
    try:
        t0 = time.time()
        seqfiles = pipe_inputs(work, evolver, parse_newick)
        log(f"phase 10 inputs: phase 3's five genomes, phase 5's pair and "
            f"phase 4's human-dog pair as seqfiles, {time.time() - t0:.1f} s")
        bad = phase_preprocess(dev, seqfiles["mammals"],
                               os.path.join(work, "prep"))
        bad += phase_join(dev)
        bad += phase_plan_and_verbs(dev, seqfiles, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if bad:
        raise AssertionError("phase 10: launches missing or outputs "
                             "different from the JAX package's pinned CPU "
                             "output:\n  " + "\n  ".join(bad))
    log("phase 10: preprocess, the plan's out.maf, align --mask, blast in "
        "three modes and stats equal the JAX package's CPU output "
        "(sha256); the plan's HAL reads back and validates")


# phase 11's inputs: phase 3's five genomes (EVOLVER_MAMMALS_NEWICK at
# ROOT_LEN, seed 41) aligned into a store, and the genomes the updates
# bring, each evolved from a genome of the same simulation with evolver's
# branch model (seeded by UPD_SEED, in this order): a sixth leaf from the
# ancestor anc1, added under it; a seventh from anc2, added to the branch
# above simCow_chr6; and simDog_chr6's replacement, 1% away from it; then
# simMouse_chr6 is removed
UPD_SEED = 43
UPD_GENOMES = (("simChimp_chr6", "anc1", 0.06),
               ("simSheep_chr6", "anc2", 0.15),
               ("simDog_chr6", "simDog_chr6", 0.01))
# the 2-rank run's chunk size: 4 chunks of each 600 kb genome, so at least
# 16 chunk pairs for each pair of genomes an ancestor aligns
UPD_CHUNK = 200_000
# phast_gff annotates this genome's sequences: the 4d sites phylo_fit is
# held on (the `conservation --annotation` verb reads 4d sites on the
# reference ancestor's sequence names, which no row of its MAF carries,
# so its fit takes no column and returns 1.0 in both packages)
UPD_REF = "simHuman_chr6"
# the neutral scale (phylo_fit) on the card against the JAX package's
# pinned CPU value, and against the port's CPU run: the golden section
# (tol 1e-3) takes the other branch where two evaluations tie within the
# ulps by which two float32 passes differ.  The updated store's MAF reads
# 1.05e-3 on the H100 against the JAX package (0 against the port's CPU
# run); over the inputs of `JAX_PLATFORMS=cpu python
# tests/phast_gap_report.py --seeds 8` the CPU gap reaches 2.55e-3, which
# tests/test_torch_phast.py's FIT_ATOL covers
UPD_SCALE_ATOL = 2e-3
# conservation scores, |got - want| <= tol max(1, |want|) (atol = rtol):
# ratio is a difference of two log-likelihoods (the report: 1.9e-6); LRT
# reads its statistic at the grid maximum (4.8e-4); SCORE divides a second
# difference by h^2 = 0.0025 and squares a first difference,
# U^2 / max(|I|, 1e-3), which magnifies the ulps by ~400 and more where
# |I| nears its floor (0.0415)
PHAST_TOL = {"ratio": 1e-5, "LRT": 1e-3, "SCORE": 0.1}
# the card's phylo_p scores are held to the CPU's on every 4th block of
# the MAF (a quarter of the columns: the CPU's LRT passes over all of them
# took 43 s of phase 11's first chip run)
CONSERVATION_CPU_STRIDE = 4
# the JAX package's CPU output of each phase 11 step: sha256 of the
# store's files (an .npz by its arrays: `store_digests`), of the MAF and
# of the HAL archive; "chunked" the one-process MAF at UPD_CHUNK; the
# neutral scales on the updated store: the conservation verb's without
# and with --annotation ("all", "annotation"), and phylo_fit's on the 4d
# sites of UPD_REF ("4d"):
# `JAX_PLATFORMS=cpu python tests/update_digest_report.py`
UPD_DIGESTS = {'add': {'hal': '4bd494ca4de57de229361163fbbf889fa7cc8a25a4ebfd56356a354ab959938a',
         'maf': '64eff7a6961672224235eab05f323b2b8dea7919618cfdc26e567b6e6403ca30',
         'store': '551fb0ccf6cd051e3e66028d325407a85fb25ba55fc1b2a33ae7eb90ba5942c7'},
 'add_branch': {'hal': 'c20cd286613482cc620264144237a3159ef7113f497e44d188f460815a1cc6cd',
                'maf': '37513fa84c71a717249f6e66cc11a5647b3204ca79c757d7698c2426e77843fe',
                'store': '95018ce44640a4bfd4c9247d62a90e67ac72c1f102a29cc130ab2f7749a578ef'},
 'align': {'hal': '882bd1b4ee6fbc12d8dd57e9400332eb096f112390b00d253c63454b5b6f8701',
           'maf': '67e6997928e1768b2aa7ce0e393adbd2e3aedcf1a9120c02c89ca73767b2bfc3',
           'store': '5393d6a815c520658199c39b881ab1514df1e56b027c2068470a226c4e9bbd1e'},
 'chunked': 'e42732da1c81331b9ecf32c5e49446648dfb762f53bd8f0f9a58c3d8640ec3a5',
 'remove': {'hal': '57682c61f04330ee8dff8ee5007f1d1e71141f27fdc98142f815ecdddce91e9f',
            'maf': '4839a2884004eb696be4380cbb64193da35f2cfbe517562fbfbb591904a318eb',
            'store': '04b1d9dd0cb06f6267b750c6e06b0b33cb07ba3bc0b079cfbe34a9167f8a476c'},
 'replace': {'hal': '9e99123fe095ebf9c32055142a8eda8f32652acc41e33cd59cd4ed66d33c7f57',
             'maf': '1de1a474f2b88a76c682b976554252670c0beb4123c690dff99c84426b0866ef',
             'store': 'b7fb5daf9a6112849cf0e2fb63bf54158a52e014af5c8fb9c97897c4e150243c'}}
UPD_SCALES = {'all': 0.9867315267301777, 'annotation': 1.0, '4d': 0.9567389553374812}


def write_fasta_codes(path, name, codes) -> str:
    """One-sequence FASTA of base codes (0-3 ACGT, 4 N), 60 a line."""
    text = "".join("ACGTN"[c] for c in codes.tolist())
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(text), 60):
            fh.write(text[i:i + 60] + "\n")
    return path


def update_inputs(work, evolver, parse_newick):
    """Phase 11's inputs under `work`, made with the given package's
    evolver: {"seqfile": the five genomes' seqfile, "store", "hal": the
    paths the runs write, and a FASTA for each of UPD_GENOMES}."""
    import numpy as np
    sim = evolver.simulate(parse_newick(EVOLVER_MAMMALS_NEWICK),
                           root_len=ROOT_LEN, seed=41)
    out = {"seqfile": evolver.write_seqfile(sim, os.path.join(work, "in")),
           "store": os.path.join(work, "store"),
           "hal": os.path.join(work, "aln.hal")}
    rng = np.random.default_rng(UPD_SEED)
    for name, src, dist in UPD_GENOMES:
        g = sim.genomes[src]
        codes, _i, _s = evolver._evolve_branch(g.codes, g.anc_idx,
                                               g.anc_strand, dist, rng)
        out[name] = write_fasta_codes(
            os.path.join(work, "in", f"{name}.new.fa"), "chr6", codes)
    return out


def update_argvs(inputs):
    """[(run, argv)] of `align --hal` into the store, then `update add`
    under anc1, `update add --branch` above simCow_chr6, `update replace`
    and `update remove`, each with --hal."""
    store, hal = inputs["store"], inputs["hal"]
    (chimp, _a, d1), (sheep, _b, d2), (dog, _c, _d) = UPD_GENOMES
    return [
        ("align", ["align", inputs["seqfile"], store, "--hal", hal]),
        ("add", ["update", "add", store, chimp, "--fasta", inputs[chimp],
                 "--parent", "anc1", "--branch-length", str(d1),
                 "--hal", hal]),
        ("add_branch", ["update", "add", store, sheep, "--fasta",
                        inputs[sheep], "--branch", "simCow_chr6",
                        "--branch-length", str(d2), "--hal", hal]),
        ("replace", ["update", "replace", store, dog, "--fasta",
                     inputs[dog], "--hal", hal]),
        ("remove", ["update", "remove", store, "simMouse_chr6", "--hal",
                    hal])]


def store_digests(root) -> dict:
    """{relative path: sha256} of a store's files; an .npz by its arrays
    (name, dtype, shape, bytes), since its zip entries carry the time they
    were written."""
    import numpy as np
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(d, f)
            h = hashlib.sha256()
            if f.endswith(".npz"):
                with np.load(p) as z:
                    for k in sorted(z.files):
                        a = z[k]
                        h.update(f"{k} {a.dtype} {a.shape}".encode())
                        h.update(np.ascontiguousarray(a).tobytes())
            else:
                with open(p, "rb") as fh:
                    h.update(fh.read())
            out[os.path.relpath(p, root)] = h.hexdigest()
    return out


def update_digests(store, maf, hal) -> dict:
    """One phase 11 step's readings: the store (`store_digests`, hashed
    again), its MAF and the HAL archive."""
    s = json.dumps(store_digests(store), sort_keys=True).encode()
    return {"store": hashlib.sha256(s).hexdigest(), "maf": sha256_of(maf),
            "hal": sha256_of(hal)}


def phast_gff(path, ref_seqs, seed=UPD_SEED) -> str:
    """A seeded synthetic annotation for `conservation --annotation`: six
    CDS runs a reference sequence on alternating strands, frames 0-2
    (their seqids are the reference's sequence names, as the MAF's)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = []
    for name, seq in sorted(ref_seqs.items()):
        n = len(seq.codes)
        for t in range(6):
            a = int(rng.integers(0, max(1, n - 700)))
            b = min(n, a + 300 + 3 * int(rng.integers(0, 100)))
            lines.append(f"{name}\tsim\tCDS\t{a + 1}\t{b}\t.\t"
                         f"{'+-'[t % 2]}\t{t % 3}\ttranscript_id t{t}\n")
    with open(path, "w") as fh:
        fh.writelines(lines)
    return path


def chunked_run(package, seqfile, out, **kw):
    """The package's ProgressiveAligner on the seqfile's genomes with
    blast.chunk_size UPD_CHUNK, its MAF written to `out`; returns (wall
    seconds, {ancestor: blast tasks} where the driver logs them)."""
    import importlib
    mod = {m: importlib.import_module(f"{package}.{m}")
           for m in ("cli", "config", "progressive", "io.seqfile",
                     "phases.hal")}
    sf = mod["io.seqfile"].SeqFile.parse(seqfile)
    genomes = mod["cli"].load_genomes_from_seqfile(sf)
    cfg = mod["config"].Config.default()
    cfg.blast.chunk_size = UPD_CHUNK
    tasks = {}

    def note(msg):
        if " blast tasks over " in msg:
            anc, rest = msg.split(": ", 1)
            tasks[anc] = tasks.get(anc, 0) + int(rest.split()[0])

    t0 = time.time()
    result = mod["progressive"].ProgressiveAligner(
        sf.tree, genomes, config=cfg, log=note, **kw).run()
    wall = time.time() - t0
    mod["phases.hal"].write_hal2maf(out, result)
    return wall, tasks


RANK_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
from cactus_tpu_torch.parallel import distributed
rank, port, seqfile, out = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
t0 = time.time()
dev = torch.device("cuda", 0)
distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=2, process_id=rank, backend="gloo",
                       device=dev)
wall, tasks = c.chunked_run("cactus_tpu_torch", seqfile, out, n_devices=2,
                            device=dev)
torch.cuda.synchronize(dev)
distributed.shutdown()
with open(out + ".json", "w") as fh:
    json.dump({"wall": wall, "tasks": tasks, "since_start": time.time() - t0,
               "peak": torch.cuda.max_memory_allocated(dev)}, fh)
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_update(dev, inputs):
    """Phase 11, step 1: `align --hal` and the four updates in process,
    each through `recorded_run` and then `hal2maf`; the kernel calls the
    five runs kept are held to their plain versions together after the
    last (one plain batch a row count and band across the runs, as
    `call_groups` makes them).  Returns the kernel calls that differ from
    their plain versions, the kernels a run never launched and the
    readings that differ from the JAX package's."""
    import types
    from cactus_tpu_torch import cli
    bad, kept, total = [], {}, {}
    for run, argv in update_argvs(inputs):
        rc, launches, wall, peak, recs = recorded_run(
            dev, lambda argv=argv: cli.main(argv), hmm=True)
        ran = {k: v for k, v in launches.items() if v}
        log(f"phase 11 {run}: exit {rc}, {wall:.1f} s wall, device peak "
            f"{peak / 1e6:.0f} MB, kernel launches {ran}")
        for name, rec in recs.items():
            kept.setdefault(name, types.SimpleNamespace(fn=rec.fn, calls=[]))
            kept[name].calls += rec.calls
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        bad += [f"{run}: {name} was never launched"
                for name in ("banded_dp", "banded_traceback")
                if launches[name] <= 0]
        if launches["banded_traceback"] != launches["banded_dp"]:
            bad.append(f"{run}: {launches['banded_traceback']} "
                       f"banded_traceback launches for "
                       f"{launches['banded_dp']} banded_dp launches")
        if rc:
            bad.append(f"{run} exited {rc}")
            break
        maf = os.path.join(os.path.dirname(inputs["store"]), f"{run}.maf")
        if cli.main(["hal2maf", inputs["store"], maf]) != 0:
            bad.append(f"{run}: hal2maf failed")
            break
        got = update_digests(inputs["store"], maf, inputs["hal"])
        bad += [f"{run}/{m}" for m in pan_mismatches(
            got, UPD_DIGESTS.get(run, {}))]
    return bad + check_recorded("phase 11's runs", kept, total, dev)


def phase_conservation(dev, store, work):
    """Phase 11, step 2: the conservation verb on the updated store on the
    card (LRT with a --subtree track and --bigwig; ratio with
    --annotation), its neutral scales held to the JAX package's pinned
    values; phylo_fit (every column, and UPD_REF's 4d sites) on the card
    held to the port's CPU run and the JAX package's, and phylo_p's LRT,
    --subtree LRT, SCORE and ratio scores on the card held to the port's
    CPU run (on every CONSERVATION_CPU_STRIDE-th block); then the
    Felsenstein pass on the LRT grid by CUDA events."""
    import numpy as np
    import torch
    from cactus_tpu_torch import cli, phast
    from cactus_tpu_torch.io.bigwig import read_bigwig
    from cactus_tpu_torch.phases import hal as hal_phase
    from cactus_tpu_torch.store import AlignmentStore
    bad = []
    result = AlignmentStore(store).load_result()
    tree = result.tree
    gff = phast_gff(os.path.join(work, "genes.gff"), result.genomes[UPD_REF])
    wig = os.path.join(work, "cons")
    runs = (("LRT", ["--subtree", "anc2", tree.name, "--bigwig"]),
            ("ratio_annotation", ["--annotation", gff]))
    t0 = time.time()
    for name, extra in runs:
        out = f"{wig}.{name}.wig"
        method = name.split("_")[0]
        t1 = time.time()
        rc = cli.main(["conservation", store, out, "--method", method,
                       *extra])
        scale = json.load(open(out + ".mod.json"))["rate_scale"] \
            if rc == 0 else None
        log(f"phase 11 conservation {name}: exit {rc}, "
            f"{time.time() - t1:.1f} s wall, neutral scale {scale!r}")
        if rc:
            bad.append(f"conservation {name} exited {rc}")
            continue
        key = "annotation" if name.endswith("annotation") else "all"
        want = UPD_SCALES.get(key)
        if want is None or abs(scale - want) > UPD_SCALE_ATOL:
            bad.append(f"conservation {name}: neutral scale {scale!r} not "
                       f"within {UPD_SCALE_ATOL} of the JAX package's "
                       f"{want!r}")
    bw, _sizes = read_bigwig(f"{wig}.LRT.wig.anc2.wig.bw")
    verbs_s = time.time() - t0
    # the card against the port's own CPU run, at the card's scale
    blocks = hal_phase.hal2maf(result, None, include_ancestor=False)
    obs, _meta = phast.columns_from_maf(blocks, tree)
    sites = phast.four_d_sites(result.genomes[UPD_REF],
                               phast.gff_cds_transcripts(gff))
    t1 = time.time()
    scales = {d: phast.phylo_fit(blocks, tree, device=d)
              for d in (dev, "cpu")}
    fit_s = time.time() - t1
    scales_4d = {d: phast.phylo_fit(blocks, tree, sites=sites, device=d)
                 for d in (dev, "cpu")}
    for what, got in (("all", scales), ("4d", scales_4d)):
        if abs(got[dev] - got["cpu"]) > UPD_SCALE_ATOL:
            bad.append(f"phylo_fit ({what}) on the card {got[dev]!r}, on "
                       f"the CPU {got['cpu']!r}")
    want = UPD_SCALES.get("4d")
    if want is None or abs(scales_4d[dev] - want) > UPD_SCALE_ATOL:
        bad.append(f"phylo_fit on the 4d sites: {scales_4d[dev]!r} on the "
                   f"card, the JAX package's {want!r}")
    cpu_s, gaps = 0.0, {}
    part = blocks[::CONSERVATION_CPU_STRIDE]
    for method, sub in (("LRT", None), ("LRT", "anc2"), ("SCORE", None),
                        ("ratio", None)):
        got, gmeta = phast.phylo_p(part, tree, scales[dev], method=method,
                                   subtree=sub, device=dev)
        t1 = time.time()
        want, wmeta = phast.phylo_p(part, tree, scales[dev], method=method,
                                    subtree=sub, device="cpu")
        cpu_s += time.time() - t1
        gap = float((np.abs(got - want)
                     / np.maximum(1.0, np.abs(want))).max())
        gaps[f"{method}{'/' + sub if sub else ''}"] = gap
        if gmeta != wmeta or gap > PHAST_TOL[method]:
            bad.append(f"phylo_p {method} subtree {sub}: the card's scores "
                       f"{gap:.3g} (relative) from the CPU's, tolerance "
                       f"{PHAST_TOL[method]}")
    # the Felsenstein pass alone on the LRT grid, by CUDA events
    nE = sum(1 for n in tree.postorder() if n.parent is not None)
    grid = np.full((33, nE), scales[dev])
    obs_dev = torch.from_numpy(obs).to(dev)
    phast.column_ll_multi(obs_dev, tree, grid, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms = time_ms(lambda: phast.column_ll_multi(obs_dev, tree, grid,
                                               device=dev), 3)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del obs_dev
    log(f"phase 11 conservation: {len(obs)} columns x {obs.shape[1]} events; "
        f"the verbs {verbs_s:.1f} s ({len(bw)} sequences in the --subtree "
        f"bigwig); phylo_fit card {scales[dev]!r} / CPU {scales['cpu']!r} "
        f"({fit_s:.1f} s for both), on {sum(len(v) for v in sites.values())} "
        f"4d sites of {UPD_REF} card {scales_4d[dev]!r} / CPU "
        f"{scales_4d['cpu']!r}; scores card vs CPU, relative gap "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (on {len(gmeta)} columns of every "
        f"{CONSERVATION_CPU_STRIDE}th block, CPU runs {cpu_s:.1f} s); the "
        f"Felsenstein pass on the LRT grid "
        f"(33 rates): {ms:.3f} ms by CUDA events (host copy of the "
        f"(33, C) result included), device peak {peak / 1e6:.0f} MB above "
        f"the observations")
    return bad


def start_ranks(inputs, work):
    """Two `chunked_run` ranks sharing cuda:0 in a gloo group, each a
    subprocess (`RANK_WORKER`) started now; returns [(Popen, MAF path)]."""
    port = free_port()
    script = os.path.join(work, "rank_worker.py")
    with open(script, "w") as fh:
        fh.write(RANK_WORKER)
    env = dict(os.environ, PYTHONPATH=HERE)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = []
    for rank in range(2):
        out = os.path.join(work, f"rank{rank}.maf")
        procs.append((subprocess.Popen(
            [sys.executable, script, HERE, str(rank), str(port),
             inputs["seqfile"], out], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out))
    return procs


def finish_ranks(procs, timeout=600) -> list[str]:
    """Waits for the ranks (kills both if one outlasts `timeout`); returns
    what failed."""
    bad = []
    for p, out in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _o in procs:
                q.kill()
                q.wait()
            return [f"a rank outlasted {timeout} s"]
        if p.returncode:
            bad.append(f"rank writing {os.path.basename(out)} exited "
                       f"{p.returncode}:\n"
                       + stdout.decode(errors="replace")[-3000:])
    return bad


def phase_parallel(dev, inputs, work):
    """Phase 11, step 3: two ranks sharing cuda:0 over gloo run
    ProgressiveAligner(n_devices=2) at blast.chunk_size UPD_CHUNK beside
    the one-process run in this process, and beside them `python -m
    cactus_tpu_torch.parallel.dryrun 1` in a 1-rank NCCL group; both
    ranks' MAFs must equal the one-process MAF, and that the JAX package's
    digest."""
    env = dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0")
    t0 = time.time()
    dry = subprocess.Popen([sys.executable, "-m",
                            "cactus_tpu_torch.parallel.dryrun", "1"],
                           cwd=HERE, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    procs = start_ranks(inputs, work)
    try:
        ref = os.path.join(work, "one.maf")
        wall, tasks = chunked_run("cactus_tpu_torch", inputs["seqfile"], ref,
                                  device=dev)
    finally:
        bad = finish_ranks(procs)
        try:
            text, _ = dry.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            dry.kill()
            text, _ = dry.communicate()
        dry_s = time.time() - t0
    if (dry.returncode != 0 or "backend nccl" not in text
            or "in a process group: ok" not in text):
        bad.append(f"dryrun in a 1-rank NCCL group exited "
                   f"{dry.returncode}:\n{text[-3000:]}")
    log(f"phase 11 dry run: `python -m cactus_tpu_torch.parallel.dryrun 1` "
        f"in a 1-rank NCCL group beside the ranks, exit {dry.returncode}, "
        f"{dry_s:.1f} s")
    if bad:
        return bad
    want = sha256_of(ref)
    if want != UPD_DIGESTS.get("chunked"):
        bad.append(f"chunked: one-process MAF sha256 {want[:16]}... != "
                   f"pinned {str(UPD_DIGESTS.get('chunked'))[:16]}...")
    walls, equal = [], True
    for _p, out in procs:
        info = json.load(open(out + ".json"))
        walls.append(info)
        if sha256_of(out) != want:
            equal = False
            bad.append(f"{os.path.basename(out)} differs from the "
                       "one-process MAF")
        few = {a: n for a, n in info["tasks"].items() if n < 16}
        if few or not info["tasks"]:
            bad.append(f"ancestors with under 8 chunk pairs (16 strand "
                       f"tasks): {few or info['tasks']}")
    log(f"phase 11 parallel: one process {wall:.1f} s wall at chunk_size "
        f"{UPD_CHUNK}; two gloo ranks on cuda:0 beside it, "
        + "; ".join(f"rank {r} {w['wall']:.1f} s ({w['since_start']:.1f} s "
                    f"from its start), peak {w['peak'] / 1e6:.0f} MB"
                    for r, w in enumerate(walls))
        + f"; blast tasks an ancestor {walls[0]['tasks']}; "
        f"{'both MAFs equal' if equal else 'NOT both equal'} to the "
        "one-process MAF")
    return bad


def store_work(dev, what, steps):
    """Runs `steps(inputs, work)` on phase 11's inputs in a work directory
    of their own (removed after) and raises with what it returned."""
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick
    work = tempfile.mkdtemp(prefix="smoke_store_",
                            dir=os.path.join(HERE, "cactus_tpu_torch",
                                             "_build"))
    try:
        bad = steps(update_inputs(work, evolver, parse_newick), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if bad:
        raise AssertionError(f"phase 11 ({what}): launches missing or "
                             "outputs different from the JAX package's "
                             "pinned CPU output or the port's CPU run:\n  "
                             + "\n  ".join(bad))


def phase_store(dev):
    """The store, its updates and conservation through the port on the
    card (the module docstring's phase 11, steps 1 and 2)."""
    def steps(inputs, work):
        t0 = time.time()
        bad = phase_update(dev, inputs)
        t1 = time.time()
        if not any("exited" in b for b in bad):
            bad += phase_conservation(dev, inputs["store"], work)
        log(f"phase 11 walls: store and updates {t1 - t0:.1f} s, "
            f"conservation {time.time() - t1:.1f} s")
        return bad

    store_work(dev, "store", steps)
    log("phase 11: the store and every update equal the JAX package's CPU "
        "output (store, MAF, HAL); conservation within the CPU run's "
        "tolerances")


def phase_store_parallel(dev):
    """The multi-device runtime through the port on the card (the module
    docstring's phase 11, step 3), on inputs of its own."""
    t0 = time.time()
    store_work(dev, "parallel", lambda inputs, work:
               phase_parallel(dev, inputs, work))
    log(f"phase 11 parallel: both ranks' MAFs equal the one-process MAF, "
        f"{time.time() - t0:.1f} s")


def dump_banded(recorder, path):
    """Save the inputs of every banded_dp call a path made (host copies)
    with torch.save, for tests/banded_sweep_report.py --replay."""
    import torch
    calls = [([x.cpu() for x in a[:5]], {k: int(v) for k, v in kw.items()})
             for a, kw in recorder.calls]
    torch.save({"calls": calls, "submat": recorder.calls[0][0][5].cpu()},
               path)
    log(f"saved the inputs of {len(calls)} banded_dp calls to {path}")


def dump_pairhmm(recorder, path):
    """Save the inputs of every pairhmm_fwd call the default path made
    (host copies) with torch.save, for tests/pairhmm_sweep_report.py
    --replay."""
    import torch
    calls = [([x.cpu() for x in a], dict(kw)) for a, kw in recorder.calls]
    torch.save({"calls": calls}, path)
    log(f"saved the inputs of {len(calls)} pairhmm_fwd calls to {path}")


def dump_pairhmm5(recorder, path):
    """Save the inputs of every pairhmm5_fwd call the pecan path made
    (host copies; the parameters as a dict) with torch.save, for
    tests/pairhmm_sweep_report.py --model 5 --replay."""
    import dataclasses
    import torch
    calls = [([x.cpu() for x in a],
              {k: (dataclasses.asdict(v) if k == "params" else int(v))
               for k, v in kw.items()}) for a, kw in recorder.calls]
    torch.save({"calls": calls}, path)
    log(f"saved the inputs of {len(calls)} pairhmm5_fwd calls to {path}")


def dump_poa(recorders, path):
    """Save the inputs of every poa_chain and poa_affine call the poa paths
    made, and of every poa_linear call of poa_msa without params (host
    copies; n_nodes too) with torch.save, for tests/poa_sweep_report.py
    --replay."""
    import torch
    out = {}
    for name, rec in recorders.items():
        if name in ("poa_chain", "poa_affine", "poa_linear"):
            out[name] = [([x.cpu() for x in a],
                          {k: (v.cpu() if torch.is_tensor(v) else v)
                           for k, v in kw.items()}) for a, kw in rec.calls]
    torch.save(out, path)
    log(f"saved the inputs of " + ", ".join(
        f"{len(v)} {k}" for k, v in out.items()) + f" calls to {path}")


def run_cli(argv, what):
    """One `python -m cactus_tpu_torch` subprocess; raises unless it
    exits 0."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "cactus_tpu_torch", *argv],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return time.time() - t0


def phase_cli():
    """`python -m cactus_tpu_torch align` on a two-genome seqfile: the
    default config with --maf, then a pecan config XML with --hal and
    --maf."""
    from cactus_tpu_torch.hal_archive import HalArchive
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick
    work = tempfile.mkdtemp(prefix="smoke_cli_",
                            dir=os.path.join(HERE, "cactus_tpu_torch",
                                             "_build"))
    try:
        sim = evolver.simulate(parse_newick("(a:0.05,b:0.05)root;"),
                               root_len=20_000, seed=7)
        seqfile = evolver.write_seqfile(sim, work)
        maf = os.path.join(work, "out", "aln.maf")
        secs = run_cli(["align", seqfile, os.path.join(work, "out"), "--maf",
                        maf], "align")
        size = os.path.getsize(maf)
        if size <= 0:
            raise AssertionError("align wrote an empty MAF")
        log(f"python -m cactus_tpu_torch align: exit 0, {size} byte MAF, "
            f"{secs:.1f} s")
        xml = os.path.join(work, "pecan.xml")
        with open(xml, "w") as fh:
            fh.write(PECAN_XML)
        out = os.path.join(work, "pecan")
        maf = os.path.join(out, "aln.maf")
        hal = os.path.join(out, "aln.hal")
        secs = run_cli(["align", seqfile, out, "--config", xml, "--hal", hal,
                        "--maf", maf], "align --config pecan.xml --hal")
        size = os.path.getsize(maf)
        if size <= 0:
            raise AssertionError("align --config pecan.xml wrote an empty MAF")
        arc = HalArchive.open(hal)
        errs = arc.validate()
        if sorted(arc.genomes()) != ["a", "b", "root"] or errs:
            raise AssertionError(f"the HAL archive reads back as genomes "
                                 f"{arc.genomes()}, validate {errs[:5]}")
        stats = {r["genome"]: r["length"] for r in arc.stats()}
        log(f"python -m cactus_tpu_torch align --config pecan.xml --hal "
            f"--maf: exit 0, {size} byte MAF, {os.path.getsize(hal)} byte HAL "
            f"read back by HalArchive (genome lengths {stats}, validate "
            f"clean), {secs:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def child_phases() -> dict:
    """{name: (label, fn(dev, errs))} of the phases whose numbers the
    kernels line does not time: they run in child processes (`--phases`)
    once the timed phases are done."""
    return {
        "kernels": ("phase 2 (kernels vs plain versions)",
                    phase_kernels_vs_plain),
        "cli": ("phase 5 (CLI)", lambda dev, errs: phase_cli()),
        "poa_kernels": ("phase 6 (POA kernels vs plain versions)",
                        phase_poa_kernels_vs_plain),
        "pangenome": ("phase 9 (the pangenome builder)",
                      lambda dev, errs: phase_pangenome(dev)),
        "pipeline": ("phase 10 (the step-by-step pipeline)",
                     lambda dev, errs: phase_pipeline(dev)),
        "store": ("phase 11 (update, conservation)",
                  lambda dev, errs: phase_store(dev)),
        "parallel": ("phase 11 (parallel)",
                     lambda dev, errs: phase_store_parallel(dev))}


def run_phases(names, errs_out, dev) -> int:
    """A child's work: the named phases in order, on the kernels the
    parent built; writes the largest kernel-vs-plain gaps to errs_out."""
    phase_build()
    phases = child_phases()
    errs: dict[str, float] = {}
    for name in names:
        label, fn = phases[name]
        t0 = time.time()
        fn(dev, errs)
        log(f"{label} {time.time() - t0:.1f} s")
    if errs_out:
        with open(errs_out, "w") as fh:
            json.dump(errs, fh)
    return 0


def run_children(groups, timeout) -> dict:
    """One `chip_smoke.py --phases` child a group, all started at once;
    waits for them, kills every child still running when one fails or
    `timeout` seconds pass, and relays each child's output in order (its
    standard output to ours, its errors to ours).  Returns the largest
    kernel-vs-plain gaps the children saw; raises if one failed."""
    work = tempfile.mkdtemp(prefix="smoke_children_",
                            dir=os.path.join(HERE, "cactus_tpu_torch",
                                             "_build"))
    kids, failed, errs = [], [], {}
    try:
        for i, group in enumerate(groups):
            out = os.path.join(work, f"{i}")
            with open(out + ".out", "w") as so, open(out + ".err", "w") as se:
                kids.append((group, out, subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     "--phases", ",".join(group), "--errs-out",
                     out + ".json"], cwd=HERE, stdout=so, stderr=se)))
        end = time.time() + timeout
        running = list(kids)
        while running and not failed:
            time.sleep(1)
            for kid in list(running):
                if kid[2].poll() is not None:
                    running.remove(kid)
                    if kid[2].returncode:
                        failed.append(f"{','.join(kid[0])} exited "
                                      f"{kid[2].returncode}")
            if running and time.time() > end:
                failed += [f"{','.join(k[0])} outlasted {timeout:.0f} s"
                           for k in running]
    finally:
        for group, out, proc in kids:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for ext, stream in ((".out", sys.stdout), (".err", sys.stderr)):
                with open(out + ext) as fh:
                    stream.write(fh.read())
                stream.flush()
            if os.path.exists(out + ".json"):
                with open(out + ".json") as fh:
                    for k, v in json.load(fh).items():
                        errs[k] = max(errs.get(k, 0.0), v)
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise AssertionError("child phases failed: " + "; ".join(failed))
    return errs


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive cactus_tpu_torch on one "
                                 "CUDA GPU (see the module docstring).")
    ap.add_argument("--dump-banded", metavar="PATH",
                    help="also save the default path's banded_dp inputs "
                    "there (tests/banded_sweep_report.py --replay)")
    ap.add_argument("--dump-pairhmm", metavar="PATH",
                    help="also save the default path's pairhmm_fwd inputs "
                    "there (tests/pairhmm_sweep_report.py --replay)")
    ap.add_argument("--dump-pairhmm5", metavar="PATH",
                    help="also save the pecan path's (600 kb) pairhmm5_fwd "
                    "inputs there (tests/pairhmm_sweep_report.py --model 5 "
                    "--replay)")
    ap.add_argument("--dump-poa", metavar="PATH",
                    help="also save both poa paths' poa_chain and poa_affine "
                    "inputs and poa_msa's poa_linear inputs there "
                    "(tests/poa_sweep_report.py --replay)")
    ap.add_argument("--phases", help="run only these untimed phases "
                    "(comma-separated names of child_phases()), on "
                    "kernels already built: how the script runs them "
                    "in child processes")
    ap.add_argument("--errs-out", metavar="PATH",
                    help="with --phases: write the kernel-vs-plain gaps "
                    "there")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "cactus_tpu_torch")):
        return fail("run from a checkout: cactus_tpu_torch/ is missing")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    if opts.phases:
        return run_phases(opts.phases.split(","), opts.errs_out, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(f"source sha256 {source_digest()} (chip_smoke.py and "
        "cactus_tpu_torch/ but its build outputs)")
    t_all = time.time()
    phase_build()
    errs: dict[str, float] = {}
    t0 = time.time()
    launches, recorders = phase_main_path(dev)
    log(f"phase 3 (default path) {time.time() - t0:.1f} s")
    t0 = time.time()
    rows = measure(recorders, launches, errs, dev)
    log(f"kernel timing {time.time() - t0:.1f} s")
    if opts.dump_banded:
        dump_banded(recorders["banded_dp"], opts.dump_banded)
    if opts.dump_pairhmm:
        dump_pairhmm(recorders["pairhmm_fwd"], opts.dump_pairhmm)
    t0 = time.time()
    p_launches, p_recorders = phase_pecan(dev)
    log(f"phase 4 (pecan path) {time.time() - t0:.1f} s")
    if opts.dump_pairhmm5:
        dump_pairhmm5(p_recorders["pairhmm5_fwd"], opts.dump_pairhmm5)
    t0 = time.time()
    rows += measure_pecan(p_recorders, p_launches, errs, dev)
    log(f"5-state kernel timing {time.time() - t0:.1f} s")
    t0 = time.time()
    poa_launches, poa_recorders = phase_poa(dev)
    lin_launches, lin_recorders = phase_poa_linear(dev)
    if opts.dump_poa:
        dump_poa({**poa_recorders, **lin_recorders}, opts.dump_poa)
    log(f"phase 7 (poa path) {time.time() - t0:.1f} s")
    t0 = time.time()
    rows += measure_poa({**poa_recorders, **lin_recorders},
                        {**poa_launches, **lin_launches}, errs, dev)
    log(f"POA kernel timing {time.time() - t0:.1f} s")
    t0 = time.time()
    rows += phase_wide(dev, errs)
    log(f"phase 8 (the wide routes) {time.time() - t0:.1f} s")
    log(f"timed phases {time.time() - t_all:.1f} s")
    t0 = time.time()
    child_errs = run_children(CHILD_GROUPS, CHILD_DEADLINE_S
                              - (time.time() - t_all))
    for row in rows:
        row["max_abs_err"] = max(row["max_abs_err"],
                                 child_errs.get(row["name"], 0.0))
    log(f"untimed phases (2, 5, 6, 9, 10, 11) in {len(CHILD_GROUPS)} "
        f"child processes at once {time.time() - t0:.1f} s; total "
        f"{time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
