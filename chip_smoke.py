#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cactus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--dump-banded PATH]

Run from the root of a checkout on a machine with one CUDA GPU and the
CUDA toolkit.  It imports nothing of JAX or of the cactus_tpu package.

1. Prints the card's name and power limit (nvidia-smi), builds every
   CUDA kernel of the port from cactus_tpu_torch/csrc/ (one nvcc per
   source, in parallel) and the native C++ host kernels.
2. Holds each kernel against its plain PyTorch version on the card:
   banded_dp at bands 128, 512, 2048 and 16384 with ragged pairs and at
   bands 8-1024 on the live-cell edge cases (m = 0, n = 0, n < m,
   |n - m| = band - 1), with max_live as the path passes it (end scores,
   end states and the live cells' direction bytes bit-equal; it logs the
   live cells beside the band cells), banded_traceback against the host
   traceback_band (equal), pairhmm_fwd/pairhmm_bwd at bands 512 and 2048
   with 4096 rows, and pairhmm5_fwd/pairhmm5_bwd at bands 1024, 2048 and
   4096 with pieces of up to 3000 rows and at band 16384 (posterior max
   |diff| <= HMM_ATOL).
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
   every call of the path one at a time, kernel by kernel: banded_dp;
   banded_traceback on each banded_dp call's outputs made again, with
   the S the path derives (each held equal to the host traceback; it
   logs the steps walked, and times its longest-walk call beside a
   latency line: the longest walk x one shared-memory step); and
   pairhmm_fwd, then pairhmm_bwd on each forward call's outputs made
   again.  Each replay logs its total, by band, and its longest call.
   With --dump-banded it saves banded_dp's calls' inputs to PATH.
4. Runs the pecan path (partialOrderAlignment off: the cPecan BAR engine
   with the 5-state pair-HMM) on the human-dog leaf pair of the same
   tree, seed 41: first at root_len 60 kb, held within PECAN_TOL of the
   JAX package's CPU accuracy reading there, then at 600 kb, held to the
   gate's per-pair floors (recall > 0.80, precision > 0.85).  Each run
   sets the launch counts to 0 just before it and reads them just after,
   and must have launched pairhmm5_fwd and pairhmm5_bwd; it prints the
   wall, the per-phase split, the device's peak memory, the pair-HMM
   cells and the widest band.  Then it times the two 5-state kernels and
   their plain versions on the 600 kb run's largest inputs, and replays
   the 600 kb run's calls as for pairhmm_fwd / pairhmm_bwd.
5. Runs `python -m cactus_tpu_torch align` on a small two-genome seqfile
   in subprocesses, with the default config and --maf, then with a pecan
   config XML and --hal and --maf, and checks the MAFs and that the
   port's HalArchive reads the HAL back and validates it.
6. Holds the three POA kernels against their plain versions on the card,
   bit for bit: poa_affine on bubbled DAGs with forward predecessors
   (N 64-4096, bands 64, 512, 4096 and 16384, ragged queries, band
   offsets jumping by up to 3), poa_chain on chains with source pad nodes
   (the dominant bin P 16,000 x N 64 x B 64, offsets stepping by 0/1, and
   band 16384 on its global row ring) and poa_linear up to L 2048.
7. Runs the poa path (BAR msa_engine="poa") on the evolverMammals tree at
   600 kb, seed 41, tree_workers=2, and on a 4-leaf star tree at 200 kb,
   seed 41, each held to the gate's bar and within POA_TOL of the JAX
   package's CPU reading (tests/poa_accuracy_report.py); the first must
   launch poa_chain, the second poa_affine and poa_chain.  Each run sets
   the launch counts to 0 just before it and reads them just after, and
   prints the wall, the per-phase split, the device's peak memory, the
   problems and the cells used vs padded, and the largest Nb and B.  Then
   poa_msa without params (the linear-gap DP) on seeded groups must
   launch poa_linear and build the graphs the CPU run builds.  Then it
   times the three POA kernels and their plain versions on the largest
   inputs their paths gave them, and replays each path's calls (kept as
   host copies) by bin.

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
# posterior tolerance: the posterior is exp(lsF + lsB - logZ), a
# difference of float32 sums of per-row log-scales that reach ~1e4 over
# 4096 rows, where one float32 ulp is ~1e-3; the kernels also sum the
# in-row chains in another order than the plain Kogge-Stone scan
HMM_ATOL = 5e-3
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
# assumption, not measured here) before the next address is known
SMEM_STEP_CYCLES = 30


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


def replay_calls(name, calls, timed, group_of, shape_of, unit):
    """A path's calls of one kernel again, one at a time on the idle card:
    the kernel's own time, without the other ancestor thread's work or
    host gaps inside the path's events.  timed(args, kw) does what the
    call needs first (move host copies to the card, run the kernel that
    makes its inputs) and returns the function to time; each is timed by
    time_ms with 3 launches after a warm-up.  Logs the calls, the replayed
    total, the total by group (band or bin) and the longest call with its
    shape; returns the total in ms."""
    by_group: dict = {}
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


def smem_step_ns() -> tuple[float, str]:
    """One dependent shared-memory step of a traceback walk, in ns: an
    assumed SMEM_STEP_CYCLES cycles at the card's maximum SM clock (read
    with nvidia-smi).  Returns (ns, what it assumed)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    mhz = float(out.strip().splitlines()[0])
    return (SMEM_STEP_CYCLES / mhz * 1e3,
            f"{SMEM_STEP_CYCLES} cycles at {mhz:.0f} MHz")


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


def phase_build():
    from cactus_tpu_torch.native import build as native
    from cactus_tpu_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build()
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
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
    log(f"banded_dp {what} ({P} pairs x {M} rows, max_live {live_w}, "
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


def phase_kernels_vs_plain(dev, errs):
    """Every kernel against its plain version at the path's shapes."""
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import pairhmm5_cuda, pairhmm_cuda
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

    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions()).to(dev)
    for band in (512, 2048):
        pairs = ragged_pairs(band + 7, 4, 2100, 4096, band)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        args = to_device(packed, dev)
        hk = dict(band=band, delta=p.delta, epsilon=p.epsilon)
        fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **hk)
        post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **hk)
        torch.cuda.synchronize()
        fM_r, lsF_r, logZ_r = tp.forward_banded(*args, em, **hk)
        post_r = tp.backward_posterior(fM_r, lsF_r, logZ_r, *args, em, **hk)
        if not bool(torch.isfinite(post).all()):
            raise AssertionError(f"pairhmm band {band}: non-finite posterior")
        d_post = float((post - post_r).abs().max())
        d_ls = float((lsF - lsF_r).abs().max())
        rel_fm = float(((fM - fM_r).abs() / fM_r.abs().clamp_min(1e-6))
                       .max())
        log(f"pairhmm band {band} ({args[0].shape[0]} pairs x "
            f"{args[0].shape[1]} rows): posterior max|diff| {d_post:.3g} "
            f"(tolerance {HMM_ATOL}), lsF max|diff| {d_ls:.3g}, "
            f"fM max rel diff {rel_fm:.3g}")
        if d_post > HMM_ATOL:
            raise AssertionError(f"pairhmm band {band}: posterior differs by "
                                 f"{d_post} > {HMM_ATOL}")
        errs["pairhmm_fwd"] = max(errs.get("pairhmm_fwd", 0.0),
                                  float((fM - fM_r).abs().max()))
        errs["pairhmm_bwd"] = max(errs.get("pairhmm_bwd", 0.0), d_post)

    # pecan pieces: a divergence-trained p_match, MUM-split pieces of up
    # to 3000 rows at bands 1024-4096, and band 16384 (use_banding off)
    p5 = tp5.Hmm5Params(p_match=0.7)
    em5 = torch.from_numpy(p5.emissions()).to(dev)
    for band, n, lo_len, hi_len in ((1024, 4, 1500, 3000),
                                    (2048, 2, 2000, 3000),
                                    (4096, 2, 2500, 3000),
                                    (16384, 2, 600, 1000)):
        pairs = ragged_pairs(band + 11, n, lo_len, hi_len, band,
                             sub=0.2, indel=0.06)
        packed = tb.pack_band_batch(pairs, band, min_batch=1)
        args = to_device(packed, dev)
        hk = dict(band=band, params=p5)
        fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em5, **hk)
        post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em5, **hk)
        torch.cuda.synchronize()
        fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em5, **hk)
        post_r = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em5,
                                         **hk)
        if not bool(torch.isfinite(post).all()):
            raise AssertionError(f"pairhmm5 band {band}: non-finite "
                                 "posterior")
        d_post = float((post - post_r).abs().max())
        d_ls = float((lsF - lsF_r).abs().max())
        log(f"pairhmm5 band {band} ({args[0].shape[0]} pairs x "
            f"{args[0].shape[1]} rows, longest {int(args[2].max())}): "
            f"posterior max|diff| {d_post:.3g} (tolerance {HMM_ATOL}), "
            f"lsF max|diff| {d_ls:.3g}, max posterior "
            f"{float(post.max()):.4f}")
        if d_post > HMM_ATOL:
            raise AssertionError(f"pairhmm5 band {band}: posterior differs "
                                 f"by {d_post} > {HMM_ATOL}")
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
    log("longest banded_dp calls (ms [P, M] band max_live): " + "; ".join(
        f"{ms:.3f} {shape} {band} {live}"
        for ms, shape, band, live in sorted(dp_calls, reverse=True)[:6]))
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
    (`replay_calls`)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    out = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name], max_abs_err=errs.get(name, 0.0),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, shape=shape, replayed_ms=replayed_ms)
    log(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); the "
        f"path's calls replayed {replayed_ms:.3f} ms")
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
    log(f"banded_dp at [{P}, {M}, {B}]: max_live {max_live}, "
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

    dp_replayed = replay_calls(
        "banded_dp", calls, lambda a, k: (lambda: fn(*a, **k)),
        lambda a, k: k["band"], dp_shape, "band")
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
    d_post = float((post - post_r).abs().max())
    if d_post > HMM_ATOL:
        raise AssertionError(f"pairhmm posterior differs by {d_post} on the "
                             "main path's inputs")
    errs["pairhmm_bwd"] = max(errs.get("pairhmm_bwd", 0.0), d_post)
    errs["pairhmm_fwd"] = max(errs.get("pairhmm_fwd", 0.0),
                              float((fM - fM_r).abs().max()))
    del fM_r, lsF_r, logZ_r, post_r
    rows_, live = int(m.sum()), int((m > 0).sum())
    true_cells = rows_ * B
    # the rows the pairs use, as for banded_dp; float32 cells out (fM) and
    # in again (fM read by the backward pass, post written)
    in_bytes = rows_ + rows_ + live * B + 12 * P + 144
    fwd_replayed, bwd_replayed = replay_hmm("pairhmm",
                                            recorders["pairhmm_fwd"].calls,
                                            fwd, bwd, dev)
    ms = time_ms(lambda: fwd(*args, **kw), 10)
    plain_ms = time_ms(lambda: tp.forward_banded(*args, **kw), 1)
    row("pairhmm_fwd", "cactus_tpu_torch/csrc/pairhmm.cu",
        "cactus_tpu/ops/pairhmm_pallas.py:108", ms, plain_ms,
        in_bytes + 4 * true_cells + 4 * rows_ + 4 * P,
        pairhmm_cuda.PAIRHMM_FWD_FLOPS_PER_CELL * true_cells, FP32_OPS_PER_S,
        [P, M, B], fwd_replayed)
    ms = time_ms(lambda: bwd(fM, lsF, logZ, *args, **kw), 10)
    plain_ms = time_ms(lambda: tp.backward_posterior(fM, lsF, logZ, *args,
                                                     **kw), 1)
    row("pairhmm_bwd", "cactus_tpu_torch/csrc/pairhmm.cu",
        "cactus_tpu/ops/pairhmm_pallas.py:183", ms, plain_ms,
        in_bytes + 4 * true_cells + 4 * rows_ + 4 * P + 4 * true_cells,
        pairhmm_cuda.PAIRHMM_BWD_FLOPS_PER_CELL * true_cells, FP32_OPS_PER_S,
        [P, M, B], bwd_replayed)
    log("no single PyTorch call computes the banded affine DP, its "
        "traceback or the pair-HMM passes: library_ms is null")
    return rows


def on_device(args, dev):
    """A kept call's arguments on the card (host copies moved back)."""
    import torch
    return tuple(x.to(dev) if torch.is_tensor(x) else x for x in args)


def replay_hmm(name, calls, fwd, bwd, dev):
    """A pair-HMM's forward calls replayed one at a time, then its
    backward passes, each on the forward pass's outputs for the same call
    made again (untimed); returns the two totals in ms."""
    def shape(a, k):
        return list(a[0].shape) + [k["band"]]

    def fwd_timed(a, k):
        a = on_device(a, dev)
        return lambda: fwd(*a, **k)

    def bwd_timed(a, k):
        a = on_device(a, dev)
        fM, lsF, logZ = fwd(*a, **k)
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
        work = {"cells": 0, "padded": 0, "band": 0, "calls": 0}
        lock = threading.Lock()

        def cells5(args, kw):
            q, m = args[0], args[2]
            with lock:
                work["cells"] += int(m.sum()) * kw["band"]
                work["padded"] += q.shape[0] * q.shape[1] * kw["band"]
                work["band"] = max(work["band"], kw["band"])
                work["calls"] += 1
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
            f"band cells ({work['padded']} padded), widest band "
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


def measure_pecan(recorders, launches, errs, dev):
    """The 5-state kernels and their plain versions on the pecan path's
    largest inputs, beside the bound for the same work."""
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    from cactus_tpu_torch.ops import pairhmm5_cuda

    args, kw = recorders["pairhmm5_fwd"].best
    P, M = args[0].shape
    B = kw["band"]
    fwd = recorders["pairhmm5_fwd"].fn
    bwd = recorders["pairhmm5_bwd"].fn
    fM, lsF, logZ = fwd(*args, **kw)
    post = bwd(fM, lsF, logZ, *args, **kw)
    # the plain versions take tens of seconds here: each is run and timed
    # once, and its output is the reference
    plain = {}
    plain_fwd_ms = time_ms(
        lambda: plain.update(f=tp5.forward_banded5(*args, **kw)), 1,
        warmup=False)
    fM_r, lsF_r, logZ_r = plain["f"]
    plain_bwd_ms = time_ms(
        lambda: plain.update(b=tp5.backward_posterior5(fM_r, lsF_r, logZ_r,
                                                       *args, **kw)), 1,
        warmup=False)
    d_post = float((post - plain["b"]).abs().max())
    log(f"pairhmm5 on the pecan path's largest inputs ({P} pairs x {M} "
        f"rows, band {B}): posterior max|diff| {d_post:.3g} (tolerance "
        f"{HMM_ATOL})")
    if d_post > HMM_ATOL:
        raise AssertionError(f"pairhmm5 posterior differs by {d_post} on the "
                             "pecan path's inputs")
    errs["pairhmm5_bwd"] = max(errs.get("pairhmm5_bwd", 0.0), d_post)
    errs["pairhmm5_fwd"] = max(errs.get("pairhmm5_fwd", 0.0),
                               float((fM - fM_r).abs().max()))
    del fM_r, lsF_r, logZ_r, post, plain
    fwd_replayed, bwd_replayed = replay_hmm(
        "pairhmm5", recorders["pairhmm5_fwd"].calls, fwd, bwd, dev)
    in_bytes, cells, scal = hmm5_bytes(args, B)
    ms = time_ms(lambda: fwd(*args, **kw), 5)
    rows = [kernel_row(
        "pairhmm5_fwd", "cactus_tpu_torch/csrc/pairhmm5.cu",
        "cactus_tpu/ops/pairhmm5_pallas.py:56", launches, errs, ms,
        plain_fwd_ms, in_bytes + 4 * cells + scal,
        pairhmm5_cuda.PAIRHMM5_FWD_FLOPS_PER_CELL * cells, FP32_OPS_PER_S,
        [P, M, B], fwd_replayed)]
    ms = time_ms(lambda: bwd(fM, lsF, logZ, *args, **kw), 5)
    rows.append(kernel_row(
        "pairhmm5_bwd", "cactus_tpu_torch/csrc/pairhmm5.cu",
        "cactus_tpu/ops/pairhmm5_pallas.py:143", launches, errs, ms,
        plain_bwd_ms, in_bytes + 4 * cells + scal + 4 * cells,
        pairhmm5_cuda.PAIRHMM5_BWD_FLOPS_PER_CELL * cells, FP32_OPS_PER_S,
        [P, M, B], bwd_replayed))
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


def phase_poa_kernels_vs_plain(dev, errs):
    """The three POA kernels against their plain versions, bit for bit."""
    import numpy as np
    import torch
    from cactus_tpu_torch.config import PoaParams
    from cactus_tpu_torch.ops import banded as tb
    from cactus_tpu_torch.ops import poa as tpoa
    from cactus_tpu_torch.ops import poa_cuda

    sub = torch.from_numpy(tb.score_matrix_6(PoaParams().sub_matrix)).to(dev)
    cases = [  # kernel, P, N, L, B
        ("poa_affine", 8, 64, 60, 64), ("poa_affine", 4, 512, 500, 512),
        ("poa_affine", 3, 1024, 3000, 512),
        ("poa_affine", 1, 4096, 3000, 4096),
        ("poa_affine", 1, 2048, 10000, 16384),
        ("poa_chain", 16000, 64, 63, 64),
        ("poa_chain", 64, 200, 900, 128), ("poa_chain", 4, 1024, 3000, 512),
        ("poa_chain", 1, 512, 9000, 16384)]
    for k, (name, P, n, l, band) in enumerate(cases):
        inputs = poa_batch(k, P, n, l, band, chain=name == "poa_chain")
        if poa_cuda.chain_certified(inputs[1], inputs[2]) != (
                name == "poa_chain"):
            raise AssertionError(f"{name} case {k}: wrong certificate")
        args = [torch.from_numpy(x).to(dev) for x in inputs] + [sub]
        got = getattr(poa_cuda, name)(*args, band=band, **POA_GAPS)
        torch.cuda.synchronize()
        ref = tpoa.poa_align_scan_affine(*args, band=band, **POA_GAPS)
        for what, g, r in zip(("H", "dirs", "ends"), got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} P {P} N {n} L {l} B {band}: "
                                     f"{what} differs from the plain version")
        errs[name] = 0.0
        log(f"{name} ({P} problems x {n} nodes, L up to {l}, band {band}): "
            "H, dirs and ends bit-equal")
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
        errs["poa_linear"] = 0.0
        log(f"poa_linear ({n} nodes, L {l}): H, dirs and ends bit-equal")


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
                   lambda a, kw: a[0].shape[0] * (a[2].shape[0] + 1),
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


def measure_poa(recorders, launches, errs, dev):
    """The three POA kernels and their plain versions on the largest
    inputs their paths gave them, beside the bound for the same work, and
    each path's calls replayed one at a time, by bin."""
    import torch
    from cactus_tpu_torch.ops import poa as tpoa
    from cactus_tpu_torch.ops import poa_cuda

    rows = []

    def replayed(name, shape_of):
        """The path's calls of `name` replayed, by bin: the shape but P."""
        fn = recorders[name].fn

        def timed(a, k):
            a = on_device(a, dev)
            return lambda: fn(*a, **k)

        return replay_calls(name, recorders[name].calls, timed,
                            lambda a, k: tuple(shape_of(a, k)[-2:]),
                            shape_of, "bin")

    for name in ("poa_affine", "poa_chain"):
        args, kw = recorders[name].best
        args = on_device(args, dev)
        P, N = args[0].shape
        B = kw["band"]
        fn = recorders[name].fn
        got = fn(*args, **kw)
        plain = {}
        plain_ms = time_ms(lambda: plain.update(
            r=tpoa.poa_align_scan_affine(*args, **kw)), 1, warmup=False)
        for g, r in zip(got, plain["r"]):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} differs from its plain version "
                                     "on its path's largest input")
        errs[name] = 0.0
        del got, plain
        ms = time_ms(lambda: fn(*args, **kw), 10)
        real, cols, extra = poa_used(args, B)
        cells = int((real * cols).sum())
        # bases, preds, off per real node, the query codes, the lengths and
        # the matrix in; H and dirs of the used cells and ends out
        bytes_ = (int(real.sum()) * (1 + 16 + 4 + 4) + int(cols.sum())
                  + 4 * P + 144
                  + cells * poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL)
        ops = (poa_cuda.POA_AFFINE_OPS_PER_CELL * cells
               + poa_cuda.POA_AFFINE_OPS_PER_EXTRA_PRED
               * int((extra * cols).sum()))
        line = {"poa_affine": "cactus_tpu/ops/poa_pallas.py:397",
                "poa_chain": "cactus_tpu/ops/poa_pallas.py:915"}[name]
        total = replayed(name, lambda a, k: [*a[0].shape, k["band"]])
        rows.append(kernel_row(name, "cactus_tpu_torch/csrc/poa.cu", line,
                               launches, errs, ms, plain_ms, bytes_, ops,
                               INT32_OPS_PER_S, [P, N, B], total))
        log(f"{name}: {cells} cells used of {P * N * B} computed")

    (bases, preds, q), kw = recorders["poa_linear"].best
    bases, preds, q = on_device((bases, preds, q), dev)
    fn = recorders["poa_linear"].fn
    got = fn(bases, preds, q, **kw)
    plain = {}
    plain_ms = time_ms(lambda: plain.update(
        r=tpoa.poa_align_scan(bases, preds, q, **kw)), 1, warmup=False)
    for g, r in zip(got, plain["r"]):
        if not torch.equal(g, r):
            raise AssertionError("poa_linear differs from its plain version "
                                 "on its path's largest input")
    errs["poa_linear"] = 0.0
    ms = time_ms(lambda: fn(bases, preds, q, **kw), 20)
    N = int(((preds >= 0).any(dim=1).nonzero().max()) + 1)
    L = int((q != 5).nonzero().max()) + 1
    slots = int((preds[:N] >= 0).sum(dim=1).clamp(min=1).sum())
    cells = N * (L + 1)
    row = kernel_row(
        "poa_linear", "cactus_tpu_torch/csrc/poa.cu",
        "cactus_tpu/ops/poa_pallas.py:42", launches, errs, ms, plain_ms,
        N * (1 + 16) + L + cells * poa_cuda.POA_LINEAR_OUT_BYTES_PER_CELL
        + 4 * N,
        poa_cuda.POA_LINEAR_OPS_PER_CELL * cells
        + poa_cuda.POA_LINEAR_OPS_PER_PRED * slots * (L + 1),
        INT32_OPS_PER_S, [int(bases.shape[0]), int(q.shape[0]) + 1],
        replayed("poa_linear", lambda a, k: [a[0].shape[0],
                                             a[2].shape[0] + 1]))
    rows.append(row)
    log(f"poa_linear: {cells} cells used of "
        f"{bases.shape[0] * (q.shape[0] + 1)} computed")
    log("no single PyTorch call computes a POA DP: library_ms is null")
    return rows


def dump_banded(recorder, path):
    """Save the inputs of every banded_dp call a path made (host copies)
    with torch.save, for tests/banded_sweep_report.py --replay."""
    import torch
    calls = [([x.cpu() for x in a[:5]], {k: int(v) for k, v in kw.items()})
             for a, kw in recorder.calls]
    torch.save({"calls": calls, "submat": recorder.calls[0][0][5].cpu()},
               path)
    log(f"saved the inputs of {len(calls)} banded_dp calls to {path}")


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


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive cactus_tpu_torch on one "
                                 "CUDA GPU (see the module docstring).")
    ap.add_argument("--dump-banded", metavar="PATH",
                    help="also save the default path's banded_dp inputs "
                    "there (tests/banded_sweep_report.py --replay)")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "cactus_tpu_torch")):
        return fail("run from a checkout: cactus_tpu_torch/ is missing")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
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
    phase_kernels_vs_plain(dev, errs)
    log(f"phase 2 (kernels vs plain versions) {time.time() - t0:.1f} s")
    t0 = time.time()
    launches, recorders = phase_main_path(dev)
    log(f"phase 3 (default path) {time.time() - t0:.1f} s")
    t0 = time.time()
    rows = measure(recorders, launches, errs, dev)
    log(f"kernel timing {time.time() - t0:.1f} s")
    if opts.dump_banded:
        dump_banded(recorders["banded_dp"], opts.dump_banded)
    t0 = time.time()
    p_launches, p_recorders = phase_pecan(dev)
    log(f"phase 4 (pecan path) {time.time() - t0:.1f} s")
    t0 = time.time()
    rows += measure_pecan(p_recorders, p_launches, errs, dev)
    log(f"5-state kernel timing {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_cli()
    log(f"phase 5 (CLI) {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_poa_kernels_vs_plain(dev, errs)
    log(f"phase 6 (POA kernels vs plain versions) {time.time() - t0:.1f} s")
    t0 = time.time()
    poa_launches, poa_recorders = phase_poa(dev)
    lin_launches, lin_recorders = phase_poa_linear(dev)
    log(f"phase 7 (poa path) {time.time() - t0:.1f} s")
    t0 = time.time()
    rows += measure_poa({**poa_recorders, **lin_recorders},
                        {**poa_launches, **lin_launches}, errs, dev)
    log(f"POA kernel timing {time.time() - t0:.1f} s; total "
        f"{time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
