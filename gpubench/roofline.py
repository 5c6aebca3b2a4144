"""Peaks of one NVIDIA H100 SXM and the work a kernel needs on given pairs.

A kernel's roofline share is its least time over its measured time.  The
least time is the larger of its operations over the peak of their kind
and its bytes over the memory bandwidth, each counted on the pairs the
traced window sent: operations on the live cells (rows 1..m of each
pair, columns 0..n inside the band, the cells that reach any output),
each input byte read once and each output byte written once.  Padding,
dead band cells and re-reads are not counted, so the least time is a
lower bound whatever the kernel's design, and a share can only read low.
The arithmetic per cell is chip_smoke.py's (banded_dp 15 int32
operations a live cell, counting a Hopper DPX instruction as one; the
3-state pair-HMM 17 / 22 float32 operations a cell forward / backward,
the 5-state 38 / 40, an FMA counting as two, as the float32 peak does).

Peaks (NVIDIA H100 SXM5, boost clock, 700 W):
- HBM3 3.35e12 bytes/s and float32 outside the tensor cores 67e12
  operations/s: NVIDIA H100 Tensor Core GPU data sheet.
- int32 16.7e12 operations/s: NVIDIA H100 Tensor Core GPU Architecture
  whitepaper (an SM has 64 INT32 lanes, half its 128 FP32 lanes; 132 SMs
  at 1.98 GHz), i.e. half the float32 instruction rate behind 67e12.
"""

from __future__ import annotations

import numpy as np

from .reference.banded import band_offset

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 16.7e12
PEAKS = {"int32": INT32_OPS_PER_S, "fp32": FP32_OPS_PER_S}

BANDED_OPS_PER_CELL = 15
BANDED_OPS_PER_PAIR = 4
TRACEBACK_OPS_PER_STEP = 8
PAIRHMM_FLOPS = {"pairhmm_fwd": 17, "pairhmm_bwd": 22,
                 "pairhmm5_fwd": 38, "pairhmm5_bwd": 40}


def live_cells(m, n, band: int) -> np.ndarray:
    """Live cells of each pair: sum over rows i = 1..m of the band
    columns b with 0 <= i + lo + b <= n, in closed form per pair."""
    out = np.zeros(len(m), np.int64)
    for p, (mp, np_) in enumerate(zip(m, n)):
        lo = band_offset(int(mp), int(np_), band)
        i = np.arange(1, int(mp) + 1)
        b_lo = np.maximum(0, -i - lo)
        b_hi = np.minimum(band - 1, int(np_) - i - lo)
        out[p] = np.maximum(0, b_hi - b_lo + 1).sum()
    return out


def banded_work(m, n, band: int):
    """(int32 ops, bytes) of banded_dp on these pairs: q's bases and the
    t_shift bytes a pair's rows read, its scalars and the score matrix
    in; a direction byte a live cell, the end scores and state out."""
    live = int(live_cells(m, n, band).sum())
    P = len(m)
    ops = BANDED_OPS_PER_CELL * live + BANDED_OPS_PER_PAIR * P
    bytes_ = int(np.sum(m)) + int(np.sum(np.asarray(n) + 1)) + 12 * P \
        + 144 + live + 16 * P
    return ops, bytes_


def traceback_work(steps: int, pairs: int):
    """(int32 ops, bytes) of banded_traceback: a direction byte read and a
    move written each step, the scalars in and the count out a pair."""
    return TRACEBACK_OPS_PER_STEP * steps, 2 * steps + 20 * pairs


def pairhmm_work(kernel: str, m, n, band: int):
    """(float32 ops, bytes) of a pair-HMM pass on these pairs.  Forward:
    q and t in, a float32 fM a live cell, lsF a row and logZ out.
    Backward: those in again, a float32 posterior a live cell out."""
    live = int(live_cells(m, n, band).sum())
    rows = int(np.sum(m))
    P = len(m)
    seq = rows + int(np.sum(n)) + 12 * P + 144
    cells = 4 * live if kernel.endswith("fwd") else 8 * live
    return PAIRHMM_FLOPS[kernel] * live, seq + cells + 4 * rows + 4 * P


def least_seconds(ops: float, bytes_: float, peak: str) -> float:
    return max(ops / PEAKS[peak], bytes_ / HBM_BYTES_PER_S)


def window_work(ctx, kernel: str):
    """(ops, bytes, peak) of a kernel over every call of the traced window
    (ctx.done: (call index, answers)), or None if the driver has no such
    kernel."""
    if kernel not in ctx.driver.kernels:
        return None
    ops = bytes_ = 0
    peak = None
    for c, answers in ctx.done:
        o, b, peak = ctx.driver.work(c, ctx.workload["calls"][c],
                                     answers)[kernel]
        ops += o
        bytes_ += b
    return ops, bytes_, peak


def kernel_share(ctx, kernel: str):
    """A kernel's least time over its device time in the traced window, in
    %; None where it did not run."""
    from .tracing import kernel_seconds
    work = window_work(ctx, kernel)
    if work is None:
        return None
    seconds = kernel_seconds(ctx.trace, ctx.driver.kernels[kernel], ctx.lo,
                             ctx.hi)
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(*work) / seconds
