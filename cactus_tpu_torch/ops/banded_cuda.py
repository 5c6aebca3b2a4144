"""CUDA kernels of the banded affine DP: `banded_dp` and `banded_traceback`.

Source: csrc/banded.cu (see its header for the design).
- banded_dp replaces the Pallas TPU kernel
  cactus_tpu/ops/banded_pallas.py::_kernel (banded_align_batch_pallas).
  Contract: ops/banded.py::banded_align_batch.  It computes only each
  pair's live cells (`live_mask`), and matches the plain version bit for
  bit on those cells' direction bytes and on the end scores and states.
  Bound on an H100: int32 operations (BANDED_OPS_PER_CELL a live cell;
  one byte a live cell to memory).  Two kernels by the launch's widest
  live row (`dp_kernel`): one warp a pair on a register wavefront up to
  WARP_MAX_LIVE cells, one block a pair past it.
- banded_traceback replaces the on-device while_loop traceback
  (cactus_tpu/ops/banded.py::traceback_band_batch_device) with the host
  semantics of ops/banded.py::traceback_band: count -1 when the walk
  leaves the band.  Bound: the latency of m + n dependent byte reads a
  pair, which the kernel takes from tiles in shared memory (one warp a
  pair, see `banded_traceback`).

Each wrapper checks its tensors, launches on the current CUDA stream and
adds one to its count in cuda_build.LAUNCHES (banded_dp adds its P x M x
band cells to cuda_build.CELLS).  A CPU tensor gets the
plain PyTorch version instead (that is what the CPU tests run); a CUDA
tensor always gets the kernel, or an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .banded import banded_align_batch, traceback_band

# int32 operations a live DP cell needs, whatever the kernel's design (the
# block kernel itself does more: two passes and a scan of the D chain).  Each
# of H, I and D is a max, an add or two and a NEG clamp, and each of
# them leaves its direction bits: H = max(H, I, D) + s with its source
# (2 max, 2 compares, 1 add, 1 clamp, 2 selects: 8); I = max(H - open, I)
# - extend with its fresh bit (1 sub, 1 max, 1 compare, 1 sub, 1 clamp,
# 1 select, 1 or: 7); D the same (7): 22 operations.  Hopper's DPX
# instructions fuse some of them into one instruction: __vibmax_s32 is a
# max that also returns the a >= b predicate, __viaddmax_s32 is
# max(a + b, c), so an add and the clamp after it become one.  That
# leaves H 5 (2 vibmax, 1 viaddmax, 2 selects), I 5 (sub, vibmax,
# viaddmax, select, or) and D 5: BANDED_OPS_PER_CELL = 15.  The end
# capture is once per pair: the first argmax of three, 2 compares and
# 2 selects.  The kernel computes only the live cells (`live_cells`), and
# only they reach any output, so the bound counts them; a band cell
# outside a pair's DP matrix costs nothing in it.  (The band-cell bound,
# m x band cells a pair, counts what the kernel computed before it
# skipped the dead cells: chip_smoke.py logs it beside the live one.)
BANDED_OPS_PER_CELL = 15
BANDED_OPS_PER_PAIR = 4

# the widest live row banded_dp_warp_kernel takes (csrc/banded.cu
# kWarpMaxLive): 8 cells a lane of one warp
WARP_MAX_LIVE = 256

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "banded_dp_launch": [_VP] * 6 + [_INT] * 6 + [_VP] * 4,
    "banded_dp_threads": [_INT] * 3,
    "banded_dp_occupancy": [_INT] * 3,
    "banded_traceback_launch": [_VP] * 5 + [_INT] * 4 + [_VP] * 3,
}


def _lib() -> ctypes.CDLL:
    return cuda_build.bind("banded", _SIGNATURES)


def live_mask(m_len, n_len, lo, M: int, B: int):
    """(P, M, B) bool: the live cells of each pair, the band cells (i, b)
    (row i = 1..M at index i - 1) with i <= m and 0 <= i + lo + b <= n:
    the cells inside the pair's DP matrix."""
    dev = m_len.device
    i = torch.arange(1, M + 1, device=dev)[None, :, None]
    b = torch.arange(B, device=dev)[None, None, :]
    j = i + lo.long()[:, None, None] + b
    return ((i <= m_len.long()[:, None, None]) & (j >= 0)
            & (j <= n_len.long()[:, None, None]))


def live_cells(m_len, n_len, lo, M: int, B: int) -> int:
    """The number of live cells (`live_mask(...).sum()`), from each row's
    live window b = max(0, -i - lo) .. min(B - 1, n - i - lo)."""
    i = torch.arange(1, M + 1, device=m_len.device)[None, :]
    lo_ = lo.long()[:, None]
    b_lo = (-i - lo_).clamp(min=0)
    b_hi = (n_len.long()[:, None] - i - lo_).clamp(max=B - 1)
    width = (b_hi - b_lo + 1).clamp(min=0)
    return int((width * (i <= m_len.long()[:, None])).sum())


def live_width(n_len, band: int) -> int:
    """The widest live row a batch can have: max over pairs of
    min(band, n + 1), a row's live cells being at most the n + 1 columns
    j = 0..n.  0 for no pairs.  n_len: a tensor or a numpy array."""
    if not len(n_len):
        return 0
    return max(0, min(band, int(n_len.max()) + 1))


def check_max_live(n_len, band: int, max_live: int | None) -> int:
    """max_live (default: the band), checked against the pairs' live
    widths min(band, n + 1) (`live_width`): raises ValueError, on either
    device and before any launch, when it is below one of them or below
    1.  Reading n_len back is a device sync only where max_live is below
    the band.  Returns it clipped to the band."""
    if max_live is None:
        max_live = band
    widest = live_width(n_len, band) if max_live < band else 0
    if max_live < max(1, widest):
        raise ValueError(f"max_live {max_live} is below a pair's live width "
                         f"{widest} (min(band, n + 1)) or 1")
    return min(max_live, band)


def dp_kernel(max_live: int) -> str:
    """The kernel a banded_dp launch takes for max_live (clipped to the
    band), as csrc/banded.cu banded_dp_launch picks it: "warp"
    (banded_dp_warp_kernel, one warp a pair) up to WARP_MAX_LIVE cells,
    else "block" (banded_dp_kernel, one block a pair)."""
    return "warp" if max_live <= WARP_MAX_LIVE else "block"


def launch_threads(band: int, max_live: int, pairs: int) -> int:
    """Threads a block banded_dp launches with (csrc/banded.cu
    banded_dp_threads; needs the card): 32, one pair, for the warp
    kernel."""
    return int(_lib().banded_dp_threads(band, max_live, pairs))


def occupancy(band: int, max_live: int, pairs: int) -> int:
    """Resident banded_dp blocks an SM at that launch shape (needs the
    card)."""
    lib = _lib()
    blocks = int(lib.banded_dp_occupancy(band, max_live, pairs))
    cuda_build.check(lib, max(0, -blocks), "banded_dp occupancy")
    return blocks


def banded_dp(q, t_shift, m_len, n_len, lo, submat, band: int,
              gap_open: int, gap_extend: int, max_live: int | None = None):
    """Batched banded global affine DP: (dirs, end_scores, end_mat).

    q (P, M) uint8, t_shift (P, M+band) uint8, m_len/n_len/lo (P,)
    int32, submat (6, 6) int32, all on one device.  Any band >= 1 up to
    16384 (the shared-memory limit of one block).

    On a CUDA device the kernel computes only each pair's live cells
    (`live_mask`: 1 <= i <= m, 0 <= j = i + lo + b <= n).  end_scores,
    end_mat and the dirs bytes of the live cells are bit-equal to the
    plain version; the other dirs bytes are unspecified.  That is all the
    traceback reads: it walks cells with 1 <= i <= m and 1 <= j <= n.
    On a CPU tensor the plain version fills every byte.

    max_live bounds every row's live width (default: the band); it picks
    the kernel (`dp_kernel`: one warp a pair up to WARP_MAX_LIVE cells,
    else one block a pair) and sizes its blocks.  A max_live below some
    pair's min(band, n + 1) (`live_width`) raises, on either device, before
    anything is launched: reading n_len back is a device sync where
    max_live is below the band.  `launch_banded_dp` is the launch after
    that check."""
    max_live = check_max_live(n_len, band, max_live)
    if q.device.type == "cpu":
        return banded_align_batch(q, t_shift, m_len, n_len, lo, submat,
                                  band=band, gap_open=gap_open,
                                  gap_extend=gap_extend)
    return launch_banded_dp(q, t_shift, m_len, n_len, lo, submat, band=band,
                            gap_open=gap_open, gap_extend=gap_extend,
                            max_live=max_live)


def launch_banded_dp(q, t_shift, m_len, n_len, lo, submat, band: int,
                     gap_open: int, gap_extend: int, max_live: int):
    """The kernel launch of `banded_dp` (which checks max_live first):
    checks the CUDA tensors, allocates the outputs, launches on the
    current stream and counts the launch."""
    dev = q.device
    P, M = q.shape
    if not 1 <= band <= 16384:
        raise ValueError(f"band {band} outside 1..16384")
    check = cuda_build.check_tensor
    check(q, "q", torch.uint8, (P, M), dev)
    check(t_shift, "t_shift", torch.uint8, (P, M + band), dev)
    for name, x in (("m_len", m_len), ("n_len", n_len), ("lo", lo)):
        check(x, name, torch.int32, (P,), dev)
    check(submat, "submat", torch.int32, (6, 6), dev)
    dirs = torch.empty((P, M, band), dtype=torch.uint8, device=dev)
    end_scores = torch.empty((P, 3), dtype=torch.int32, device=dev)
    end_mat = torch.empty((P,), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.banded_dp_launch(
        q.data_ptr(), t_shift.data_ptr(), m_len.data_ptr(), n_len.data_ptr(),
        lo.data_ptr(), submat.data_ptr(), P, M, band, min(max_live, band),
        int(gap_open), int(gap_extend), dirs.data_ptr(),
        end_scores.data_ptr(), end_mat.data_ptr(), cuda_build.stream(dev))
    cuda_build.check(lib, code, "banded_dp")
    cuda_build.count_launch("banded_dp", P * M * band)
    return dirs, end_scores, end_mat


def banded_traceback_plain(dirs, m_len, n_len, lo, end_mat, S: int):
    """Plain version: host traceback_band per pair, as reverse-order move
    codes (1=M, 2=I, 3=D) in a (P, S) uint8 array and counts (P,) int32,
    -1 where the walk leaves the band."""
    d = dirs.cpu().numpy()
    P = d.shape[0]
    moves = np.zeros((P, S), np.uint8)
    counts = np.zeros(P, np.int32)
    code = {"M": 1, "I": 2, "D": 3}
    m_np, n_np = m_len.cpu().numpy(), n_len.cpu().numpy()
    lo_np, em_np = lo.cpu().numpy(), end_mat.cpu().numpy()
    for p in range(P):
        try:
            ops = traceback_band(d[p], int(m_np[p]), int(n_np[p]),
                                 int(lo_np[p]), int(em_np[p]))
        except RuntimeError:
            counts[p] = -1
            continue
        mv = np.concatenate([np.full(ln, code[o], np.uint8)
                             for o, ln in ops]) if ops else \
            np.zeros(0, np.uint8)
        if len(mv) > S:
            counts[p] = -1
            continue
        moves[p, :len(mv)] = mv[::-1]
        counts[p] = len(mv)
    return (torch.from_numpy(moves).to(dirs.device),
            torch.from_numpy(counts).to(dirs.device))


def banded_traceback(dirs, m_len, n_len, lo, end_mat, S: int):
    """Walk each pair's direction bytes from (m, n) to (0, 0).

    dirs (P, M, B) uint8; m_len/n_len/lo/end_mat (P,) int32.  Returns
    (moves (P, S) uint8 in reverse order, counts (P,) int32; -1, with no
    moves, when the walk leaves the band or needs more than S moves).

    On a CUDA device one warp walks a pair from tiles of its direction
    bytes in shared memory (csrc/banded.cu): K rows from the walk's
    current row up, by tile_w = min(256, B, S) band columns whose right
    edge lies min(K, tile_w) - 1 columns right of the current column (K
    rows within 16 KB: 113 at band 128, 60 at 256 columns).  The walk only
    climbs, and its band column rises only on an I move, which climbs a
    row, so the next K rows read no byte right of that edge; the warp
    restages when the walk climbs above the tile or a D run crosses its
    left edge.  Each tile row holds the row's live window (the cells
    banded_dp specifies), and every byte the walk reads is a live cell
    (1 <= i <= m, 1 <= j <= n), so every read is staged.  Its floor is
    the longest walk's chain of dependent steps, one shared-memory load
    each; the bytes it moves (2 a step) are far below that."""
    if dirs.device.type == "cpu":
        return banded_traceback_plain(dirs, m_len, n_len, lo, end_mat, S)
    dev = dirs.device
    P, M, B = dirs.shape
    check = cuda_build.check_tensor
    check(dirs, "dirs", torch.uint8, (P, M, B), dev)
    for name, x in (("m_len", m_len), ("n_len", n_len), ("lo", lo),
                    ("end_mat", end_mat)):
        check(x, name, torch.int32, (P,), dev)
    moves = torch.zeros((P, S), dtype=torch.uint8, device=dev)
    counts = torch.empty((P,), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.banded_traceback_launch(
        dirs.data_ptr(), m_len.data_ptr(), n_len.data_ptr(), lo.data_ptr(),
        end_mat.data_ptr(), P, M, B, int(S), moves.data_ptr(),
        counts.data_ptr(), cuda_build.stream(dev))
    cuda_build.check(lib, code, "banded_traceback")
    cuda_build.count_launch("banded_traceback")
    return moves, counts
