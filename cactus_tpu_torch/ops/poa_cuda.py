"""CUDA kernels of the partial-order alignment DPs: `poa_linear`,
`poa_affine` and `poa_chain`, and the bin router `align_bin`.

Source: csrc/poa.cu (see its header for the design).
- poa_linear replaces the Pallas TPU kernel
  cactus_tpu/ops/poa_pallas.py::_kernel (entry poa_align_scan_pallas).
  Contract: ops/poa.py::poa_align_scan (linear gaps, full width).
- poa_affine replaces ::_affine_kernel (entry
  poa_align_scan_affine_pallas_batch); poa_chain replaces
  ::_chain_kernel on batches that chain_certified() admits.  Contract of
  both: ops/poa.py::poa_align_scan_affine (convex gaps, adaptive band,
  batched over problems), matched bit for bit.  dirs is int16: its 13
  bits fit, and it halves the bytes the kernels write against int32.
- Bound on an H100: int32 operations (POA_AFFINE_OPS_PER_CELL and
  POA_LINEAR_OPS_PER_CELL a cell, plus a few per extra predecessor),
  against 6 bytes a cell written (H int32 + dirs int16) for the affine
  DP and 5 for the linear one.

Each wrapper checks its tensors, allocates outputs and scratch, launches
on the current CUDA stream and adds one to its count in
cuda_build.LAUNCHES.  A CPU tensor gets the plain PyTorch version instead
(that is what the CPU tests run); a CUDA tensor always gets the kernel,
or an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .poa import MAX_PREDS, poa_align_scan, poa_align_scan_affine

# int32 operations a cell of the convex DP needs on one predecessor,
# whatever the kernel's design, counting Hopper's DPX fusions as the
# banded DP's bound does (ops/banded_cuda.py): F1 and F2 each open or
# extend with its argmax code (2 subs and a __vibmax_s32: 3 each, 6); the
# diagonal (1 add); h0 = max of three with its source (2 vibmax); the two
# insertion chains, each a running prefix max of h0 + e*b (1
# __viaddmax_s32) and E = max(NEG, prefix - o - e*b) (1 sub, 1 viaddmax:
# 2), 6 for both; H = max(h0, E1, E2) (2); the mask past the query (1
# compare, 5 selects: 6); the move decode (2 selects); the two E-extend
# bits (a sub and a compare each: 4); packing the 13-bit code (4 shifts
# and ors past the move, 3 more for the E bits: 7).  Each predecessor
# beyond the first adds its F1, F2 and diagonal candidates with their
# codes (POA_AFFINE_OPS_PER_EXTRA_PRED).
POA_AFFINE_OPS_PER_CELL = 36
POA_AFFINE_OPS_PER_EXTRA_PRED = 6
# the linear DP: per predecessor slot a diagonal add, a deletion sub and
# the two running first-maxima with their slots (4); per cell the
# emission compare-select (2), h0 and its move (2), the prefix max of
# h0 + gap*j (1 viaddmax), y = prefix - gap*j (1), the insertion compare
# and select (2) and the code pack (2).
POA_LINEAR_OPS_PER_CELL = 10
POA_LINEAR_OPS_PER_PRED = 4
# bytes a cell written: H int32 + dirs int16 (affine), + dirs uint8
# (linear); the affine kernel's F1/F2 history adds 8 scratch bytes a cell
POA_AFFINE_OUT_BYTES_PER_CELL = 6
POA_LINEAR_OUT_BYTES_PER_CELL = 5
# a launch's device footprint cap in align_bin: outputs + scratch of one
# chunk of a shape bin.  4 GiB is 5% of the H100's 80 GB, so the two
# ancestor threads of the progressive driver and the caching allocator
# keep room; the dominant round-1 bin (16,000 problems, Nb 64, B 64) takes
# 0.4 GB and runs as one launch.
POA_MAX_LAUNCH_BYTES = 4 << 30

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "poa_affine_launch": [_VP] * 6 + [_INT] * 8 + [_VP] * 6,
    "poa_chain_launch": [_VP] * 6 + [_INT] * 8 + [_VP] * 5,
    "poa_linear_launch": [_VP] * 3 + [_INT] * 5 + [_VP] * 4,
    "poa_chain_ring_ints": [_INT],
}


def _lib() -> ctypes.CDLL:
    return cuda_build.bind("poa", _SIGNATURES)


def poa_linear(bases, preds, q, gap: int, match: int, mismatch: int):
    """Linear-gap POA of one query against one graph: (H (N, L+1) int32,
    dirs (N, L+1) uint8, ends (N,) int32).

    bases (N,) uint8, preds (N, MAX_PREDS) int32 (-1 pad), q (L,) uint8,
    all on one device."""
    if bases.device.type == "cpu":
        return poa_align_scan(bases, preds, q, gap=gap, match=match,
                              mismatch=mismatch)
    dev = bases.device
    N = bases.shape[0]
    L = q.shape[0]
    check = cuda_build.check_tensor
    check(bases, "bases", torch.uint8, (N,), dev)
    check(preds, "preds", torch.int32, (N, MAX_PREDS), dev)
    check(q, "q", torch.uint8, (L,), dev)
    H = torch.empty((N, L + 1), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, L + 1), dtype=torch.uint8, device=dev)
    ends = torch.empty((N,), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.poa_linear_launch(
        bases.data_ptr(), preds.data_ptr(), q.data_ptr(), N, L, int(gap),
        int(match), int(mismatch), H.data_ptr(), dirs.data_ptr(),
        ends.data_ptr(), cuda_build.stream(dev))
    cuda_build.check(lib, code, "poa_linear")
    cuda_build.count_launch("poa_linear")
    return H, dirs, ends


def _check_affine(bases, preds, off, q_ext, l_len, submat, band: int):
    dev = bases.device
    P, N = bases.shape
    if band < 32 or band & (band - 1):
        raise ValueError(f"band {band} is not a power of two >= 32")
    check = cuda_build.check_tensor
    check(bases, "bases", torch.uint8, (P, N), dev)
    check(preds, "preds", torch.int32, (P, N, MAX_PREDS), dev)
    check(off, "off", torch.int32, (P, N), dev)
    check(q_ext, "q_ext", torch.uint8, (P, q_ext.shape[1]), dev)
    check(l_len, "l_len", torch.int32, (P,), dev)
    check(submat, "submat", torch.int32, (6, 6), dev)
    H = torch.empty((P, N, band), dtype=torch.int32, device=dev)
    dirs = torch.empty((P, N, band), dtype=torch.int16, device=dev)
    ends = torch.empty((P, N), dtype=torch.int32, device=dev)
    return dev, P, N, H, dirs, ends


def poa_affine(bases, preds, off, q_ext, l_len, submat, band: int,
               o1: int, e1: int, o2: int, e2: int):
    """Convex-gap adaptive-band POA of P problems over any DAG: (H
    (P, N, B) int32, dirs (P, N, B) int16, ends (P, N) int32).  Inputs as
    ops/poa.py::poa_align_scan_affine takes them, on one device; q_ext
    must hold at least l_len + 1 codes a row."""
    if bases.device.type == "cpu":
        return poa_align_scan_affine(bases, preds, off, q_ext, l_len,
                                     submat, band=band, o1=o1, e1=e1,
                                     o2=o2, e2=e2)
    dev, P, N, H, dirs, ends = _check_affine(bases, preds, off, q_ext,
                                             l_len, submat, band)
    # the F1/F2 history planes the predecessor gather reads
    F1 = torch.empty((P, N, band), dtype=torch.int32, device=dev)
    F2 = torch.empty((P, N, band), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.poa_affine_launch(
        bases.data_ptr(), preds.data_ptr(), off.data_ptr(), q_ext.data_ptr(),
        l_len.data_ptr(), submat.data_ptr(), P, N, int(q_ext.shape[1]),
        band, int(o1), int(e1), int(o2), int(e2), H.data_ptr(),
        dirs.data_ptr(), ends.data_ptr(), F1.data_ptr(), F2.data_ptr(),
        cuda_build.stream(dev))
    cuda_build.check(lib, code, "poa_affine")
    cuda_build.count_launch("poa_affine")
    return H, dirs, ends


def poa_chain(bases, preds, off, q_ext, l_len, submat, band: int,
              o1: int, e1: int, o2: int, e2: int):
    """poa_affine's contract on certified chain batches (chain_certified
    holds on preds and off; the caller owns the certificate: a batch
    outside it gives wrong alignments, not an error)."""
    if bases.device.type == "cpu":
        return poa_align_scan_affine(bases, preds, off, q_ext, l_len,
                                     submat, band=band, o1=o1, e1=e1,
                                     o2=o2, e2=e2)
    dev, P, N, H, dirs, ends = _check_affine(bases, preds, off, q_ext,
                                             l_len, submat, band)
    lib = _lib()
    ring_ints = lib.poa_chain_ring_ints(band)
    ring = (torch.empty((P * ring_ints,), dtype=torch.int32, device=dev)
            if ring_ints else None)
    code = lib.poa_chain_launch(
        bases.data_ptr(), preds.data_ptr(), off.data_ptr(), q_ext.data_ptr(),
        l_len.data_ptr(), submat.data_ptr(), P, N, int(q_ext.shape[1]),
        band, int(o1), int(e1), int(o2), int(e2), H.data_ptr(),
        dirs.data_ptr(), ends.data_ptr(),
        ring.data_ptr() if ring is not None else None,
        cuda_build.stream(dev))
    cuda_build.check(lib, code, "poa_chain")
    cuda_build.count_launch("poa_chain")
    return H, dirs, ends


def chain_certified(preds: np.ndarray, off: np.ndarray) -> bool:
    """Host certificate for poa_chain over stacked numpy inputs
    (preds (P, N, MAX_PREDS), off (P, N)): every node is a source (no
    predecessor) or has the single predecessor v-1 with a band-offset
    step off[v] - off[v-1] of 0 or 1.

    The JAX package's _chain_check_np (cactus_tpu/ops/poa_pallas.py:1110)
    also demands a predecessor on every node past the first, which the
    pad nodes of a shape bin (sources, poa.py _affine_prepare) never
    have, so it admits a bin only when every graph fills it exactly.
    Admitting sources lets the round-1 bins of poa_msa_batch (graphs
    built by PoaGraph.from_sequence, pad nodes after them) take the
    chain kernel; a source reads the virtual start row, as it does in the
    contract."""
    N = preds.shape[1]
    if N < 1 or (preds[:, :, 1:] >= 0).any():
        return False
    p0 = preds[:, :, 0]
    if (p0[:, 0] >= 0).any():
        return False
    linked = p0[:, 1:] >= 0
    if (linked & (p0[:, 1:] != np.arange(N - 1))).any():
        return False
    dd = np.diff(off.astype(np.int64), axis=1)
    return bool((~linked | ((dd >= 0) & (dd <= 1))).all())


def align_bin(stack: dict, l_len: np.ndarray, submat: np.ndarray,
              band: int, o1: int, e1: int, o2: int, e2: int, device,
              max_launch_bytes: int = POA_MAX_LAUNCH_BYTES):
    """One shape bin of poa_msa_batch: (dirs (P, N, band) int16, ends
    (P, N) int32) as numpy arrays.

    stack holds the stacked numpy inputs (bases, preds, off, q_ext).  On
    a CUDA device the bin runs poa_chain when chain_certified holds on
    the host stacks and poa_affine otherwise; on the CPU the plain
    version.  A bin whose outputs and scratch pass max_launch_bytes runs
    in chunks of problems: each problem's rows depend on its own inputs
    only, so a chunked bin equals one launch."""
    P, N = stack["bases"].shape
    chain = chain_certified(stack["preds"], stack["off"])
    per_cell = POA_AFFINE_OUT_BYTES_PER_CELL + (0 if chain else 8)
    step = max(1, int(max_launch_bytes // (N * band * per_cell)))
    run = poa_chain if chain else poa_affine
    sub = torch.from_numpy(np.ascontiguousarray(submat, np.int32)).to(device)
    dirs = np.empty((P, N, band), np.int16)
    ends = np.empty((P, N), np.int32)
    for s in range(0, P, step):
        e = min(s + step, P)
        t = {k: torch.from_numpy(np.ascontiguousarray(v[s:e])).to(device)
             for k, v in stack.items()}
        ll = torch.from_numpy(np.ascontiguousarray(l_len[s:e], np.int32)) \
            .to(device)
        _H, d, en = run(t["bases"], t["preds"], t["off"], t["q_ext"], ll,
                        sub, band=band, o1=o1, e1=e1, o2=o2, e2=e2)
        dirs[s:e] = d.cpu().numpy()
        ends[s:e] = en.cpu().numpy()
    return dirs, ends
