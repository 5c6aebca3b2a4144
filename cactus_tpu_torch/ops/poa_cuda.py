"""CUDA kernels of the partial-order alignment DPs: `poa_linear`,
`poa_affine` and `poa_chain`, and the bin router `align_bin`.

Source: csrc/poa.cu (see its header for the design).
- poa_linear replaces the Pallas TPU kernel
  cactus_tpu/ops/poa_pallas.py::_kernel (entry poa_align_scan_pallas).
  Contract: ops/poa.py::poa_align_scan (linear gaps, full width), matched
  bit for bit on the live cells (`linear_live_mask`: the real nodes
  v < n_nodes, columns j <= l_len), the only cells poa_align reads.
- poa_affine replaces ::_affine_kernel (entry
  poa_align_scan_affine_pallas_batch); poa_chain replaces
  ::_chain_kernel on batches that chain_certified() admits.  Contract of
  both: ops/poa.py::poa_align_scan_affine (convex gaps, adaptive band,
  batched over problems), matched bit for bit on each problem's live
  cells (`live_mask`: its n_nodes real nodes, columns off[v] + b <= L),
  the only cells the consumers read (the kernels write no other).  dirs
  is int16: its 13 bits fit, and it halves the bytes the kernels write
  against int32.
- Rows wider than the widest team cover (POA_MAX_COVER cells) take the
  wide route (`poa_route`), csrc/poa_cluster.cu: one thread-block
  cluster a problem on its live row (`cluster_shape`), under the same
  contracts; poa_affine and poa_chain share one kernel (its DAG
  instance keeps history rows in global scratch, its chain instance
  none), poa_linear has its own.  Each route counts its launches under
  its own name ("poa_wide", "poa_linear_wide").
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
import functools

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
# (linear); poa_affine's history rows in global scratch add at most 12
# bytes a band cell (H, F1, F2 of max_live cells rounded up to 4), and so
# do the wide route's on a DAG (its chain launches keep none; the lanes'
# cells past registers take csrc/poa_cluster.cu kAffinePlanes words a
# cell of the cluster's cover a problem, `cluster_shape`, beside them)
POA_AFFINE_OUT_BYTES_PER_CELL = 6
POA_LINEAR_OUT_BYTES_PER_CELL = 5
POA_AFFINE_SCRATCH_BYTES_PER_CELL = 12
POA_WIDE_SCRATCH_BYTES_PER_CELL = 12
# a launch's device footprint cap in align_bin: outputs + scratch of one
# chunk of a shape bin.  4 GiB is 5% of the H100's 80 GB, so the two
# ancestor threads of the progressive driver and the caching allocator
# keep room; the dominant round-1 bin (16,000 problems, Nb 64, B 64) takes
# 0.4 GB and runs as one launch.
POA_MAX_LAUNCH_BYTES = 4 << 30

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "poa_affine_launch": [_VP] * 7 + [_INT] * 14 + [_VP] * 5,
    "poa_chain_launch": [_VP] * 7 + [_INT] * 11 + [_VP] * 4,
    "poa_linear_launch": [_VP] * 3 + [_INT] * 9 + [_VP] * 4,
}
_CLUSTER_SIGNATURES = {
    "poa_cluster_shape": [_INT] * 3 + [_VP],
    "poa_wide_launch": [_VP] * 7 + [_INT] * 12 + [_VP] * 6,
    "poa_linear_wide_launch": [_VP] * 3 + [_INT] * 7 + [_VP] * 5,
}
# csrc/poa_cluster.cu's clusters: up to POA_CLUSTER_MAX_CTAS CTAs a
# problem, 4 cells a lane in registers in CTAs of up to 512 threads (16 x
# 512 x 4: 32,768 cells, both kernels); past that, CTAs of
# POA_CLUSTER_SCRATCH_THREADS threads with the lanes' cells in global
# scratch, so every width runs
POA_CLUSTER_MAX_CTAS = 16
POA_CLUSTER_CELLS = 4
POA_CLUSTER_REG_THREADS = 512
POA_CLUSTER_SCRATCH_THREADS = 512


def _lib() -> ctypes.CDLL:
    return cuda_build.bind("poa", _SIGNATURES)


def _cluster_lib() -> ctypes.CDLL:
    return cuda_build.bind("poa_cluster", _CLUSTER_SIGNATURES)


def cluster_shape(max_live: int, max_ctas: int = 0,
                  linear: bool = False) -> dict:
    """The cluster a wide launch takes for this max_live (csrc/
    poa_cluster.cu poa_shape, at most max_ctas CTAs when it is above 0;
    needs the card): ctas, threads a CTA, cells a lane, registers (whether
    a lane's cells live in registers) and words, the int32 words of
    global scratch a problem's lanes need (0 in registers; `linear`:
    poa_linear's kernel, else poa_affine's and poa_chain's)."""
    lib = _cluster_lib()
    out = (ctypes.c_longlong * 5)()
    cuda_build.check(lib, lib.poa_cluster_shape(max_live, max_ctas,
                                                int(linear), out),
                     "poa_cluster_shape")
    return dict(ctas=out[0], threads=out[1], cells=out[2],
                registers=bool(out[3]), words=out[4])


def _scratch(P: int, shape: dict, dev):
    """The lanes' global scratch of a wide launch (None in registers)."""
    if shape["words"] == 0:
        return None
    return torch.empty((P, shape["words"]), dtype=torch.int32, device=dev)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def poa_linear(bases, preds, q, gap: int, match: int, mismatch: int,
               n_nodes: int | None = None, l_len: int | None = None):
    """Linear-gap POA of one query against one graph: (H (N, L+1) int32,
    dirs (N, L+1) uint8, ends (N,) int32).

    bases (N,) uint8, preds (N, MAX_PREDS) int32 (-1 pad), q (L,) uint8,
    all on one device.  On the card only the live cells are specified
    (`linear_live_mask`): the real nodes v < n_nodes (default N; the
    caller owns that no real node has a predecessor at or past it) and
    the columns j <= l_len (default L: the query codes past l_len are
    pad); ends (column L) on the real nodes when l_len is L.  The team is
    sized by the live row l_len + 1 (`team_shape`); rows wider than
    POA_MAX_COVER take the wide kernel (`poa_route`)."""
    if bases.device.type == "cpu":
        return poa_align_scan(bases, preds, q, gap=gap, match=match,
                              mismatch=mismatch)
    N = bases.shape[0]
    L = q.shape[0]
    n = N if n_nodes is None else int(n_nodes)
    ll = L if l_len is None else int(l_len)
    return _launch_linear(bases, preds, q, gap, match, mismatch, n, ll,
                          poa_route(ll + 1))


def _launch_linear(bases, preds, q, gap: int, match: int, mismatch: int,
                   n: int, ll: int, route: str, max_ctas: int = 0):
    """poa_linear's launch on the named route ("wide" runs the cluster
    kernel at any width, with at most max_ctas CTAs when it is above 0:
    the card tests and tests/poa_sweep_report.py force it at narrow widths
    and other cluster sizes): checks the tensors and the live extents,
    allocates the outputs, launches on the current stream and counts the
    launch."""
    dev = bases.device
    N = bases.shape[0]
    L = q.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f"n_nodes {n} outside 0..{N}")
    if not 0 <= ll <= L:
        raise ValueError(f"l_len {ll} outside 0..{L}")
    check = cuda_build.check_tensor
    check(bases, "bases", torch.uint8, (N,), dev)
    check(preds, "preds", torch.int32, (N, MAX_PREDS), dev)
    check(q, "q", torch.uint8, (L,), dev)
    H = torch.empty((N, L + 1), dtype=torch.int32, device=dev)
    dirs = torch.empty((N, L + 1), dtype=torch.uint8, device=dev)
    ends = torch.empty((N,), dtype=torch.int32, device=dev)
    ptrs = (bases.data_ptr(), preds.data_ptr(), q.data_ptr())
    outs = (H.data_ptr(), dirs.data_ptr(), ends.data_ptr())
    if route == "team":
        name = "poa_linear"
        lib = _lib()
        code = lib.poa_linear_launch(
            *ptrs, n, L, ll, *team_shape(ll + 1, name, 1), int(gap),
            int(match), int(mismatch), *outs, cuda_build.stream(dev))
    else:
        name = "poa_linear_wide"
        lib = _cluster_lib()
        scratch = _scratch(1, cluster_shape(ll + 1, max_ctas, True), dev)
        code = lib.poa_linear_wide_launch(
            *ptrs, n, L, ll, max_ctas, int(gap), int(match), int(mismatch),
            *outs, _ptr(scratch), cuda_build.stream(dev))
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name)
    return H, dirs, ends


def linear_live_mask(N: int, L: int, n_nodes: int, l_len: int, device=None):
    """(N, L+1) bool: poa_linear's live cells, the real nodes v < n_nodes
    and the columns j <= l_len.  The kernel computes only these; H and
    dirs are bit-equal to the plain version there and unspecified
    elsewhere."""
    v = torch.arange(N, device=device)[:, None]
    j = torch.arange(L + 1, device=device)[None, :]
    return (v < n_nodes) & (j <= l_len)


# The team shape (C, TL, NW) of each kernel (csrc/poa.cu Team<C, TL, NW>:
# C cells a lane, TL lanes a team in each of NW warps) by cover, the first
# power of two at or above the launch's widest live row (at least 32).
# The fewest cells a lane (most lanes a problem), which on an H100 won or
# tied at every call of both poa paths: a launch of few problems is bound
# by one node's latency, and a large one keeps more warps in flight;
# poa_chain takes 4 cells a lane from cover 512 on, where 8 warps a
# problem lost to 4 (its barrier a node), and POA_CHAIN_PACKED (two
# problems a warp) at cover 64 from POA_CHAIN_PACKED_PROBLEMS problems
# on (PERF.md section 6).  From cover 8192 a lane holds 16 or 32 cells.
# csrc/poa.cu POA_CHAIN_SHAPES / POA_AFFINE_SHAPES instantiate these and
# no other.
TEAM_SHAPES = {
    "poa_chain": {32: (2, 16, 1), 64: (2, 32, 1), 128: (2, 32, 2),
                  256: (2, 32, 4), 512: (4, 32, 4), 1024: (4, 32, 8),
                  2048: (4, 32, 16), 4096: (8, 32, 16), 8192: (16, 32, 16),
                  16384: (32, 32, 16)},
    "poa_affine": {32: (2, 16, 1), 64: (2, 32, 1), 128: (2, 32, 2),
                   256: (2, 32, 4), 512: (2, 32, 8), 1024: (2, 32, 16),
                   2048: (4, 32, 16), 4096: (8, 32, 16), 8192: (16, 32, 16),
                   16384: (32, 32, 16)},
    # one problem, one team a launch; poa_chain's measured shapes from
    # cover 64 on
    "poa_linear": {32: (1, 32, 1), 64: (2, 32, 1), 128: (2, 32, 2),
                   256: (2, 32, 4), 512: (4, 32, 4), 1024: (4, 32, 8),
                   2048: (4, 32, 16), 4096: (8, 32, 16), 8192: (16, 32, 16),
                   16384: (32, 32, 16)}}
POA_CHAIN_PACKED = (4, 16, 1)
POA_CHAIN_PACKED_PROBLEMS = 4096
# the widest team cover; wider rows take the wide kernels (`poa_route`).
# The poa engine's rows are at most its window + 1 cells wide: 10,001 at
# the default window of 10,000 bases, past this cover from a window of
# about 20,000 (the XML knob partialOrderAlignmentWindow)
POA_MAX_COVER = 16384


def team_cover(max_live: int) -> int:
    """The team's cover for a launch's widest live row: the first power of
    two at or above it, at least 32."""
    return max(32, 1 << (max(1, max_live) - 1).bit_length())


def poa_route(max_live: int) -> str:
    """Which kernel a launch whose widest live row is max_live runs:
    "team" (the team kernels, covers up to POA_MAX_COVER) or "wide" (one
    thread-block cluster a problem on its live row, `cluster_shape`:
    poa_wide for poa_affine and poa_chain, poa_linear_wide for
    poa_linear)."""
    return "team" if max_live <= POA_MAX_COVER else "wide"


def team_shape(max_live: int, kernel: str, problems: int):
    """(C, TL, NW) of a launch of `problems` problems of `kernel`
    ("poa_chain", "poa_affine" or "poa_linear") whose widest live row is
    max_live, on the team route (`poa_route`)."""
    cover = team_cover(max_live)
    if (kernel == "poa_chain" and cover == 64
            and problems >= POA_CHAIN_PACKED_PROBLEMS):
        return POA_CHAIN_PACKED
    return TEAM_SHAPES[kernel][cover]


def history_stride(max_live: int) -> int:
    """Cells a poa_affine history row keeps: max_live rounded up to 4 (a
    cell past the widest live row is never live, and no live cell reads
    one)."""
    return -(-max(1, max_live) // 4) * 4


# shared memory a poa_affine block may give its teams' history rows, of
# the H100's 227 KB a block (the rest: the kernel's staging arrays)
POA_AFFINE_SMEM_ROWS_BYTES = 200 << 10


def affine_rows_in_smem(P: int, rows: int, max_live: int, shape,
                        device) -> bool:
    """Whether poa_affine keeps its teams' history rows (H, F1, F2 of
    `rows` nodes x history_stride cells, 12 bytes a cell) in shared
    memory: for covers up to 256 (csrc/poa.cu instantiates those), when
    a block's rows fit and every problem of the launch is resident at once
    (one-warp blocks hold 32 / TL teams; blocks an SM by shared memory).
    Otherwise the rows go to global scratch, where four-warp blocks keep
    more teams in flight."""
    C, TL, NW = shape
    if C * TL * NW > 256:
        return False
    teams = 1 if NW > 1 else 32 // TL
    block = teams * 3 * rows * history_stride(max_live) * 4
    if block > POA_AFFINE_SMEM_ROWS_BYTES:
        return False
    per_sm = max(1, (227 << 10) // (block + (16 << 10)))
    return P <= _sm_count(torch.device(device).index or 0) * per_sm * teams


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The card's SM count (read once a device: a launch's host work
    paces the small poa_affine launches)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def live_mask(off, l_len, n_nodes, band: int):
    """(P, N, B) bool: the live cells of each problem, its real nodes
    v < n with the band cells b whose column off[v] + b is at most L.  The
    kernels compute only these; H, dirs and ends (real nodes) are
    bit-equal to the plain version there and unspecified elsewhere."""
    P, N = off.shape
    dev = off.device
    v = torch.arange(N, device=dev)[None, :, None]
    b = torch.arange(band, device=dev)[None, None, :]
    return ((v < n_nodes.long()[:, None, None])
            & (off.long()[:, :, None] + b <= l_len.long()[:, None, None]))


def check_live(preds, off, l_len, n_nodes, band: int) -> int:
    """A launch's max_live from its host (numpy) arrays: the widest live
    row, max over the problems' real nodes of min(B, L + 1 - off[v]), at
    least 1 (min(B, L + 1) for the band offsets _affine_prepare makes).
    Raises ValueError when an n is outside 1..N or a node at or past n has
    a predecessor (the pad nodes past a problem's real nodes are sources,
    so n must not cut a real node off).  align_bin passes what it returns
    to the wrappers."""
    P, N = off.shape
    if P == 0:
        return 1
    n = np.asarray(n_nodes, np.int64)
    if n.min() < 1 or n.max() > N:
        raise ValueError(f"n_nodes spans {n.min()}..{n.max()}, outside "
                         f"1..{N}")
    real = np.arange(N)[None, :] < n[:, None]
    if ((preds >= 0).any(axis=2) & ~real).any():
        raise ValueError("a node at or past its problem's n_nodes has a "
                         "predecessor: n cuts a real node off")
    width = np.clip(np.asarray(l_len, np.int64)[:, None] + 1 - off, 0, band)
    return max(1, int(np.where(real, width, 0).max()))


def _live_args(preds, off, l_len, n_nodes, band: int, max_live):
    """n_nodes (default: every node real) and max_live (default:
    check_live on host copies of the inputs, one device sync).  A given
    max_live is the caller's, as chain_certified's certificate is: it
    must cover every live row (align_bin passes check_live's), or the
    cells past the team's cover are not computed.  Raises ValueError
    unless 1 <= max_live <= band."""
    if n_nodes is None:
        P, N = off.shape
        n_nodes = torch.full((P,), N, dtype=torch.int32, device=off.device)
    if max_live is None:
        max_live = check_live(*(t.cpu().numpy()
                                for t in (preds, off, l_len, n_nodes)), band)
    if not 1 <= max_live <= band:
        raise ValueError(f"max_live {max_live} is outside 1..{band}")
    return n_nodes, int(max_live)


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
               o1: int, e1: int, o2: int, e2: int, n_nodes=None,
               max_live: int | None = None):
    """Convex-gap adaptive-band POA of P problems over any DAG: (H
    (P, N, B) int32, dirs (P, N, B) int16, ends (P, N) int32).  Inputs as
    ops/poa.py::poa_align_scan_affine takes them, on one device; q_ext
    must hold at least l_len + 1 codes a row.  On the card only the live
    cells are specified (`live_mask`); n_nodes and max_live as for
    poa_chain.  The teams' history rows go to shared memory where
    `affine_rows_in_smem` says so, else to global scratch; rows wider
    than POA_MAX_COVER take the wide kernel (`poa_route`)."""
    if bases.device.type == "cpu":
        return poa_align_scan_affine(bases, preds, off, q_ext, l_len,
                                     submat, band=band, o1=o1, e1=e1,
                                     o2=o2, e2=e2)
    n_nodes, max_live = _live_args(preds, off, l_len, n_nodes, band,
                                   max_live)
    return _launch("poa_affine", bases, preds, off, q_ext, l_len, submat,
                   band, (o1, e1, o2, e2), n_nodes, max_live,
                   poa_route(max_live))


def poa_chain(bases, preds, off, q_ext, l_len, submat, band: int,
              o1: int, e1: int, o2: int, e2: int, n_nodes=None,
              max_live: int | None = None):
    """poa_affine's contract on certified chain batches (chain_certified
    holds on preds and off; the caller owns the certificate: a batch
    outside it gives wrong alignments, not an error), on the live cells
    (`live_mask`).  n_nodes (P,) int32: each problem's real nodes
    (default: all N); max_live: the launch's widest live row, which sizes
    its teams (default: `check_live` on host copies of the inputs, a
    device sync; align_bin passes it from its host arrays).  Rows wider
    than POA_MAX_COVER take the wide kernel (`poa_route`)."""
    if bases.device.type == "cpu":
        return poa_align_scan_affine(bases, preds, off, q_ext, l_len,
                                     submat, band=band, o1=o1, e1=e1,
                                     o2=o2, e2=e2)
    n_nodes, max_live = _live_args(preds, off, l_len, n_nodes, band,
                                   max_live)
    return _launch("poa_chain", bases, preds, off, q_ext, l_len, submat,
                   band, (o1, e1, o2, e2), n_nodes, max_live,
                   poa_route(max_live))


def _launch(kernel: str, bases, preds, off, q_ext, l_len, submat,
            band: int, gaps, n_nodes, max_live: int, route: str,
            max_ctas: int = 0):
    """The launch of poa_affine or poa_chain (`kernel`) on the named
    route: "team", or "wide", the cluster kernel at any width, with at
    most max_ctas CTAs when it is above 0 (the card tests and
    tests/poa_sweep_report.py force it at narrow widths and other
    cluster sizes).  Checks the tensors, allocates the outputs and
    scratch, launches on the current stream and counts the launch."""
    dev, P, N, H, dirs, ends = _check_affine(bases, preds, off, q_ext,
                                             l_len, submat, band)
    cuda_build.check_tensor(n_nodes, "n_nodes", torch.int32, (P,), dev)
    ins = (bases.data_ptr(), preds.data_ptr(), off.data_ptr(),
           q_ext.data_ptr(), l_len.data_ptr(), n_nodes.data_ptr(),
           submat.data_ptr(), P, N, int(q_ext.shape[1]), band)
    outs = (H.data_ptr(), dirs.data_ptr(), ends.data_ptr())
    gaps = tuple(int(x) for x in gaps)
    stride = history_stride(max_live)
    if route == "wide":
        # the DAG instance's history rows (H, F1, F2 of each node's live
        # cells) and, past registers, the lanes' cells
        name = "poa_wide"
        chain = kernel == "poa_chain"
        hist = None if chain else torch.empty((P, 3, N, stride),
                                              dtype=torch.int32, device=dev)
        scratch = _scratch(P, cluster_shape(max_live, max_ctas), dev)
        lib = _cluster_lib()
        code = lib.poa_wide_launch(
            *ins, max_live, max_ctas, int(chain), stride, *gaps, *outs,
            _ptr(hist), _ptr(scratch), cuda_build.stream(dev))
    elif kernel == "poa_chain":
        name = kernel
        lib = _lib()
        code = lib.poa_chain_launch(
            *ins, *team_shape(max_live, kernel, P), *gaps, *outs,
            cuda_build.stream(dev))
    else:
        name = kernel
        shape = team_shape(max_live, kernel, P)
        smem = affine_rows_in_smem(P, N, max_live, shape, dev)
        hist = None if smem else torch.empty((P, 3, N, stride),
                                             dtype=torch.int32, device=dev)
        lib = _lib()
        code = lib.poa_affine_launch(
            *ins, *shape, int(smem), N, stride, *gaps, *outs, _ptr(hist),
            cuda_build.stream(dev))
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name)
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
              max_launch_bytes: int = POA_MAX_LAUNCH_BYTES,
              n_nodes: np.ndarray | None = None):
    """One shape bin of poa_msa_batch: (dirs (P, N, band) int16, ends
    (P, N) int32) as numpy arrays, specified on each problem's live cells
    (`live_mask`; ends on its real nodes).

    stack holds the stacked numpy inputs (bases, preds, off, q_ext) and
    n_nodes each problem's real nodes (default: all N).  On a CUDA device
    the bin runs poa_chain when chain_certified holds on the host stacks
    and poa_affine otherwise, with max_live from `check_live` on the
    whole bin's host arrays (which also checks n_nodes; a bin whose widest
    live row passes POA_MAX_COVER takes the wide kernel, `poa_route`); on
    the CPU the plain version.  A bin whose outputs and scratch pass
    max_launch_bytes runs in chunks of problems, each with the bin's
    max_live: each problem's rows depend on its own inputs only, so a
    chunked bin equals one launch."""
    P, N = stack["bases"].shape
    if n_nodes is None:
        n_nodes = np.full(P, N, np.int32)
    chain = chain_certified(stack["preds"], stack["off"])
    # the whole bin's widest live row bounds every chunk's
    max_live = check_live(stack["preds"], stack["off"], l_len, n_nodes,
                          band)
    wide = poa_route(max_live) == "wide"
    per_cell = POA_AFFINE_OUT_BYTES_PER_CELL + (
        0 if chain else POA_WIDE_SCRATCH_BYTES_PER_CELL if wide
        else POA_AFFINE_SCRATCH_BYTES_PER_CELL)
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
        nn = torch.from_numpy(np.ascontiguousarray(n_nodes[s:e], np.int32)) \
            .to(device)
        _H, d, en = run(t["bases"], t["preds"], t["off"], t["q_ext"], ll,
                        sub, band=band, o1=o1, e1=e1, o2=o2, e2=e2,
                        n_nodes=nn, max_live=max_live)
        dirs[s:e] = d.cpu().numpy()
        ends[s:e] = en.cpu().numpy()
    return dirs, ends
