"""CUDA kernels of the 5-state pair-HMM: `pairhmm5_fwd` and `pairhmm5_bwd`.

Source: csrc/pairhmm5.cu (see its header for the design).
- pairhmm5_fwd replaces the Pallas TPU kernel
  cactus_tpu/ops/pairhmm5_pallas.py::_fwd_kernel and pairhmm5_bwd
  replaces ::_bwd_kernel (entry posterior_banded_batch5_pallas).
  Contract: ops/pairhmm5.py::forward_banded5 and ::backward_posterior5,
  the two halves of cactus_tpu/ops/pairhmm5.py::posterior_banded_batch5;
  the backward kernel fuses the posterior combine, so bM never reaches
  device memory.  Every row is rescaled, as the contract does.  The nine
  transitions are kernel arguments (the pecan path trains p_match per
  run).
- Bound on an H100: device-memory bytes.  The forward pass writes one
  float32 per cell (PAIRHMM5_FWD_FLOPS_PER_CELL float operations against
  4 bytes); the backward pass reads one and writes one
  (PAIRHMM5_BWD_FLOPS_PER_CELL against 8 bytes).  Both sit below the FP32
  units' balance of 20 operations per byte (67 TFLOP/s over 3.35 TB/s).
- Each pair computes only its live window (rows 1..m, columns j = 0..n),
  and a launch's blocks are sized by max_live, the widest live row of its
  pairs (banded_cuda.live_width): 4 cells a lane, one warp up to 128
  cells.  State rows of up to 8192 cells live in shared memory; wider
  ones in a global-memory scratch row per pair that the wrapper
  allocates (pairhmm5_scratch_floats).
- A launch whose max_live passes PAIRHMM5_MAX_CELLS (65,536 cells, the
  widest the live-window blocks take) runs the cluster kernels
  (`pairhmm5_route`): one thread-block cluster of up to 16 CTAs a pair,
  on the live windows only, the state rows in the CTAs' shared memory up
  to 131,072 cells and in per-pair global scratch past that
  (`cluster_shape`); they count their launches as "pairhmm5_fwd_wide"
  and "pairhmm5_bwd_wide".  So every band runs.  A cluster the card
  cannot schedule raises.

Each wrapper checks its tensors, launches on the current CUDA stream and
adds one to its count in cuda_build.LAUNCHES (the forward pass adds its
P x M x band cells to cuda_build.CELLS).  A CPU tensor gets the
plain PyTorch version instead (that is what the CPU tests run); a CUDA
tensor always gets the kernel, or an error.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .banded_cuda import check_max_live
from .pairhmm5 import Hmm5Params, backward_posterior5, forward_banded5

# float32 operations per cell that the recurrence needs, whatever order a
# kernel sums in (masks are selects, not counted).  Forward: mM 8
# (emit*(mc*fM + ms*(fSX+fSY) + ml*(fLX+fLY))), mSX and mLX 5 each, the
# SY and LY chain cells 5 each (A times the left pair plus the open from
# mM), the band maximum 5 (four adds and a max), the rescale 5.  Backward:
# mm 1, ms*mm and ml*mm 2, nSX and nLX 4 each, the chain cells 4 each,
# nM 7, the band maximum 5, the rescale 5, the posterior fM*bM*g and its
# clip 4.  About twice the 3-state model's (ops/pairhmm_cuda.py).
PAIRHMM5_FWD_FLOPS_PER_CELL = 38
PAIRHMM5_BWD_FLOPS_PER_CELL = 40

_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pairhmm5_fwd_launch": [_VP] * 6 + [_INT] * 4 + [_F] * 9 + [_VP] * 5,
    "pairhmm5_bwd_launch": [_VP] * 9 + [_INT] * 4 + [_F] * 9 + [_VP] * 3,
    "pairhmm5_scratch_floats": [_INT],
    "pairhmm5_threads": [_INT],
    "pairhmm5_cells_per_lane": [_INT],
    "pairhmm5_cluster_shape": [_INT, _VP],
    "pairhmm5_fwd_wide_launch": [_VP] * 6 + [_INT] * 4 + [_F] * 9
    + [_VP] * 5,
    "pairhmm5_bwd_wide_launch": [_VP] * 9 + [_INT] * 4 + [_F] * 9
    + [_VP] * 3,
}
# the widest live row the live-window kernels take (csrc/pairhmm5.cu
# kMaxCells: 32 warps of 64 cells a lane)
PAIRHMM5_MAX_CELLS = 32 * 32 * 64


def pairhmm5_route(max_live: int) -> str:
    """Which kernels a launch whose widest live row is max_live runs:
    "narrow" (the one-block live-window kernels) or "wide" (the cluster
    kernels, past PAIRHMM5_MAX_CELLS)."""
    return "narrow" if max_live <= PAIRHMM5_MAX_CELLS else "wide"


def _lib() -> ctypes.CDLL:
    return cuda_build.bind("pairhmm5", _SIGNATURES)


def _check_inputs(q, t_shift, m_len, n_len, lo, em, band: int):
    dev = q.device
    P, M = q.shape
    check = cuda_build.check_tensor
    check(q, "q", torch.uint8, (P, M), dev)
    check(t_shift, "t_shift", torch.uint8, (P, M + band), dev)
    for name, x in (("m_len", m_len), ("n_len", n_len), ("lo", lo)):
        check(x, name, torch.int32, (P,), dev)
    check(em, "em", torch.float32, (6, 6), dev)
    if band < 1:
        raise ValueError(f"band {band} < 1")
    return dev, P, M


def cluster_shape(max_live: int) -> dict:
    """The cluster a wide launch takes for this max_live (csrc/pairhmm5.cu
    cluster_shape; needs the card): ctas, threads a CTA, cells a lane,
    smem, whether the state rows live in the CTAs' shared memory, and
    fwd_words / bwd_words, the float32 words of global scratch each pass
    needs a pair (0 with smem)."""
    out = (ctypes.c_longlong * 6)()
    cuda_build.check(_lib(), _lib().pairhmm5_cluster_shape(max_live, out),
                     "pairhmm5_cluster_shape")
    return dict(ctas=out[0], threads=out[1], cells=out[2], smem=bool(out[3]),
                fwd_words=out[4], bwd_words=out[5])


def _scratch(lib, P: int, max_live: int, route: str, bwd: bool, dev):
    """Global scratch for the state rows of live windows too wide for
    shared memory (None when they fit), as the C side sizes it: the
    narrow kernels' five rows, or the cluster kernels' words for the
    pass."""
    if route == "wide":
        words = cluster_shape(max_live)["bwd_words" if bwd else "fwd_words"]
    else:
        words = int(lib.pairhmm5_scratch_floats(max_live))
    if words == 0:
        return None
    return torch.empty((P, words), dtype=torch.float32, device=dev)


def launch_threads(max_live: int) -> int:
    """Threads a block both live-window kernels launch with for this
    max_live (csrc/pairhmm5.cu launch_shape; needs the card)."""
    return int(_lib().pairhmm5_threads(max_live))


def cells_per_lane(max_live: int) -> int:
    """Window cells a lane owns for this max_live (needs the card): a
    row computes threads x cells_per_lane cells, the lanes' cover."""
    return int(_lib().pairhmm5_cells_per_lane(max_live))


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _transitions(params: Hmm5Params):
    return [_F(v) for v in params.transitions()]


def pairhmm5_fwd(q, t_shift, m_len, n_len, lo, em, band: int,
                 params: Hmm5Params, max_live: int | None = None):
    """Forward pass: (fM (P, M, B) f32, lsF (P, M) f32, logZ (P,) f32).

    q (P, M) uint8, t_shift (P, M+band) uint8, m_len/n_len/lo (P,)
    int32, em (6, 6) float32 odds-ratio emissions, all on one device.
    max_live bounds every row's live width (default: the band); the
    kernel sizes its blocks by it (banded_cuda.check_max_live)."""
    max_live = check_max_live(n_len, band, max_live)
    if q.device.type == "cpu":
        return forward_banded5(q, t_shift, m_len, n_len, lo, em, band=band,
                               params=params)
    return launch_pairhmm5_fwd(q, t_shift, m_len, n_len, lo, em, band=band,
                               params=params, max_live=max_live)


def launch_pairhmm5_fwd(q, t_shift, m_len, n_len, lo, em, band: int,
                        params: Hmm5Params, max_live: int):
    """The kernel launch of `pairhmm5_fwd` (which checks max_live first,
    a device sync where it is below the band): checks the CUDA tensors,
    allocates the outputs, launches `pairhmm5_route`'s kernel on the
    current stream and counts the launch."""
    return _launch_fwd(q, t_shift, m_len, n_len, lo, em, band, params,
                       max_live, pairhmm5_route(max_live))


def _launch_fwd(q, t_shift, m_len, n_len, lo, em, band: int,
                params: Hmm5Params, max_live: int, route: str):
    """launch_pairhmm5_fwd on the named route ("wide" runs the cluster
    kernels at any max_live: the card tests and
    tests/pairhmm5_cluster_report.py time them at narrow widths)."""
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    fM = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lsF = torch.empty((P, M), dtype=torch.float32, device=dev)
    logZ = torch.empty((P,), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = _scratch(lib, P, max_live, route, False, dev)
    ins = (q.data_ptr(), t_shift.data_ptr(), m_len.data_ptr(),
           n_len.data_ptr(), lo.data_ptr(), em.data_ptr(), P, M, band,
           max_live)
    outs = (_ptr(scratch), fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(),
            cuda_build.stream(dev))
    if route == "wide":
        name = "pairhmm5_fwd_wide"
        code = lib.pairhmm5_fwd_wide_launch(*ins, *_transitions(params),
                                            *outs)
    else:
        name = "pairhmm5_fwd"
        code = lib.pairhmm5_fwd_launch(*ins, *_transitions(params), *outs)
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name, P * M * band)
    return fM, lsF, logZ


def pairhmm5_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band: int,
                 params: Hmm5Params, max_live: int | None = None):
    """Backward pass and posterior combine: post (P, M, B) f32, clipped to
    [0, 1.5] and zero past each pair's m_len.  fM, lsF and logZ are
    pairhmm5_fwd's outputs for the same inputs; max_live as there."""
    max_live = check_max_live(n_len, band, max_live)
    if q.device.type == "cpu":
        return backward_posterior5(fM, lsF, logZ, q, t_shift, m_len, n_len,
                                   lo, em, band=band, params=params)
    return launch_pairhmm5_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo,
                               em, band=band, params=params,
                               max_live=max_live)


def launch_pairhmm5_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em,
                        band: int, params: Hmm5Params, max_live: int):
    """The kernel launch of `pairhmm5_bwd` (after its max_live check), as
    launch_pairhmm5_fwd."""
    return _launch_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band,
                       params, max_live, pairhmm5_route(max_live))


def _launch_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band: int,
                params: Hmm5Params, max_live: int, route: str):
    """launch_pairhmm5_bwd on the named route, as _launch_fwd."""
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    check = cuda_build.check_tensor
    check(fM, "fM", torch.float32, (P, M, band), dev)
    check(lsF, "lsF", torch.float32, (P, M), dev)
    check(logZ, "logZ", torch.float32, (P,), dev)
    post = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = _scratch(lib, P, max_live, route, True, dev)
    ins = (fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(), q.data_ptr(),
           t_shift.data_ptr(), m_len.data_ptr(), n_len.data_ptr(),
           lo.data_ptr(), em.data_ptr(), P, M, band, max_live)
    outs = (_ptr(scratch), post.data_ptr(), cuda_build.stream(dev))
    if route == "wide":
        name = "pairhmm5_bwd_wide"
        code = lib.pairhmm5_bwd_wide_launch(*ins, *_transitions(params),
                                            *outs)
    else:
        name = "pairhmm5_bwd"
        code = lib.pairhmm5_bwd_launch(*ins, *_transitions(params), *outs)
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name)
    return post
