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
- Bands up to 8192 keep the five state rows in shared memory; wider ones
  in a global-memory scratch row per pair that the wrapper allocates
  (pairhmm5_scratch_floats), so every band runs.

Each wrapper checks its tensors, launches on the current CUDA stream and
adds one to its count in cuda_build.LAUNCHES.  A CPU tensor gets the
plain PyTorch version instead (that is what the CPU tests run); a CUDA
tensor always gets the kernel, or an error.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
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
    "pairhmm5_fwd_launch": [_VP] * 6 + [_INT] * 3 + [_F] * 9 + [_VP] * 5,
    "pairhmm5_bwd_launch": [_VP] * 9 + [_INT] * 3 + [_F] * 9 + [_VP] * 3,
    "pairhmm5_scratch_floats": [_INT],
}


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


def _scratch(lib, P: int, band: int, dev):
    """Global scratch for the state rows of bands too wide for shared
    memory (None when they fit)."""
    words = int(lib.pairhmm5_scratch_floats(band))
    if words == 0:
        return None
    return torch.empty((P, words), dtype=torch.float32, device=dev)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _transitions(params: Hmm5Params):
    return [_F(v) for v in params.transitions()]


def pairhmm5_fwd(q, t_shift, m_len, n_len, lo, em, band: int,
                 params: Hmm5Params):
    """Forward pass: (fM (P, M, B) f32, lsF (P, M) f32, logZ (P,) f32).

    q (P, M) uint8, t_shift (P, M+band) uint8, m_len/n_len/lo (P,)
    int32, em (6, 6) float32 odds-ratio emissions, all on one device."""
    if q.device.type == "cpu":
        return forward_banded5(q, t_shift, m_len, n_len, lo, em, band=band,
                               params=params)
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    fM = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lsF = torch.empty((P, M), dtype=torch.float32, device=dev)
    logZ = torch.empty((P,), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = _scratch(lib, P, band, dev)
    code = lib.pairhmm5_fwd_launch(
        q.data_ptr(), t_shift.data_ptr(), m_len.data_ptr(), n_len.data_ptr(),
        lo.data_ptr(), em.data_ptr(), P, M, band, *_transitions(params),
        _ptr(scratch), fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(),
        cuda_build.stream(dev))
    cuda_build.check(lib, code, "pairhmm5_fwd")
    cuda_build.count_launch("pairhmm5_fwd")
    return fM, lsF, logZ


def pairhmm5_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band: int,
                 params: Hmm5Params):
    """Backward pass and posterior combine: post (P, M, B) f32, clipped to
    [0, 1.5] and zero past each pair's m_len.  fM, lsF and logZ are
    pairhmm5_fwd's outputs for the same inputs."""
    if q.device.type == "cpu":
        return backward_posterior5(fM, lsF, logZ, q, t_shift, m_len, n_len,
                                   lo, em, band=band, params=params)
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    check = cuda_build.check_tensor
    check(fM, "fM", torch.float32, (P, M, band), dev)
    check(lsF, "lsF", torch.float32, (P, M), dev)
    check(logZ, "logZ", torch.float32, (P,), dev)
    post = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = _scratch(lib, P, band, dev)
    code = lib.pairhmm5_bwd_launch(
        fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(), q.data_ptr(),
        t_shift.data_ptr(), m_len.data_ptr(), n_len.data_ptr(),
        lo.data_ptr(), em.data_ptr(), P, M, band, *_transitions(params),
        _ptr(scratch), post.data_ptr(), cuda_build.stream(dev))
    cuda_build.check(lib, code, "pairhmm5_bwd")
    cuda_build.count_launch("pairhmm5_bwd")
    return post
