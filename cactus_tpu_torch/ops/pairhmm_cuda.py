"""CUDA kernels of the 3-state pair-HMM: `pairhmm_fwd` and `pairhmm_bwd`.

Source: csrc/pairhmm.cu (see its header for the design).
- pairhmm_fwd replaces the Pallas TPU kernel
  cactus_tpu/ops/pairhmm_pallas.py::_fwd_kernel and pairhmm_bwd replaces
  ::_bwd_kernel (entry posterior_banded_batch_pallas).  Contract:
  ops/pairhmm.py::forward_banded and ::backward_posterior, the two halves
  of cactus_tpu/ops/pairhmm.py::posterior_banded_batch; the backward
  kernel fuses the posterior combine, so bM never reaches device memory.
  The band is rescaled once per 8 rows, as the TPU kernel does; when a
  step ends, each of its fM rows is stored divided by its own maximum and
  its lsF is the plain version's running log-scale, so fM, lsF and the
  posterior's clip are the plain version's up to rounding.
- Bound on an H100: device-memory bytes by the roofline (the forward pass
  writes one float32 per cell, PAIRHMM_FWD_FLOPS_PER_CELL float
  operations against 4 bytes; the backward pass reads one and writes one,
  PAIRHMM_BWD_FLOPS_PER_CELL against 8 bytes), but a launch holds a few
  pairs whose rows depend on each other, so what bounds it in practice is
  the longest pair's rows times a row's dependent chain (chip_smoke.py's
  latency line).
- Bands past PAIRHMM_MAX_NARROW_BAND (16384: 16 warps of 32 cells a lane)
  run the cluster kernels (`pairhmm_route`): one thread-block cluster of
  up to 16 CTAs a pair, on the pairs' live windows only (rows 1..m,
  columns j = 0..n; the contract is exactly 0 elsewhere), sized by
  max_live, the widest live row of the launch (banded_cuda.live_width;
  `cluster_shape`); the state rows and the step's rows live in the CTAs'
  shared memory up to 86,016 cells and in per-pair global scratch past
  that.  The same 8-row rescale and the same stored rows; they count
  their launches as "pairhmm_fwd_wide" and "pairhmm_bwd_wide".  A cluster
  the card cannot schedule raises.  The narrow route ignores max_live.

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
from .pairhmm import backward_posterior, forward_banded

# float32 operations per cell as the kernels are written (forward: mM 5,
# mX 3, the chain map fold 3 and replay 3, band maximum 3, the rescale's 3
# once per 8 rows; backward: mm 1, nX 3, fold 3, replay 3, nM 5, band
# maximum 3, posterior 1 and its scale with clamps 3, the rescale's 2 once
# per 8 rows)
PAIRHMM_FWD_FLOPS_PER_CELL = 17
PAIRHMM_BWD_FLOPS_PER_CELL = 22

_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pairhmm_fwd_launch": [_VP] * 6 + [_INT] * 3 + [_F] * 4 + [_VP] * 4,
    "pairhmm_bwd_launch": [_VP] * 9 + [_INT] * 3 + [_F] * 4 + [_VP] * 2,
    "pairhmm_cluster_shape": [_INT, _INT, _VP],
    "pairhmm_fwd_wide_launch": [_VP] * 6 + [_INT] * 5 + [_F] * 4
    + [_VP] * 5,
    "pairhmm_bwd_wide_launch": [_VP] * 9 + [_INT] * 5 + [_F] * 4
    + [_VP] * 3,
}
# the widest band the narrow kernels take (csrc/pairhmm.cu: kMaxWarps
# warps of 32 cells a lane)
PAIRHMM_MAX_NARROW_BAND = 16 * 32 * 32


def pairhmm_route(band: int) -> str:
    """Which kernels a launch of this band runs: "narrow" (a pair's band
    in registers) or "wide" (the cluster kernels on the live windows,
    past PAIRHMM_MAX_NARROW_BAND)."""
    return "narrow" if band <= PAIRHMM_MAX_NARROW_BAND else "wide"


def _lib() -> ctypes.CDLL:
    return cuda_build.bind("pairhmm", _SIGNATURES)


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


def cluster_shape(max_live: int, max_ctas: int = 0) -> dict:
    """The cluster a wide launch takes for this max_live (csrc/pairhmm.cu
    cluster_shape, at most max_ctas CTAs when it is above 0; needs the
    card): ctas, threads a CTA, cells a lane, smem, whether the state rows
    live in the CTAs' shared memory, and fwd_words / bwd_words, the
    float32 words of global scratch each pass needs a pair (0 with
    smem)."""
    lib = _lib()
    out = (ctypes.c_longlong * 6)()
    cuda_build.check(lib, lib.pairhmm_cluster_shape(max_live, max_ctas, out),
                     "pairhmm_cluster_shape")
    return dict(ctas=out[0], threads=out[1], cells=out[2], smem=bool(out[3]),
                fwd_words=out[4], bwd_words=out[5])


def _scratch(P: int, max_live: int, max_ctas: int, bwd: bool, dev):
    """Global scratch for the cluster kernels' rows where they outgrow
    shared memory, as the C side sizes it (None when they fit)."""
    words = cluster_shape(max_live, max_ctas)["bwd_words" if bwd
                                              else "fwd_words"]
    if words == 0:
        return None
    return torch.empty((P, words), dtype=torch.float32, device=dev)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _params(delta: float, epsilon: float):
    return (_F(delta), _F(epsilon), _F(1.0 - 2.0 * delta),
            _F(1.0 - epsilon))


def pairhmm_fwd(q, t_shift, m_len, n_len, lo, em, band: int, delta: float,
                epsilon: float, max_live: int | None = None):
    """Forward pass: (fM (P, M, B) f32, lsF (P, M) f32, logZ (P,) f32);
    fM * exp(lsF) is each cell's forward match value, every row scaled by
    its own maximum (the kernel rescales its state once per 8 rows and
    scales each stored row when its step ends).

    q (P, M) uint8, t_shift (P, M+band) uint8, m_len/n_len/lo (P,)
    int32, em (6, 6) float32 odds-ratio emissions, all on one device.
    max_live bounds every row's live width (default: the band); the wide
    route sizes its cluster by it (banded_cuda.check_max_live)."""
    max_live = check_max_live(n_len, band, max_live)
    if q.device.type == "cpu":
        return forward_banded(q, t_shift, m_len, n_len, lo, em, band=band,
                              delta=delta, epsilon=epsilon)
    return launch_pairhmm_fwd(q, t_shift, m_len, n_len, lo, em, band, delta,
                              epsilon, max_live)


def launch_pairhmm_fwd(q, t_shift, m_len, n_len, lo, em, band: int,
                       delta: float, epsilon: float, max_live: int):
    """The kernel launch of `pairhmm_fwd` (which checks max_live first, a
    device sync where it is below the band): checks the CUDA tensors,
    allocates the outputs, launches `pairhmm_route`'s kernel on the
    current stream and counts the launch."""
    return _launch_fwd(q, t_shift, m_len, n_len, lo, em, band, delta,
                       epsilon, max_live, pairhmm_route(band))


def _launch_fwd(q, t_shift, m_len, n_len, lo, em, band: int, delta: float,
                epsilon: float, max_live: int, route: str, max_ctas: int = 0):
    """launch_pairhmm_fwd on the named route ("wide" runs the cluster
    kernels at any band, with at most max_ctas CTAs when it is above 0:
    the card tests and tests/pairhmm_sweep_report.py time them at narrow
    widths and other cluster sizes)."""
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    fM = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lsF = torch.empty((P, M), dtype=torch.float32, device=dev)
    logZ = torch.empty((P,), dtype=torch.float32, device=dev)
    lib = _lib()
    ins = (q.data_ptr(), t_shift.data_ptr(), m_len.data_ptr(),
           n_len.data_ptr(), lo.data_ptr(), em.data_ptr(), P, M, band)
    outs = (fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(),
            cuda_build.stream(dev))
    if route == "wide":
        name = "pairhmm_fwd_wide"
        scratch = _scratch(P, max_live, max_ctas, False, dev)
        code = lib.pairhmm_fwd_wide_launch(
            *ins, max_live, max_ctas, *_params(delta, epsilon),
            _ptr(scratch), *outs)
    else:
        name = "pairhmm_fwd"
        code = lib.pairhmm_fwd_launch(*ins, *_params(delta, epsilon), *outs)
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name, P * M * band)
    return fM, lsF, logZ


def pairhmm_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band: int,
                delta: float, epsilon: float, max_live: int | None = None):
    """Backward pass and posterior combine: post (P, M, B) f32, clipped to
    [0, 1.5] and zero past each pair's m_len.  fM, lsF and logZ are
    pairhmm_fwd's outputs for the same inputs; max_live as there."""
    max_live = check_max_live(n_len, band, max_live)
    if q.device.type == "cpu":
        return backward_posterior(fM, lsF, logZ, q, t_shift, m_len, n_len,
                                  lo, em, band=band, delta=delta,
                                  epsilon=epsilon)
    return launch_pairhmm_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo,
                              em, band, delta, epsilon, max_live)


def launch_pairhmm_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em,
                       band: int, delta: float, epsilon: float,
                       max_live: int):
    """The kernel launch of `pairhmm_bwd` (after its max_live check), as
    launch_pairhmm_fwd."""
    return _launch_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band,
                       delta, epsilon, max_live, pairhmm_route(band))


def _launch_bwd(fM, lsF, logZ, q, t_shift, m_len, n_len, lo, em, band: int,
                delta: float, epsilon: float, max_live: int, route: str,
                max_ctas: int = 0):
    """launch_pairhmm_bwd on the named route, as _launch_fwd."""
    dev, P, M = _check_inputs(q, t_shift, m_len, n_len, lo, em, band)
    check = cuda_build.check_tensor
    check(fM, "fM", torch.float32, (P, M, band), dev)
    check(lsF, "lsF", torch.float32, (P, M), dev)
    check(logZ, "logZ", torch.float32, (P,), dev)
    post = torch.empty((P, M, band), dtype=torch.float32, device=dev)
    lib = _lib()
    ins = (fM.data_ptr(), lsF.data_ptr(), logZ.data_ptr(), q.data_ptr(),
           t_shift.data_ptr(), m_len.data_ptr(), n_len.data_ptr(),
           lo.data_ptr(), em.data_ptr(), P, M, band)
    outs = (post.data_ptr(), cuda_build.stream(dev))
    if route == "wide":
        name = "pairhmm_bwd_wide"
        scratch = _scratch(P, max_live, max_ctas, True, dev)
        code = lib.pairhmm_bwd_wide_launch(
            *ins, max_live, max_ctas, *_params(delta, epsilon),
            _ptr(scratch), *outs)
    else:
        name = "pairhmm_bwd"
        code = lib.pairhmm_bwd_launch(*ins, *_params(delta, epsilon), *outs)
    cuda_build.check(lib, code, name)
    cuda_build.count_launch(name)
    return post
