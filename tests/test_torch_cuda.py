"""The port's CUDA kernels against their plain PyTorch versions (GPU only).

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels
are built from cactus_tpu_torch/csrc/ at first use) and skips without
one.  This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Banded DP outputs are bit-identical to the plain version.  Pair-HMM
posteriors (3-state and 5-state) agree to HMM_ATOL: the kernels sum the
in-row chains in another order than the plain version's Kogge-Stone scan,
and the posterior is exp of a difference of float32 log-scale sums that
reach ~1e3 over 512 rows, where one ulp is ~6e-5.
"""

import numpy as np
import pytest
import torch

from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import (banded_cuda, cuda_build, pairhmm5_cuda,
                                  pairhmm_cuda)
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm5 as tp5

pytestmark = pytest.mark.cuda

HMM_ATOL = 1e-3
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")
SUBMAT = tb.score_matrix_6(PoaParams().sub_matrix)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _mutate(rng, q, sub=0.1, indel=0.04):
    out = []
    for c in q:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(int(rng.integers(0, 4)))
        out.append(int(rng.integers(0, 4)) if rng.random() < sub else int(c))
    return np.array(out, np.uint8)


def _pairs(seed, n, max_len, band):
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < n:
        m = int(rng.integers(1, max_len))
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = _mutate(rng, q)
        if abs(len(t) - len(q)) < band // 2:
            pairs.append((q, t))
    return pairs


def _packed(pairs, band, dev):
    packed = tb.pack_band_batch(pairs, band)
    return packed, [torch.from_numpy(packed[k]).to(dev) for k in KEYS]


@pytest.mark.parametrize("band,n,max_len", [(128, 40, 700), (512, 12, 900),
                                            (2048, 4, 2500),
                                            (16384, 2, 600)])
def test_banded_dp_bit_identical(cuda, band, n, max_len):
    pairs = _pairs(band, n, max_len, band)
    packed, args = _packed(pairs, band, cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, gap_open=400, gap_extend=30)
    n0 = cuda_build.launches()["banded_dp"]
    got = banded_cuda.banded_dp(*args, sub, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launches()["banded_dp"] == n0 + 1
    ref = tb.banded_align_batch(*[a.cpu() for a in args], sub.cpu(), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_traceback_matches_host(cuda):
    band = 256
    pairs = _pairs(3, 30, 800, band)
    packed, args = _packed(pairs, band, cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    dirs, _scores, end_mat = banded_cuda.banded_dp(
        *args, sub, band=band, gap_open=400, gap_extend=30)
    S = 2048
    moves, counts = banded_cuda.banded_traceback(dirs, args[2], args[3],
                                                 args[4], end_mat, S)
    m_ref, c_ref = banded_cuda.banded_traceback_plain(
        dirs.cpu(), args[2].cpu(), args[3].cpu(), args[4].cpu(),
        end_mat.cpu(), S)
    assert torch.equal(counts.cpu(), c_ref)
    assert torch.equal(moves.cpu(), m_ref)


def test_align_pairs_banded_cuda_equals_native(cuda):
    pairs = _pairs(5, 50, 1200, 256)
    sub = SUBMAT
    gap = tb.GapParams(400, 30)
    assert (tb.align_pairs_banded(pairs, sub, gap, band=256, device=cuda)
            == tb.align_pairs_banded(pairs, sub, gap, band=256,
                                     device="cpu"))


def test_backend_hook_refused_on_cuda(cuda):
    pairs = _pairs(6, 3, 200, 128)
    with pytest.raises(ValueError, match="CPU test hook"):
        tb.align_pairs_banded(pairs, SUBMAT, tb.GapParams(400, 30),
                              backend=tb.banded_align_batch, device=cuda)


@pytest.mark.parametrize("band", [512, 2048])
def test_pairhmm_kernels_match_plain(cuda, band):
    pairs = _pairs(band + 1, 6, 500, band)
    packed, args = _packed(pairs, band, cuda)
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **kw)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["pairhmm_fwd"] == n0["pairhmm_fwd"] + 1
    assert n1["pairhmm_bwd"] == n0["pairhmm_bwd"] + 1
    ref = tp.posterior_banded_batch(*[a.cpu() for a in args], em.cpu(), **kw)
    assert torch.isfinite(post).all()
    assert float((post.cpu() - ref).abs().max()) <= HMM_ATOL


@pytest.mark.parametrize("band,n,max_len", [(128, 8, 300), (1024, 6, 900),
                                            (2048, 4, 1500),
                                            (16384, 2, 700)])
def test_pairhmm5_kernels_match_plain(cuda, band, n, max_len):
    pairs = _pairs(band + 5, n, max_len, band)
    rng = np.random.default_rng(band)
    q = rng.integers(0, 4, 160).astype(np.uint8)
    pairs.append((q, np.concatenate([q[:70], q[100:]])))   # 30 bp deletion
    _packed_np, args = _packed(pairs, band, cuda)
    p = tp5.Hmm5Params(p_match=0.8)
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, params=p)
    # band 16384 keeps the state rows in global scratch, the others in
    # shared memory
    wide = pairhmm5_cuda._lib().pairhmm5_scratch_floats(band) > 0
    assert wide == (band > 8192)
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em, **kw)
    post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em, **kw)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["pairhmm5_fwd"] == n0["pairhmm5_fwd"] + 1
    assert n1["pairhmm5_bwd"] == n0["pairhmm5_bwd"] + 1
    fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em, **kw)
    ref = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em, **kw)
    assert torch.isfinite(post).all()
    assert float((post - ref).abs().max()) <= HMM_ATOL
    # the deletion pair keeps confident matches on both sides of the gap
    row_best = post[len(pairs) - 1, :160].amax(dim=1).cpu().numpy()
    assert np.median(row_best[:60]) > 0.7 and np.median(row_best[110:]) > 0.7
