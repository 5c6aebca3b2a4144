"""The port's CUDA kernels against their plain PyTorch versions (GPU only).

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels
are built from cactus_tpu_torch/csrc/ at first use) and skips without
one.  This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Banded DP outputs are bit-identical to the plain version on the live
cells (the kernel computes only those, see ops/banded_cuda.py), POA
outputs on every cell.  Pair-HMM
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
                                  pairhmm_cuda, poa_cuda)
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


def _check_banded_live(got, args, band, kw):
    """banded_dp's outputs against the plain version on the card: dirs on
    the live cells, end_scores and end_mat exactly."""
    ref = tb.banded_align_batch(*args, **kw)
    P, M = args[0].shape
    live = banded_cuda.live_mask(args[2], args[3], args[4], M, band)
    assert torch.equal(got[0][live], ref[0][live])
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])


def _check_traceback(dirs, args, end_mat, S):
    moves, counts = banded_cuda.banded_traceback(dirs, args[2], args[3],
                                                 args[4], end_mat, S)
    m_ref, c_ref = banded_cuda.banded_traceback_plain(
        dirs.cpu(), args[2].cpu(), args[3].cpu(), args[4].cpu(),
        end_mat.cpu(), S)
    assert torch.equal(counts.cpu(), c_ref)
    assert torch.equal(moves.cpu(), m_ref)


@pytest.mark.parametrize("band,n,max_len", [(128, 40, 700), (512, 12, 900),
                                            (2048, 4, 2500),
                                            (16384, 2, 600)])
def test_banded_dp_bit_identical(cuda, band, n, max_len):
    pairs = _pairs(band, n, max_len, band)
    packed, args = _packed(pairs, band, cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, gap_open=400, gap_extend=30)
    for max_live in (None, banded_cuda.live_width(args[3], band)):
        n0 = cuda_build.launches()["banded_dp"]
        got = banded_cuda.banded_dp(*args, sub, **kw, max_live=max_live)
        torch.cuda.synchronize()
        assert cuda_build.launches()["banded_dp"] == n0 + 1
        _check_banded_live(got, args + [sub], band, kw)


def _edge_pairs(seed, band):
    """Short ragged pairs and the edge cases m = 0, n = 0, both 0, n < m
    and |n - m| = band - 1 both ways (lo clamped by pack_band_batch)."""
    rng = np.random.default_rng(seed)

    def codes(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = [pr for pr in _pairs(seed, 6, 60, 2 * band)
             if abs(len(pr[1]) - len(pr[0])) < band]
    short = max(1, band // 4)
    return pairs + [(codes(0), codes(min(band - 1, 9))),
                    (codes(short), codes(0)), (codes(0), codes(0)),
                    (codes(short + 3), codes(short)),
                    (codes(5), codes(5 + band - 1)),
                    (codes(4 + band - 1), codes(4))]


@pytest.mark.parametrize("band", [8, 24, 40, 64, 1000, 1024])
def test_banded_dp_live_edge_cases(cuda, band):
    pairs = _edge_pairs(band, band)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, gap_open=400, gap_extend=30)
    for max_live in (None, banded_cuda.live_width(args[3], band)):
        got = banded_cuda.banded_dp(*args, sub, **kw, max_live=max_live)
        torch.cuda.synchronize()
        _check_banded_live(got, args + [sub], band, kw)
        _check_traceback(got[0], args, got[2], 4 * band + 64)


def test_banded_dp_many_short_pairs(cuda):
    """The BAR star engine's short ends: thousands of pairs of at most 32
    bases at band 1024, one warp a pair."""
    band = 1024
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(3000):
        q = rng.integers(0, 4, int(rng.integers(1, 33))).astype(np.uint8)
        pairs.append((q, _mutate(rng, q, sub=0.15, indel=0.1)))
    packed = tb.pack_band_batch(pairs, band)
    args = [torch.from_numpy(packed[k][:len(pairs)]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, gap_open=400, gap_extend=30)
    live = banded_cuda.live_width(args[3], band)
    assert live < 64
    assert banded_cuda.launch_threads(band, live, len(pairs)) == 32
    assert banded_cuda.occupancy(band, live, len(pairs)) >= 1
    got = banded_cuda.banded_dp(*args, sub, **kw, max_live=live)
    torch.cuda.synchronize()
    _check_banded_live(got, args + [sub], band, kw)
    _check_traceback(got[0], args, got[2], 128)


def test_banded_dp_max_live_too_small_raises(cuda):
    band = 512
    pairs = _pairs(8, 10, 400, band)
    packed, args = _packed(pairs, band, cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    live = banded_cuda.live_width(args[3], band)
    with pytest.raises(ValueError, match="max_live"):
        banded_cuda.banded_dp(*args, sub, band=band, gap_open=400,
                              gap_extend=30, max_live=live - 1)


def test_traceback_matches_host(cuda):
    band = 256
    pairs = _pairs(3, 30, 800, band)
    packed, args = _packed(pairs, band, cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    dirs, _scores, end_mat = banded_cuda.banded_dp(
        *args, sub, band=band, gap_open=400, gap_extend=30)
    _check_traceback(dirs, args, end_mat, 2048)


@pytest.mark.parametrize("band,cut", [(128, None), (1024, (500, 900))])
def test_traceback_long_pair_and_wide_d_run(cuda, band, cut):
    """A band-128 pair of 5000 rows (many tiles of whole rows), and a
    400-base D run at band 1024, wider than the kernel's 256-column
    tile."""
    rng = np.random.default_rng(band)
    if cut is None:
        q = rng.integers(0, 4, 5000).astype(np.uint8)
        t = _mutate(rng, q, sub=0.05, indel=0.02)
    else:
        t = rng.integers(0, 4, 1400).astype(np.uint8)
        q = np.concatenate([t[:cut[0]], t[cut[1]:]])
    packed = tb.pack_band_batch([(q, t)], band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    dirs, _scores, end_mat = banded_cuda.banded_dp(
        *args, sub, band=band, gap_open=400, gap_extend=30,
        max_live=banded_cuda.live_width(args[3], band))
    S = 1 << (len(q) + len(t) - 1).bit_length()
    _check_traceback(dirs, args, end_mat, S)
    moves, counts = banded_cuda.banded_traceback(dirs, args[2], args[3],
                                                 args[4], end_mat, S)
    ops = tb.moves_to_ops(moves[0].cpu().numpy(), int(counts[0]))
    assert int(counts[0]) >= len(t)
    if cut is not None:
        assert max(ln for op, ln in ops if op == "D") >= cut[1] - cut[0]


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


def _poa_dag(rng, n, branchy=0.3, forward=2):
    """A bubbled DAG whose node order is not topological (`forward`
    predecessors point at higher indices, as add_alignment makes them)."""
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


@pytest.mark.parametrize("n,l", [(64, 40), (200, 300), (96, 1000)])
def test_poa_linear_matches_plain(cuda, n, l):
    rng = np.random.default_rng(n + l)
    bases, preds = _poa_dag(rng, n)
    q = rng.integers(0, 4, l).astype(np.uint8)
    args = [torch.from_numpy(x).to(cuda) for x in (bases, preds, q)]
    kw = dict(gap=30, match=10, mismatch=-15)
    n0 = cuda_build.launches()["poa_linear"]
    got = poa_cuda.poa_linear(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launches()["poa_linear"] == n0 + 1
    ref = poa_cuda.poa_linear(*[a.cpu() for a in args], **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def _poa_batch(rng, P, n, l, band, chain):
    """Ragged queries, band offsets with steps 0/1 (chain) or up to 3
    (general) where band < L+1, chains followed by source pad nodes."""
    bases = np.zeros((P, n), np.uint8)
    preds = np.full((P, n, 4), -1, np.int32)
    off = np.zeros((P, n), np.int32)
    q_ext = np.full((P, l + 1), 5, np.uint8)
    l_len = np.zeros(P, np.int32)
    for i in range(P):
        li = max(1, l - 7 * i)
        if chain:
            real = max(1, n - 5 * i)
            bases[i, :real] = rng.integers(0, 4, real)
            preds[i, 1:real, 0] = np.arange(real - 1)
        else:
            bases[i], preds[i] = _poa_dag(rng, n)
        q_ext[i, 1:li + 1] = rng.integers(0, 4, li)
        l_len[i] = li
        if band < li + 1:
            steps = rng.integers(0, 2 if chain else 4, n)
            steps[0] = 0
            off[i] = np.minimum(np.cumsum(steps), li + 1 - band)
    return bases, preds, off, q_ext, l_len


@pytest.mark.parametrize("kernel,P,n,l,band", [
    ("poa_affine", 6, 64, 50, 64), ("poa_affine", 3, 128, 600, 256),
    ("poa_affine", 2, 96, 300, 512), ("poa_chain", 40, 64, 60, 64),
    ("poa_chain", 5, 200, 900, 128), ("poa_chain", 2, 24, 200, 16384)])
def test_poa_affine_kernels_match_plain(cuda, kernel, P, n, l, band):
    rng = np.random.default_rng(P * n + band)
    inputs = _poa_batch(rng, P, n, l, band, chain=kernel == "poa_chain")
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == (
        kernel == "poa_chain")
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    n0 = cuda_build.launches()[kernel]
    got = getattr(poa_cuda, kernel)(*args, sub, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launches()[kernel] == n0 + 1
    ref = poa_cuda.poa_affine(*[a.cpu() for a in args], sub.cpu(), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


# The kernels below run 32-thread blocks at these widths (pair-HMMs at
# band <= 32, poa_affine at B 32, poa_chain at B 4096, one warp a block),
# where a load of the 6x6 matrix by threads 0-35 would leave entries
# 32-35 (row 5, the pad code, columns 2-5) unloaded.  Each puts base 5 in
# live rows, with a row 5 whose entries all differ.
ROW5_EM = np.array([0.55, 0.65, 0.75, 0.85, 0.95, 1.05], np.float32)
ROW5_SUB = np.array([-3, 2, 7, -11, 5, -1000], np.int32)


def _with_base5(args, rng):
    """Code 5 at a few live query rows of every pair with m >= 1."""
    q, m = args[0].clone(), args[2].cpu().numpy()
    for p in range(q.shape[0]):
        if m[p] > 0:
            rows = rng.integers(0, m[p], max(1, m[p] // 8))
            q[p, torch.from_numpy(rows)] = 5
    return [q] + args[1:]


@pytest.mark.parametrize("band", [16, 32])
def test_pairhmm_base5_rows_in_32_thread_blocks(cuda, band):
    pairs = _pairs(band + 40, 6, 300, band)
    _packed_np, args = _packed(pairs, band, cuda)
    args = _with_base5(args, np.random.default_rng(band))
    p = tp.HmmParams()
    em_np = p.emissions().copy()
    em_np[5] = ROW5_EM
    em = torch.from_numpy(em_np).to(cuda)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **kw)
    torch.cuda.synchronize()
    ref = tp.posterior_banded_batch(*[a.cpu() for a in args], em.cpu(), **kw)
    assert torch.isfinite(post).all()
    assert float((post.cpu() - ref).abs().max()) <= HMM_ATOL


@pytest.mark.parametrize("band", [16, 32])
def test_pairhmm5_base5_rows_in_32_thread_blocks(cuda, band):
    pairs = _pairs(band + 50, 6, 300, band)
    _packed_np, args = _packed(pairs, band, cuda)
    args = _with_base5(args, np.random.default_rng(band + 1))
    p = tp5.Hmm5Params(p_match=0.8)
    em_np = p.emissions().copy()
    em_np[5] = ROW5_EM
    em = torch.from_numpy(em_np).to(cuda)
    kw = dict(band=band, params=p)
    fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em, **kw)
    post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em, **kw)
    torch.cuda.synchronize()
    fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em, **kw)
    ref = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em, **kw)
    assert torch.isfinite(post).all()
    assert float((post - ref).abs().max()) <= HMM_ATOL


@pytest.mark.parametrize("kernel,P,n,l,band", [
    ("poa_affine", 4, 64, 50, 32), ("poa_chain", 2, 64, 300, 4096)])
def test_poa_base5_nodes_in_32_thread_blocks(cuda, kernel, P, n, l, band):
    rng = np.random.default_rng(n + band)
    bases, preds, off, q_ext, l_len = _poa_batch(
        rng, P, n, l, band, chain=kernel == "poa_chain")
    for i in range(P):
        real = np.flatnonzero((preds[i] >= 0).any(axis=1))
        bases[i, rng.choice(real, max(1, len(real) // 8))] = 5
    assert poa_cuda.chain_certified(preds, off) == (kernel == "poa_chain")
    sub_np = SUBMAT.copy()
    sub_np[5] = ROW5_SUB
    args = [torch.from_numpy(x).to(cuda)
            for x in (bases, preds, off, q_ext, l_len, sub_np)]
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    got = getattr(poa_cuda, kernel)(*args, **kw)
    torch.cuda.synchronize()
    ref = poa_cuda.poa_affine(*[a.cpu() for a in args], **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
