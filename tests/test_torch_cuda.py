"""The port's CUDA kernels against their plain PyTorch versions (GPU only).

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels
are built from cactus_tpu_torch/csrc/ at first use) and skips without
one.  This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Banded DP outputs are bit-identical to the plain version on the live
cells (the kernel computes only those, see ops/banded_cuda.py), and so
are poa_chain's and poa_affine's (ops/poa_cuda.py::live_mask; ends on
each problem's real nodes) and poa_linear's (linear_live_mask: every cell
without n_nodes and l_len).  Widths past each kernel's widest narrow
launch run its wide kernel (`-k wide`).  Pair-HMM
posteriors (3-state and 5-state) agree to HMM_ATOL: the kernels sum the
in-row chains in another order than the plain version's Kogge-Stone scan,
and the posterior is exp of a difference of float32 log-scale sums that
reach ~1e3 over 512 rows, where one ulp is ~6e-5.  The 3-state cases at
the path's lengths are held by chip_smoke.check_hmm, with chip_smoke.py's
tolerances.
"""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from banded_warp_cases import CASES as WARP_CASES
from banded_warp_cases import case as warp_case
from cactus_tpu_torch.config import PoaParams
from cactus_tpu_torch.ops import banded as tb
from cactus_tpu_torch.ops import (banded_cuda, cuda_build, pairhmm5_cuda,
                                  pairhmm_cuda, poa_cuda)
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm5 as tp5
from cactus_tpu_torch.ops import poa as tpoa

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
    bases at band 1024, one warp a pair (the warp kernel)."""
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
    assert banded_cuda.dp_kernel(live) == "warp"
    assert banded_cuda.launch_threads(band, live, len(pairs)) == 32
    assert banded_cuda.occupancy(band, live, len(pairs)) >= 1
    got = banded_cuda.banded_dp(*args, sub, **kw, max_live=live)
    torch.cuda.synchronize()
    _check_banded_live(got, args + [sub], band, kw)
    _check_traceback(got[0], args, got[2], 128)


def _launch_checked(args, sub, band, max_live, kernel):
    """banded_dp at max_live, which takes `kernel`, held to the plain
    version (live cells, end scores and states) and its traceback to the
    host's; returns its outputs."""
    assert banded_cuda.dp_kernel(max_live) == kernel
    kw = dict(band=band, gap_open=400, gap_extend=30)
    n0 = cuda_build.launches()["banded_dp"]
    got = banded_cuda.banded_dp(*args, sub, **kw, max_live=max_live)
    torch.cuda.synchronize()
    assert cuda_build.launches()["banded_dp"] == n0 + 1
    _check_banded_live(got, args + [sub], band, kw)
    S = chip_smoke.traceback_cap(args[2], args[3])
    _check_traceback(got[0], args, got[2], S)
    return got


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_banded_dp_warp_kernel_cases(cuda, name):
    """The warp kernel at C = 2..8 cells a lane: long band-128 and
    band-256 pairs (window standing still), short ends at band 1024
    (window sliding), windows that stop sliding, the edge cases; the
    shapes tests/test_torch_banded_warp.py models on the CPU."""
    packed, band, W = warp_case(name)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    assert banded_cuda.launch_threads(band, W, len(packed["q"])) == 32
    _launch_checked(args, sub, band, W, "warp")


def test_banded_dp_warp_kernel_long_pair(cuda):
    """One 8,192-row band-128 pair, the default path's longest call's
    rows, and a 6,000-row pair beside it."""
    band = 128
    rng = np.random.default_rng(8192)
    pairs = []
    for m in (8192, 6000):
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, _mutate(rng, q, sub=0.1, indel=0.02)[:m + 40]))
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    _launch_checked(args, sub, band, banded_cuda.live_width(args[3], band),
                    "warp")


def test_banded_dp_warp_kernel_bar_short_ends(cuda):
    """The default path's largest launch: 15,171 BAR short ends at band
    1024 with max_live their live width."""
    from banded_sweep_report import short_end_pairs
    band = 1024
    pairs = short_end_pairs(chip_smoke)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k][:len(pairs)]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    _launch_checked(args, sub, band, banded_cuda.live_width(args[3], band),
                    "warp")


def test_banded_dp_warp_and_block_kernels_agree(cuda):
    """The same band-512 pairs (n <= 255) at max_live 256 (the warp
    kernel) and 257 (the block kernel): bit-equal to each other and to
    the plain version on the live cells, the end scores and states."""
    band = 512
    pairs = [pr for pr in _pairs(512, 40, 250, band) if len(pr[1]) <= 255]
    pairs += _edge_pairs(257, 64)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    assert banded_cuda.live_width(args[3], band) <= 256
    warp = _launch_checked(args, sub, band, 256, "warp")
    block = _launch_checked(args, sub, band, 257, "block")
    assert chip_smoke.banded_live_equal(warp, block, *args[2:])


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


def _homologous(seed, lens, band):
    """Pairs with these query lengths; targets mutated from them, their
    length difference inside the band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for m in lens:
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = _mutate(rng, q)
        while abs(len(t) - m) >= band // 2 or len(t) == 0:
            t = _mutate(rng, q)
        pairs.append((q, t))
    return pairs


def _check_pairhmm_vs_plain(pairs, band, dev, min_rows=32, base5=False):
    """Both kernels against the plain versions on the packed pairs, by
    chip_smoke.check_hmm (every value finite, the posterior within its
    HMM_ATOL, logZ within LOGZ_RTOL, log(fM) + lsF within FWD_LOG_ATOL
    where the plain fM is above 1e-30), and the rows past each pair's
    m_len zero.  base5: code 5 at some query rows, with an em row 5 whose
    entries all differ."""
    packed = tb.pack_band_batch(pairs, band, min_batch=1, min_rows=min_rows)
    args = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
    p = tp.HmmParams()
    em_np = p.emissions().copy()
    if base5:
        args = _with_base5(args, np.random.default_rng(band))
        em_np[5] = ROW5_EM
    em = torch.from_numpy(em_np).to(dev)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    # the route's kernels (past band 16384 the wide ones)
    sfx = "_wide" if pairhmm_cuda.pairhmm_route(band) == "wide" else ""
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **kw)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["pairhmm_fwd" + sfx] == n0["pairhmm_fwd" + sfx] + 1
    assert n1["pairhmm_bwd" + sfx] == n0["pairhmm_bwd" + sfx] + 1
    cpu = [a.cpu() for a in args]
    fM_r, lsF_r, logZ_r = tp.forward_banded(*cpu, em.cpu(), **kw)
    ref = tp.backward_posterior(fM_r, lsF_r, logZ_r, *cpu, em.cpu(), **kw)
    fM, post = fM.cpu(), post.cpu()
    chip_smoke.check_hmm(fM, lsF.cpu(), logZ.cpu(), post, fM_r, lsF_r,
                         logZ_r, ref, f"band {band}", quiet=True)
    rows = torch.arange(1, fM.shape[1] + 1)[None, :]
    past = rows > cpu[2][:, None]
    assert bool((fM[past] == 0).all()) and bool((post[past] == 0).all())


@pytest.mark.parametrize("P,lo_len,hi_len,band", [
    (2, 1500, 2049, 512), (2, 1500, 2049, 2048), (1, 1000, 2049, 512),
    (32, 600, 1025, 512)])
def test_pairhmm_kernels_at_path_shapes(cuda, P, lo_len, hi_len, band):
    """The default path's nested launches (two pieces of up to 2048 rows
    at bands 512 and 2048), one pair, and 32 pairs a launch."""
    rng = np.random.default_rng(P * band)
    lens = rng.integers(lo_len, hi_len, P)
    lens[0] = hi_len - 1
    _check_pairhmm_vs_plain(_homologous(P + band, lens, band), band, cuda)


def test_pairhmm_kernels_diffuse_posteriors(cuda):
    """Unrelated pieces of 480 and 467 bases at band 512, as the default
    path's nested refinement sends them: the forward and backward masses
    of a row lie apart and the posterior's clip at exp(60) binds; it must
    bind as in the plain version."""
    rng = np.random.default_rng(512)
    pairs = [(rng.integers(0, 4, 480).astype(np.uint8),
              rng.integers(0, 4, 467).astype(np.uint8))]
    pairs += _homologous(517, [480], 512)
    _check_pairhmm_vs_plain(pairs, 512, cuda)


def _plain_float64():
    """forward_banded and backward_posterior of ops/pairhmm.py run in
    float64: the module's source with every torch.float32 made
    torch.float64."""
    src = inspect.getsource(tp).replace("torch.float32", "torch.float64")
    ns = {"__name__": tp.__name__, "__package__": tp.__package__}
    exec(compile(src, tp.__file__, "exec"), ns)
    return ns["forward_banded"], ns["backward_posterior"]


@pytest.mark.parametrize("m,n,band", [(1500, 1400, 2048), (1500, 1400, 512)])
def test_pairhmm_kernels_long_unrelated_pieces_vs_float64(cuda, m, n, band):
    """Unrelated pieces of 1500 and 1400 bases (as nested refinement may
    send them from the wrong strand), where float32 itself fails: mass
    that later dominates lies more than float32's range below its row
    maximum, so the plain version's logZ is tens of nats under a float64
    run of the same code and its posterior is far from it on a few hundred
    rows (pinned here: more than 0.5).  On the rows where the plain
    version holds chip_smoke.HMM_ATOL of float64, the kernels hold
    HMM_ATOL of the plain version; every value is finite."""
    rng = np.random.default_rng(band)
    pairs = [(rng.integers(0, 4, m).astype(np.uint8),
              rng.integers(0, 4, n).astype(np.uint8))]
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **kw)
    for x in (fM, lsF, logZ, post):
        assert torch.isfinite(x).all()
    cpu = [a.cpu() for a in args]
    post = post.cpu()[0, :m].double()
    ref = tp.posterior_banded_batch(*cpu, em.cpu(), **kw)[0, :m].double()
    fwd64, bwd64 = _plain_float64()
    f64 = fwd64(*cpu, em.cpu().double(), **kw)
    ref64 = bwd64(*f64, *cpu, em.cpu().double(), **kw)[0, :m]
    plain_gap = (ref - ref64).abs().amax(1)
    assert float(plain_gap.max()) > 0.5, "the plain version now holds " \
        "float64 here: make this a conformance case"
    good = plain_gap <= chip_smoke.HMM_ATOL
    assert int(good.sum()) >= m // 2
    kernel_gap = (post - ref).abs().amax(1)
    assert float(kernel_gap[good].max()) <= chip_smoke.HMM_ATOL


@pytest.mark.parametrize("band", [128, 512, 1000, 1024, 2048, 4096, 8192,
                                  16384, 16400, 32768])
def test_pairhmm_kernels_step_edges(cuda, band):
    """m_len around the rescale step (8 rows up to band 2048; 4, 2 and 1
    at bands 4096, 8192 and 16384, where a step's rows fill the shared
    ring; 8 on the wide route past 16384) and m_len = M, at every launch
    shape (1 to 16 warps, 4 to 32 cells a lane, and the wide kernels'
    tiles: one partly filled, and eight), with code-5 query rows."""
    lens = [1, 2, 3, 4, 5, 7, 8, 9, 64]
    _check_pairhmm_vs_plain(_homologous(band + 3, lens, band), band, cuda,
                            min_rows=64, base5=True)


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


def _real_nodes(preds):
    """Each problem's real nodes: up to its last node with a predecessor
    (the pad nodes after them are sources)."""
    has = (preds >= 0).any(axis=2)
    idx = np.arange(preds.shape[1])[None, :]
    return (np.where(has, idx, 0).max(axis=1) + 1).astype(np.int32)


def _assert_poa_live(got, ref, off, l_len, n_nodes, band):
    """H and dirs on the live cells and ends on the real nodes, bit-equal
    (chip_smoke.poa_live_equal on the host copies)."""
    assert chip_smoke.poa_live_equal(
        [x.cpu() for x in got], [x.cpu() for x in ref], off.cpu(),
        l_len.cpu(), n_nodes.cpu(), band)


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
    n_nodes = torch.from_numpy(_real_nodes(inputs[1])).to(cuda)
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    n0 = cuda_build.launches()[kernel]
    got = getattr(poa_cuda, kernel)(*args, sub, **kw, n_nodes=n_nodes)
    torch.cuda.synchronize()
    assert cuda_build.launches()[kernel] == n0 + 1
    ref = poa_cuda.poa_affine(*[a.cpu() for a in args], sub.cpu(), **kw)
    _assert_poa_live(got, ref, args[2], args[4], n_nodes, band)


@pytest.mark.parametrize("kernel,P,N,lq,band,n_lo", [
    ("poa_chain", 16, 64, 60, 64, 1),       # n = 1 and n = Nb, L + 1 <= B
    ("poa_chain", 24, 64, 300, 64, 1),      # L + 1 > B, offsets stepping
    ("poa_chain", 40, 100, 120, 128, 1),    # ragged widths sharing warps
    ("poa_chain", 16000, 64, 63, 64, 1),    # the dominant bin
    ("poa_chain", 1, 512, 511, 512, 512),   # P 1 at (512, 512): 4 warps
    ("poa_chain", 3, 300, 2000, 1024, 100),  # 8 warps a problem, banded
    ("poa_chain", 2, 80, 4000, 4096, 60),   # 16 warps of 8 cells
    ("poa_chain", 2, 100, 6000, 8192, 50),  # 16 cells a lane
    ("poa_chain", 2, 200, 9000, 16384, 50),  # 32 cells a lane
    ("poa_affine", 16, 64, 60, 64, 1),
    ("poa_affine", 24, 64, 300, 64, 1),
    ("poa_affine", 40, 100, 120, 128, 1),
    ("poa_affine", 4866, 64, 63, 64, 1),    # the star path's largest bin
    ("poa_affine", 1, 512, 511, 512, 512),
    ("poa_affine", 3, 300, 2000, 1024, 100),
    ("poa_affine", 2, 100, 6000, 8192, 50),
    ("poa_affine", 1, 600, 9000, 16384, 50)])
def test_poa_live_cells_match_plain(cuda, kernel, P, N, lq, band, n_lo):
    from test_torch_poa_live import ragged_batch
    chain = kernel == "poa_chain"
    inputs = ragged_batch(P + N + band, P, N, lq, band, chain, n_lo=n_lo)
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == chain
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], band)
    n0 = cuda_build.launches()[kernel]
    got = getattr(poa_cuda, kernel)(*args[:5], sub, **kw, n_nodes=args[5],
                                    max_live=max_live)
    torch.cuda.synchronize()
    assert cuda_build.launches()[kernel] == n0 + 1
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], band)


def _poa_shipped():
    """(kernel, shape, cover, problems, smem): each team shape the
    wrappers pick, at a launch size they pick it for; poa_affine's covers
    up to 256 once with few problems (history rows in shared memory) and
    once with more than the card holds at once (global scratch)."""
    from test_torch_poa_live import _shipped
    out = [("poa_chain", s, c, p, False) for s, c, p in _shipped("poa_chain")]
    for s, c, p in _shipped("poa_affine"):
        out.append(("poa_affine", s, c, p, c <= 256))
        if c <= 256:
            out.append(("poa_affine", s, c, 1200, False))
    return out


@pytest.mark.parametrize("kernel,shape,band,problems,smem", _poa_shipped())
def test_poa_every_team_shape(cuda, kernel, shape, band, problems, smem):
    """Each team shape (and poa_affine's history in shared memory or
    global scratch) the wrappers ship, through the wrapper on a batch
    whose widest row fills the shape's cover."""
    from test_torch_poa_live import ragged_batch
    chain = kernel == "poa_chain"
    inputs = ragged_batch(band + shape[0], problems, 40, band + 40, band,
                          chain, n_lo=10)
    inputs[4][:] = np.minimum(inputs[4], band - 1 + inputs[2][:, 0])
    inputs[4][0] = band - 1
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], band)
    assert poa_cuda.team_shape(max_live, kernel, problems) == shape
    if not chain:
        assert poa_cuda.affine_rows_in_smem(problems, 40, max_live, shape,
                                            cuda) == smem
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    got = getattr(poa_cuda, kernel)(*args[:5], sub, **kw, n_nodes=args[5],
                                    max_live=max_live)
    torch.cuda.synchronize()
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], band)


def test_poa_wrappers_check_the_live_contract(cuda):
    """Without max_live the wrappers check n_nodes and size the teams by
    check_live on host copies; a max_live outside 1..B raises before any
    launch, and one wider than the widest team cover runs the wide
    kernel."""
    from test_torch_poa_live import ragged_batch
    inputs = ragged_batch(3, 4, 32, 60, 64, True)
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=64, o1=400, e1=30, o2=1200, e2=1)
    got = poa_cuda.poa_chain(*args[:5], sub, **kw, n_nodes=args[5])
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], 64)
    cut = args[5].clone()
    cut[0] = 31          # problem 0 fills the bin: cuts a real node off
    for kernel in ("poa_chain", "poa_affine"):
        with pytest.raises(ValueError, match="cuts a real node off"):
            getattr(poa_cuda, kernel)(*args[:5], sub, **kw, n_nodes=cut)
        for wrong in (0, 65):
            with pytest.raises(ValueError, match="max_live"):
                getattr(poa_cuda, kernel)(*args[:5], sub, **kw,
                                          n_nodes=args[5], max_live=wrong)
    # past the widest team cover the wrappers take the wide kernel
    wide = dict(kw, band=32768)
    for kernel in ("poa_chain", "poa_affine"):
        n0 = cuda_build.launches()
        got = getattr(poa_cuda, kernel)(*args[:5], sub, **wide,
                                        n_nodes=args[5], max_live=16385)
        torch.cuda.synchronize()
        n1 = cuda_build.launches()
        assert n1["poa_wide"] == n0["poa_wide"] + 1
        assert n1[kernel] == n0[kernel]
        ref = tpoa.poa_align_scan_affine(*args[:5], sub, **wide)
        _assert_poa_live(got, ref, args[2], args[4], args[5], 32768)


# The kernels below run 32-thread blocks at these widths (pair-HMMs at
# band <= 32, poa_affine at B 32, poa_chain at B 4096, one warp a block),
# where a load of the 6x6 matrix by threads 0-35 would leave entries
def _check_pairhmm5_vs_plain(packed, band, dev, max_live=None, base5=False):
    """Both 5-state kernels, with max_live as posterior_pairs_banded5
    passes it (default: the pairs' widest live row), against the plain
    versions by chip_smoke.check_hmm (every value finite, the posterior
    within its HMM_ATOL, logZ within LOGZ_RTOL, log(fM) + lsF within
    FWD_LOG_ATOL where the plain fM is above 1e-30), with fM and post
    zero outside each row's live window and past m.  Returns the threads
    a block launched with."""
    args = [torch.from_numpy(packed[k]).to(dev) for k in KEYS]
    p = tp5.Hmm5Params(p_match=0.8)
    em_np = p.emissions().copy()
    if base5:
        args = _with_base5(args, np.random.default_rng(band + 2))
        em_np[5] = ROW5_EM
    em = torch.from_numpy(em_np).to(dev)
    if max_live is None:
        max_live = banded_cuda.live_width(args[3], band)
    kw = dict(band=band, params=p)
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em, **kw,
                                               max_live=max_live)
    post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em, **kw,
                                      max_live=max_live)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["pairhmm5_fwd"] == n0["pairhmm5_fwd"] + 1
    assert n1["pairhmm5_bwd"] == n0["pairhmm5_bwd"] + 1
    cpu = [a.cpu() for a in args]
    fM_r, lsF_r, logZ_r = tp5.forward_banded5(*cpu, em.cpu(), **kw)
    ref = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *cpu, em.cpu(), **kw)
    fM, post = fM.cpu(), post.cpu()
    chip_smoke.check_hmm(fM, lsF.cpu(), logZ.cpu(), post, fM_r, lsF_r,
                         logZ_r, ref, f"pairhmm5 band {band}", quiet=True)
    live = banded_cuda.live_mask(cpu[2], cpu[3], cpu[4], fM.shape[1], band)
    assert not bool(fM[~live].any()) and not bool(post[~live].any())
    return pairhmm5_cuda.launch_threads(max_live)


def _codes(rng, k):
    return rng.integers(0, 4, k).astype(np.uint8)


@pytest.mark.parametrize("band,lo_len,hi_len,warps", [
    (128, 20, 128, 1),       # one warp of 4 cells a lane
    (256, 150, 256, 2),
    (512, 300, 512, 4),
    (1024, 600, 1024, 8),
    (4096, 3700, 4096, 32)])
def test_pairhmm5_launch_shapes_and_edge_pairs(cuda, band, lo_len, hi_len,
                                               warps):
    """1, 2, 4, 8 and 32 warps a block of 4 cells a lane (8, 16 and 64
    cells in test_pairhmm5_wide_windows), each batch with m_len 0, 1 and
    M (the longest query fills the padded rows) and n_len 0."""
    rng = np.random.default_rng(band + warps)
    lens = rng.integers(lo_len, hi_len, 3)
    lens[0] = hi_len
    pairs = _homologous(band + 9, lens, band)
    pairs += [(_codes(rng, 0), _codes(rng, 7)), (_codes(rng, 1), _codes(rng, 3)),
              (_codes(rng, 5), _codes(rng, 0))]
    packed = tb.pack_band_batch(pairs, band, min_batch=1, min_rows=32)
    assert packed["q"].shape[1] == hi_len
    widest = max(min(band, len(t) + 1) for _q, t in pairs)
    assert widest > 32 * 4 * (warps - 1)
    threads = _check_pairhmm5_vs_plain(packed, band, cuda)
    assert threads == 32 * warps


def test_pairhmm5_rows_with_empty_windows(cuda):
    """A pair whose band lies left of j = 0 for its first 36 rows (empty
    windows, each rescaled by TINY) beside ordinary pairs in one launch."""
    band = 64
    rng = np.random.default_rng(64)
    pairs = _homologous(65, [100, 90], band)
    pairs.append((_codes(rng, 100), _codes(rng, 60)))
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    packed["lo"][2] = -100       # end cell (100, 60) at band cell 60
    _check_pairhmm5_vs_plain(packed, band, cuda)


def test_pairhmm5_max_live(cuda):
    """max_live equal to the widest pair's live width runs (2 warps here,
    against 8 at the band); one below it raises before any launch."""
    band = 1024
    pairs = _homologous(11, [200, 150, 230], band)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    widest = max(min(band, len(t) + 1) for _q, t in pairs)
    assert _check_pairhmm5_vs_plain(packed, band, cuda, widest) == 64
    assert _check_pairhmm5_vs_plain(packed, band, cuda, band) == 256
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    p = tp5.Hmm5Params()
    em = torch.from_numpy(p.emissions()).to(cuda)
    n0 = cuda_build.launches()
    with pytest.raises(ValueError, match="max_live"):
        pairhmm5_cuda.pairhmm5_fwd(*args, em, band=band, params=p,
                                   max_live=widest - 1)
    assert cuda_build.launches() == n0


@pytest.mark.parametrize("band,n,cells,scratch", [
    (8192, 5000, 8, False), (16384, 9000, 16, True),
    (32768, 17000, 64, True)])
def test_pairhmm5_wide_windows(cuda, band, n, cells, scratch):
    """Live windows past 32 warps of 4 cells: 8 cells a lane with the
    state rows in shared memory, 16 and 64 with them in global scratch;
    a 300-base query inside a long target."""
    rng = np.random.default_rng(n)
    q = _codes(rng, 300)
    t = np.concatenate([_codes(rng, 4000), _mutate(rng, q),
                        _codes(rng, n - 4000 - 300)])[:n]
    pairs = [(q, t), (q[:120], q[:118])]
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    live = min(band, len(t) + 1)
    assert pairhmm5_cuda.cells_per_lane(live) == cells
    assert (pairhmm5_cuda._lib().pairhmm5_scratch_floats(live) > 0) == \
        scratch
    _check_pairhmm5_vs_plain(packed, band, cuda)


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


@pytest.mark.parametrize("band", [16, 32, 256, 512, 1024, 9000])
def test_pairhmm5_base5_rows_in_32_thread_blocks(cuda, band):
    """Code-5 query rows at every launch shape (max_live is the band
    here): one warp, 2, 4 and 8 warps of 4 cells a lane, and 18 warps of
    16 with global scratch rows."""
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
    n_nodes = torch.from_numpy(_real_nodes(preds)).to(cuda)
    got = getattr(poa_cuda, kernel)(*args, **kw, n_nodes=n_nodes)
    torch.cuda.synchronize()
    ref = poa_cuda.poa_affine(*[a.cpu() for a in args], **kw)
    _assert_poa_live(got, ref, args[2], args[4], n_nodes, band)


# ---------------------------------------------------------------- wide routes
# Rows past each kernel's widest narrow launch (POA rows over 16,384 live
# cells, 5-state windows over 65,536, 3-state bands over 16,384) run the
# wide kernels; `-k wide` selects these tests.

def _embedded_pair(rng, m, n, at):
    """A query of m bases and a target of n bases holding a mutated copy
    of it from position `at`."""
    q = _codes(rng, m)
    t = np.concatenate([_codes(rng, at), _mutate(rng, q),
                        _codes(rng, n)])[:n]
    return q, t


@pytest.mark.parametrize("kernel,P", [("poa_chain", 1), ("poa_chain", 2),
                                      ("poa_affine", 1), ("poa_affine", 2)])
def test_poa_wide_rows_match_plain(cuda, kernel, P):
    """A bin whose live row passes 16,384 cells (about 50 nodes, a query
    of 20,000 bases, band 32768) runs the wide kernel through the
    wrapper, bit-equal to the plain version on the live cells."""
    from test_torch_poa_live import ragged_batch
    chain = kernel == "poa_chain"
    inputs = ragged_batch(P + 77, P, 50, 20000, 32768, chain, n_lo=20)
    inputs[4][-1] = 20000
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], 32768)
    assert max_live == 20001 and poa_cuda.poa_route(max_live) == "wide"
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == chain
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=32768, o1=400, e1=30, o2=1200, e2=1)
    n0 = cuda_build.launches()
    got = getattr(poa_cuda, kernel)(*args[:5], sub, **kw, n_nodes=args[5],
                                    max_live=max_live)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["poa_wide"] == n0["poa_wide"] + 1 and n1[kernel] == n0[kernel]
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], 32768)


@pytest.mark.parametrize("kernel,P", [("poa_chain", 1), ("poa_chain", 3),
                                      ("poa_affine", 1), ("poa_affine", 3)])
def test_poa_wide_offsets_match_plain(cuda, kernel, P):
    """The wide route where the band moves: queries of about 40,000 bases
    at band 32768 (so off[v] steps), 64-node chains with a middle source
    whose offset jumps by 2,500, and DAGs whose predecessors lie up to 60
    nodes back at shifts up to thousands of cells, past one CTA's slice
    of the row; ragged l_len and n_nodes.  Bit-equal to the plain
    version on the live cells, one poa_wide launch."""
    inputs = chip_smoke.poa_offset_batch(P + 170, P, 64, 40000, 32768,
                                         chain=kernel == "poa_chain",
                                         n_lo=40)
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == (
        kernel == "poa_chain")
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], 32768)
    assert poa_cuda.poa_route(max_live) == "wide"
    # a chain's middle source jumps past a CTA's slice (about 2,048
    # cells); a DAG reads predecessor cells farther away than that
    off = inputs[2].astype(np.int64)
    if kernel == "poa_chain":
        assert np.diff(off[0, :int(inputs[5][0])]).max() >= 2500
    else:
        assert max(int(off[p, v]) - int(off[p, u])
                   for p in range(P) for v in range(int(inputs[5][p]))
                   for u in inputs[1][p, v] if 0 <= u < v) > 2048
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=32768, o1=400, e1=30, o2=1200, e2=1)
    n0 = cuda_build.launches()
    got = getattr(poa_cuda, kernel)(*args[:5], sub, **kw, n_nodes=args[5],
                                    max_live=max_live)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["poa_wide"] == n0["poa_wide"] + 1 and n1[kernel] == n0[kernel]
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], 32768)


def test_poa_align_bin_wide(cuda):
    """align_bin, the poa engine's card route, on a bin whose live row
    passes the widest team cover: the wide kernel, dirs and ends equal to
    the CPU run's on the live cells."""
    rng = np.random.default_rng(5)
    graph = tpoa.PoaGraph.from_sequence(_codes(rng, 60))
    prep = tpoa._affine_prepare(graph, _codes(rng, 20000), 1000, 0.1)
    assert prep["B"] == 32768
    stack = {k: prep[k][None] for k in ("bases", "preds", "off", "q_ext")}
    args = (stack, np.asarray([prep["L"]], np.int32), SUBMAT, prep["B"],
            400, 30, 1200, 1)
    nn = np.asarray([prep["N"]], np.int32)
    n0 = cuda_build.launches()
    d, e = poa_cuda.align_bin(*args, cuda, n_nodes=nn)
    assert cuda_build.launches()["poa_wide"] == n0["poa_wide"] + 1
    d_r, e_r = poa_cuda.align_bin(*args, "cpu", n_nodes=nn)
    live = poa_cuda.live_mask(torch.from_numpy(stack["off"]),
                              torch.tensor([prep["L"]]), torch.from_numpy(nn),
                              prep["B"]).numpy()
    assert np.array_equal(d[live], d_r[live])
    assert np.array_equal(e[0, :prep["N"]], e_r[0, :prep["N"]])


@pytest.mark.parametrize("N,L,n,l_len", [
    (64, 128, 60, 100),       # live rows and columns inside the padding
    (64, 2048, 64, 2048),     # the whole grid, 16 warps
    (64, 32768, 64, 20000),   # past the widest cover: the wide kernel
    (40, 20000, 33, 20000),
    (48, 40000, 40, 36000)])  # a DAG over 16 CTAs of 2,304 columns
def test_poa_linear_wide_and_live_rows(cuda, N, L, n, l_len):
    """poa_linear with n_nodes and l_len (poa_align's live extents):
    bit-equal to the plain version on the live cells, ends on the real
    nodes where l_len is L; rows past 16,384 live cells run the wide
    kernel."""
    rng = np.random.default_rng(N + L + n)
    bases, preds = _poa_dag(rng, N)
    preds[n:] = -1
    preds[:n][preds[:n] >= n] = -1
    q = np.full(L, 5, np.uint8)
    q[:l_len] = _codes(rng, l_len)
    args = [torch.from_numpy(x).to(cuda) for x in (bases, preds, q)]
    kw = dict(gap=30, match=10, mismatch=-15)
    name = ("poa_linear" if poa_cuda.poa_route(l_len + 1) == "team"
            else "poa_linear_wide")
    assert (name == "poa_linear_wide") == (l_len >= 16384)
    n0 = cuda_build.launches()[name]
    got = poa_cuda.poa_linear(*args, **kw, n_nodes=n, l_len=l_len)
    torch.cuda.synchronize()
    assert cuda_build.launches()[name] == n0 + 1
    ref = tpoa.poa_align_scan(*args, **kw)
    live = poa_cuda.linear_live_mask(N, L, n, l_len, cuda)
    assert torch.equal(got[0][live], ref[0][live])
    assert torch.equal(got[1][live], ref[1][live])
    if l_len == L:
        assert torch.equal(got[2][:n], ref[2][:n])


def test_poa_wide_cluster_shapes(cuda):
    """The clusters csrc/poa_cluster.cu picks: phase 8's width (20,001
    live cells) in registers over 16 CTAs, a width past the register
    instances in 512-thread CTAs with the lanes' cells in global
    scratch, and fewer CTAs where max_ctas caps them."""
    shape = poa_cuda.cluster_shape
    for linear in (False, True):
        assert shape(20001, linear=linear) == dict(
            ctas=16, threads=320, cells=4, registers=True, words=0)
        assert shape(32768, linear=linear) == dict(
            ctas=16, threads=512, cells=4, registers=True, words=0)
    for linear, planes in ((False, 7), (True, 3)):
        sh = shape(70001, linear=linear)
        assert not sh["registers"] and sh["ctas"] == 16
        assert sh["threads"] == 512 and sh["cells"] == 9
        assert sh["words"] == planes * 16 * 512 * 9
    assert shape(4096, 2) == dict(ctas=2, threads=512, cells=4,
                                  registers=True, words=0)
    assert shape(100, 16)["ctas"] == 1


def _check_forced_wide(cuda, kernel, inputs, band, max_ctas):
    """One wide-route launch of `kernel` forced at max_ctas CTAs (0: as
    cluster_shape picks), bit-equal to the plain version on the live
    cells, counted once as poa_wide."""
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], band)
    args = [torch.from_numpy(x).to(cuda) for x in inputs]
    sub = torch.from_numpy(SUBMAT).to(cuda)
    kw = dict(band=band, o1=400, e1=30, o2=1200, e2=1)
    n0 = cuda_build.launches()
    got = poa_cuda._launch(kernel, *args[:5], sub, band, (400, 30, 1200, 1),
                           args[5], max_live, "wide", max_ctas=max_ctas)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    assert n1["poa_wide"] == n0["poa_wide"] + 1 and n1[kernel] == n0[kernel]
    ref = tpoa.poa_align_scan_affine(*args[:5], sub, **kw)
    _assert_poa_live(got, ref, args[2], args[4], args[5], band)
    return max_live


@pytest.mark.parametrize("kernel", ["poa_chain", "poa_affine"])
@pytest.mark.parametrize("ctas", [2, 4, 8, 16])
def test_poa_wide_forced_cluster_sizes(cuda, kernel, ctas):
    """The wide route forced at a narrow width (band 4096, queries of
    about 5,000 bases, so the band moves) in 2, 4, 8 and 16 CTAs: DAG
    predecessors up to hundreds of cells away, a chain's middle source
    jumping to the end of its offsets."""
    chain = kernel == "poa_chain"
    inputs = chip_smoke.poa_offset_batch(ctas + 300, 2, 48, 5000, 4096,
                                         chain=chain, n_lo=20, jump=1000,
                                         far=30, step=100)
    assert poa_cuda.chain_certified(inputs[1], inputs[2]) == chain
    max_live = _check_forced_wide(cuda, kernel, inputs, 4096, ctas)
    assert poa_cuda.poa_route(max_live) == "team"
    assert poa_cuda.cluster_shape(max_live, ctas)["ctas"] == ctas


@pytest.mark.parametrize("kernel", ["poa_chain", "poa_affine"])
@pytest.mark.parametrize("lq,band", [(72000, 131072), (70000, 65536)])
def test_poa_wide_past_the_register_instance(cuda, kernel, lq, band):
    """Widths past the register instance's 32,768 cells (max_live 72,001
    at band 131072; 65,536 at band 65536, where the band moves): the
    global-scratch instance, 16 nodes."""
    chain = kernel == "poa_chain"
    inputs = chip_smoke.poa_offset_batch(lq + band, 1, 16, lq, band,
                                         chain=chain, n_lo=16, jump=2500,
                                         far=12)
    max_live = poa_cuda.check_live(inputs[1], inputs[2], inputs[4],
                                   inputs[5], band)
    assert not poa_cuda.cluster_shape(max_live)["registers"]
    _check_forced_wide(cuda, kernel, inputs, band, 0)


def _linear_wide_case(cuda, seed, N, n, L, l_len):
    rng = np.random.default_rng(seed)
    bases, preds = _poa_dag(rng, N, forward=3)
    preds[n:] = -1
    preds[:n][preds[:n] >= n] = -1
    q = np.full(L, 5, np.uint8)
    q[:l_len] = _codes(rng, l_len)
    return [torch.from_numpy(x).to(cuda) for x in (bases, preds, q)]


def _check_linear_wide(cuda, args, n, l_len, max_ctas):
    N, L = args[0].shape[0], args[2].shape[0]
    kw = dict(gap=30, match=10, mismatch=-15)
    n0 = cuda_build.launches()["poa_linear_wide"]
    got = poa_cuda._launch_linear(*args, kw["gap"], kw["match"],
                                  kw["mismatch"], n, l_len, "wide",
                                  max_ctas=max_ctas)
    torch.cuda.synchronize()
    assert cuda_build.launches()["poa_linear_wide"] == n0 + 1
    ref = tpoa.poa_align_scan(*args, **kw)
    live = poa_cuda.linear_live_mask(N, L, n, l_len, cuda)
    assert torch.equal(got[0][live], ref[0][live])
    assert torch.equal(got[1][live], ref[1][live])
    if l_len == L:
        assert torch.equal(got[2][:n], ref[2][:n])


@pytest.mark.parametrize("ctas", [2, 4, 8, 16])
def test_poa_linear_wide_forced_cluster_sizes(cuda, ctas):
    """poa_linear's wide route forced at a narrow width (l_len 9,000 of a
    query padded to 16,384, a 40-node DAG in a bin of 48) in 2, 4, 8 and
    16 CTAs."""
    args = _linear_wide_case(cuda, ctas, 48, 40, 16384, 9000)
    _check_linear_wide(cuda, args, 40, 9000, ctas)
    assert poa_cuda.cluster_shape(9001, ctas, linear=True)["ctas"] == ctas


def test_poa_linear_wide_past_the_register_instance(cuda):
    """poa_linear past its register instance's 32,768 columns (a 16-node
    DAG against 70,000 bases): the global-scratch instance."""
    assert not poa_cuda.cluster_shape(70001, linear=True)["registers"]
    args = _linear_wide_case(cuda, 9, 16, 16, 70000, 70000)
    _check_linear_wide(cuda, args, 16, 70000, 0)


@pytest.mark.parametrize("cover", sorted(poa_cuda.TEAM_SHAPES["poa_linear"]))
def test_poa_linear_every_team_shape(cuda, cover):
    """Each poa_linear team shape on a query that fills its cover (L + 1
    = cover), every cell bit-equal to the plain version."""
    rng = np.random.default_rng(cover)
    bases, preds = _poa_dag(rng, 40, forward=3)
    q = _codes(rng, cover - 1)
    args = [torch.from_numpy(x).to(cuda) for x in (bases, preds, q)]
    kw = dict(gap=30, match=10, mismatch=-15)
    got = poa_cuda.poa_linear(*args, **kw)
    torch.cuda.synchronize()
    ref = tpoa.poa_align_scan(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _wide3_pairs(case):
    """The 3-state wide-route cases: (pairs, band, max_live, shared-memory
    rows, params).  All but "default" take chip_smoke's WIDE_HMM_GAPS, a
    gap that extends at 0.999 a base: at the default 0.79 a query inside
    a long target has a float32 posterior of 0 in the plain version and
    the kernels alike, and its forward values pass 1e-30 on a few
    thousand band cells of a row only, so the checks would compare zeros.
    "default" keeps the path's HmmParams(): the underflow regime."""
    rng = np.random.default_rng(32768)
    gaps = tp.HmmParams(**chip_smoke.WIDE_HMM_GAPS)
    if case in ("smem", "default"):
        # phase 8's pair, a 300-base query in the middle of a 20,000-base
        # target, beside short pairs
        pairs = [_embedded_pair(rng, 300, 20000, 10000)]
        pairs += _homologous(32769, [250, 40], 32768)
        return (pairs, 32768, 20001, True,
                tp.HmmParams() if case == "default" else gaps)
    if case == "global":
        # a 64-row query in the middle of a 100,000-base target: past the
        # 86,016 cells the cluster's shared memory holds
        return ([_embedded_pair(rng, 64, 100000, 50000)], 131072, 100001,
                False, gaps)
    # two wide pairs in one launch: two clusters
    return ([_embedded_pair(rng, 300, 20000, 10000),
             _embedded_pair(rng, 200, 19000, 5000)], 32768, 20001, True,
            gaps)


def _hold_wide3(what, pairs, packed, args, em, kw, fM, lsF, logZ, post,
                long_pairs, logz_64=False):
    """The wide route's outputs against the plain versions: zeros outside
    the live windows, chip_smoke.check_hmm's three tolerances, and each
    pair of long_pairs seen (`chip_smoke.long_pair_seen`: hits in both
    runs, the plain posterior above 0.5, plain fM above 1e-30 at 90% of
    its window's positions); with no long_pairs (the default gaps), the
    kernels' posterior 0 wherever the plain one is instead.  logz_64:
    logZ held to the plain steps in float64 (check_hmm's logZ_64)."""
    fM_r, lsF_r, logZ_r = tp.forward_banded(*args, em, **kw)
    ref = tp.backward_posterior(fM_r, lsF_r, logZ_r, *args, em, **kw)
    live = banded_cuda.live_mask(args[2], args[3], args[4], fM.shape[1],
                                 kw["band"])
    assert not bool(fM[~live].any()) and not bool(post[~live].any())
    z64 = (tp.forward_banded(*args, em, **kw, dtype=torch.float64)[2]
           if logz_64 else None)
    chip_smoke.check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, ref,
                         what, quiet=True, logZ_64=z64)
    if not long_pairs:
        assert not bool(post[ref == 0].any())
        return
    hits = tp.banded_hits(post, pairs, packed["lo"], 0.5)
    ref_hits = tp.banded_hits(ref, pairs, packed["lo"], 0.5)
    for k in long_pairs:
        chip_smoke.long_pair_seen(f"{what}, pair {k}", hits[k], ref_hits[k],
                                  ref[k], fM_r[k], live[k])


@pytest.mark.parametrize("case", ["smem", "global", "two_clusters",
                                  "default"])
def test_pairhmm_wide_band_matches_plain(cuda, case):
    """3-state bands past the narrow kernels' 16384 take the cluster
    kernels through the wrappers: a 300-base query inside a 20,000-base
    target beside short pairs (max_live 20,001, the state rows in the
    CTAs' shared memory), a window past the shared-memory cover (max_live
    100,001, global scratch), two wide pairs as two clusters, and
    phase 8's pair at the default gaps (the underflow regime: zeros where
    the plain posterior is 0, logZ within LOGZ_RTOL)."""
    pairs, band, want, smem, p = _wide3_pairs(case)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    max_live = banded_cuda.live_width(args[3], band)
    assert max_live == want
    assert pairhmm_cuda.pairhmm_route(band) == "wide"
    shape = pairhmm_cuda.cluster_shape(max_live)
    assert shape["smem"] == smem
    assert shape["ctas"] * shape["threads"] * shape["cells"] >= max_live
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*args, em, **kw,
                                             max_live=max_live)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *args, em, **kw,
                                    max_live=max_live)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    for name in ("pairhmm_fwd_wide", "pairhmm_bwd_wide"):
        assert n1[name] == n0[name] + 1
    assert n1["pairhmm_fwd"] == n0["pairhmm_fwd"]
    assert n1["pairhmm_bwd"] == n0["pairhmm_bwd"]
    long_pairs = [] if case == "default" else [
        k for k, (_q, t) in enumerate(pairs) if len(t) > 16384]
    # "global": 50,000-base gaps, over which float32 sums in any order miss
    # float64's logZ by ~2e-3 (the plain version's 15.65553 and the
    # kernels' 15.65499 against 15.65354 on the H100), ten times
    # LOGZ_RTOL at this logZ; its logZ is held to the float64 run
    _hold_wide3(f"pairhmm {case} max_live {max_live}", pairs, packed, args,
                em, kw, fM, lsF, logZ, post, long_pairs,
                logz_64=case == "global")


@pytest.mark.parametrize("max_live,max_ctas", [(300, 0), (16384, 0),
                                               (20001, 8)])
def test_pairhmm_cluster_kernels_at_narrow_widths(cuda, max_live, max_ctas):
    """The cluster kernels forced at widths the narrow kernels take (a
    cluster of 2 CTAs of one warp, 16 CTAs of 4 warps) and at phase 8's
    width in 8 CTAs of 10 warps, through the private launches: within
    chip_smoke's three tolerances of the plain versions, every long pair
    seen."""
    rng = np.random.default_rng(max_live)
    band = 1 << (max_live - 1).bit_length()
    pairs = [_embedded_pair(rng, 150, max_live - 1, (max_live - 150) // 2),
             _homologous(max_live, [90], band)[0]]
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    assert banded_cuda.live_width(args[3], band) == max_live
    shape = pairhmm_cuda.cluster_shape(max_live, max_ctas)
    want = {300: (2, 32), 16384: (16, 128), 20001: (8, 320)}[max_live]
    assert (shape["ctas"], shape["threads"]) == want and shape["smem"]
    p = tp.HmmParams(**chip_smoke.WIDE_HMM_GAPS)
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    fM, lsF, logZ = pairhmm_cuda._launch_fwd(
        *args, em, **kw, max_live=max_live, route="wide", max_ctas=max_ctas)
    post = pairhmm_cuda._launch_bwd(
        fM, lsF, logZ, *args, em, **kw, max_live=max_live, route="wide",
        max_ctas=max_ctas)
    torch.cuda.synchronize()
    _hold_wide3(f"pairhmm cluster at max_live {max_live}", pairs, packed,
                args, em, kw, fM, lsF, logZ, post, [0])


def _wide5_pairs(case):
    """The 5-state wide-route cases: (pairs, band, max_live, shared-memory
    rows, params).  The first three take chip_smoke's WIDE_HMM5_GAPS, a
    long gap that decays as 0.9999 a base: at the default 0.9966, a
    short query's path in a target past 60,000 bases sits below float32's
    range in the forward or the backward pass wherever it is copied, and
    the long pairs' posteriors are 0 in the plain version and the kernels
    alike.  "deep" keeps the default and copies the query 30,000 bases in,
    where the path's forward seed is a few subnormal ulps, so each order
    of the in-row sums gives another float32 logZ
    (tests/pairhmm5_conditioning_report.py)."""
    rng = np.random.default_rng(70001)
    gaps = tp5.Hmm5Params(p_match=0.8, **chip_smoke.WIDE_HMM5_GAPS)
    if case == "dsmem":
        # a 300-base query inside a 70,000-base target beside a short pair
        return ([_embedded_pair(rng, 300, 70000, 10000),
                 _homologous(70002, [120], 131072)[0]], 131072, 70001, True,
                gaps)
    if case == "global":
        # a 64-row query inside a 140,000-base target: past the 131,072
        # cells the cluster's shared memory holds; the backward pass
        # carries the copy's path through the 15 CTAs after it
        return ([_embedded_pair(rng, 64, 140000, 10000)], 262144, 140001,
                False, gaps)
    if case == "deep":
        return ([_embedded_pair(rng, 300, 70000, 30000)], 131072, 70001,
                True, tp5.Hmm5Params(p_match=0.8))
    # two wide pairs in one launch: two clusters
    return ([_embedded_pair(rng, 300, 70000, 10000),
             _embedded_pair(rng, 200, 68000, 50000)], 131072, 70001, True,
            gaps)


# "deep": logZ of the cluster kernels (the card, and the numpy model of
# their schedule to the last digit), of the plain version, and of the
# model in float64 (tests/pairhmm5_conditioning_report.py); each float32
# value is held to its own, and both lie within DEEP_LOGZ_GAP of float64
DEEP_LOGZ = dict(kernel=448.1207580566406, plain=445.6746520996094,
                 float64=479.8837652043527)
DEEP_LOGZ_GAP = 35.0


@pytest.mark.parametrize("case", ["dsmem", "global", "two_clusters",
                                  "deep"])
def test_pairhmm5_wide_route_matches_plain(cuda, case):
    """5-state pairs past the narrow kernels' 65,536 cells (a short query
    inside a long target) take the cluster kernels: the state rows in the
    CTAs' shared memory at max_live 70,001, in global scratch at 140,001
    (band 262144), and two pairs as two clusters; within chip_smoke's
    three tolerances of the plain versions, every long pair's plain
    posterior reaching 0.5, zero outside the live windows.  "deep" holds
    logZ to its pinned float32 readings instead."""
    pairs, band, want, smem, p = _wide5_pairs(case)
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    max_live = banded_cuda.live_width(args[3], band)
    assert max_live == want
    assert pairhmm5_cuda.pairhmm5_route(max_live) == "wide"
    shape = pairhmm5_cuda.cluster_shape(max_live)
    assert shape["smem"] == smem
    assert shape["ctas"] * shape["threads"] * shape["cells"] >= max_live
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, params=p)
    n0 = cuda_build.launches()
    fM, lsF, logZ = pairhmm5_cuda.pairhmm5_fwd(*args, em, **kw,
                                               max_live=max_live)
    post = pairhmm5_cuda.pairhmm5_bwd(fM, lsF, logZ, *args, em, **kw,
                                      max_live=max_live)
    torch.cuda.synchronize()
    n1 = cuda_build.launches()
    for name in ("pairhmm5_fwd_wide", "pairhmm5_bwd_wide"):
        assert n1[name] == n0[name] + 1
    assert n1["pairhmm5_fwd"] == n0["pairhmm5_fwd"]
    assert n1["pairhmm5_bwd"] == n0["pairhmm5_bwd"]
    fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em, **kw)
    live = banded_cuda.live_mask(args[2], args[3], args[4], fM.shape[1],
                                 band)
    assert not bool(fM[~live].any()) and not bool(post[~live].any())
    if case == "deep":
        for x in (fM, lsF, logZ, post):
            assert bool(torch.isfinite(x).all())
        for name, z in (("kernel", logZ), ("plain", logZ_r)):
            z = float(z[0])
            assert abs(z - DEEP_LOGZ[name]) <= \
                chip_smoke.LOGZ_RTOL * DEEP_LOGZ[name], (name, z)
            assert abs(z - DEEP_LOGZ["float64"]) <= DEEP_LOGZ_GAP
        return
    ref = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em, **kw)
    chip_smoke.check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, ref,
                         f"pairhmm5 {case} max_live {max_live}", quiet=True)
    for k, (q, t) in enumerate(pairs):
        if len(t) > 65536:
            assert float(ref[k].max()) > 0.5, (case, k)


@pytest.mark.parametrize("max_live", [300, 16384])
def test_pairhmm5_cluster_kernels_at_narrow_widths(cuda, max_live):
    """The cluster kernels forced at widths the narrow kernels take (a
    cluster of 2 CTAs of one warp, and 16 CTAs of 4 warps) agree with
    the plain versions as the narrow kernels do."""
    rng = np.random.default_rng(max_live)
    band = 1 << (max_live - 1).bit_length()
    pairs = [_embedded_pair(rng, 150, max_live - 1, (max_live - 150) // 2),
             _homologous(max_live, [90], band)[0]]
    packed = tb.pack_band_batch(pairs, band, min_batch=1)
    args = [torch.from_numpy(packed[k]).to(cuda) for k in KEYS]
    assert banded_cuda.live_width(args[3], band) == max_live
    p = tp5.Hmm5Params(p_match=0.8)
    em = torch.from_numpy(p.emissions()).to(cuda)
    kw = dict(band=band, params=p, max_live=max_live)
    fM, lsF, logZ = pairhmm5_cuda._launch_fwd(*args, em, **kw,
                                              route="wide")
    post = pairhmm5_cuda._launch_bwd(fM, lsF, logZ, *args, em, **kw,
                                     route="wide")
    torch.cuda.synchronize()
    kw.pop("max_live")
    fM_r, lsF_r, logZ_r = tp5.forward_banded5(*args, em, **kw)
    ref = tp5.backward_posterior5(fM_r, lsF_r, logZ_r, *args, em, **kw)
    chip_smoke.check_hmm(fM, lsF, logZ, post, fM_r, lsF_r, logZ_r, ref,
                         f"pairhmm5 cluster at max_live {max_live}",
                         quiet=True)
    live = banded_cuda.live_mask(args[2], args[3], args[4], fM.shape[1],
                                 band)
    assert not bool(fM[~live].any()) and not bool(post[~live].any())


def test_pangenome_star_run_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    """run_pangenome on tests/test_pangenome.py's small_graph input
    (3 haplotypes, root_len 6000, seed 17): every artifact but the layout
    files byte-identical to the port's CPU run, through banded_dp."""
    import os
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.pangenome import driver
    from cactus_tpu_torch.testutil import evolver
    from cactus_tpu_torch.utils.trees import parse_newick
    sim = evolver.simulate(parse_newick("(a:0.02,b:0.02,c:0.02)root;"),
                           root_len=6000, seed=17)
    genomes = {ev: {f"{ev}.c": Sequence(f"{ev}.c", sim.genomes[ev].codes)}
               for ev in "abc"}
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        out[name] = str(tmp_path / name)
        cuda_build.reset_launches()
        driver.run_pangenome(genomes, "a", out[name], device=dev)
        launches = cuda_build.launches()
    assert launches["banded_dp"] > 0 and launches["banded_traceback"] > 0
    files = sorted(os.listdir(out["cpu"]))
    assert files == sorted(os.listdir(out["cuda"]))
    for f in files:
        if f.endswith((".lay.tsv", ".draw.png")):
            continue
        with open(os.path.join(out["cpu"], f), "rb") as a, \
                open(os.path.join(out["cuda"], f), "rb") as b:
            assert a.read() == b.read(), f


def test_seed_join_on_the_card_equals_cpu(cuda):
    from cactus_tpu_torch.config import SEED_12_OF_19
    from cactus_tpu_torch.ops import seeds
    rng = np.random.default_rng(4)
    q = rng.integers(0, 5, (3, 1 << 16)).astype(np.uint8)
    t = q.copy()
    t[:, ::7] = rng.integers(0, 4, t[:, ::7].shape)
    q[:, 1000:9000] = np.tile(q[:, 1000:1040], 200)
    qv, tv = rng.random(q.shape) > 0.02, rng.random(t.shape) > 0.02
    for kw in (dict(k=15, max_occ=64, max_anchors=1 << 17),
               dict(k=15, max_occ=1, max_anchors=1 << 17),
               dict(k=15, step=3, pattern=SEED_12_OF_19, max_occ=64,
                    max_anchors=1 << 12)):
        got = seeds.seed_join_batch(q, qv, t, tv, device=cuda, **kw)
        want = seeds.seed_join_batch(q, qv, t, tv, device="cpu", **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert int(want[2].min()) > 0


def test_device_join_batch_on_the_card_equals_the_host_join(cuda):
    import dataclasses
    from cactus_tpu_torch.config import Config
    from cactus_tpu_torch.io.fasta import Sequence
    from cactus_tpu_torch.phases import blast
    rng = np.random.default_rng(6)
    a = rng.integers(0, 4, 300_000).astype(np.uint8)
    b = a.copy()
    sub = rng.random(len(b)) < 0.08
    b[sub] = rng.integers(0, 4, int(sub.sum()))
    for aligner in ("lastz", "fastga"):
        cfg = dataclasses.replace(Config.default().blast, aligner=aligner)
        tasks = blast.pair_tasks(Sequence("q", a), Sequence("t", b), "q",
                                 "t", cfg, preset="default")
        out = [None] * len(tasks)
        blast._device_join_batch(tasks, list(range(len(tasks))), out, cfg,
                                 1 if aligner == "fastga" else 64,
                                 lambda lq: 1 << 20, None, cuda)
        host = blast.anchors_for_tasks(tasks, cfg, device="cpu")
        for (dq, dt), (hq, ht) in zip(out, host):
            np.testing.assert_array_equal(dq, hq)
            np.testing.assert_array_equal(dt, ht)
        assert len(out[0][0]) > 1000


def test_kmer_counts_mask_on_the_card_equals_cpu(cuda):
    from cactus_tpu_torch.preprocessor import masking
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    for at in rng.choice(np.arange(0, len(codes) - 500, 500), 400,
                         replace=False):
        codes[at:at + 500] = unit
    codes[5000:6000] = 4
    got = masking.kmer_counts_mask(codes, device=cuda)
    want = masking.kmer_counts_mask(codes, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.5


def test_felsenstein_on_the_card_equals_cpu(cuda):
    from cactus_tpu_torch import phast
    from cactus_tpu_torch.utils.trees import parse_newick
    tree = parse_newick("(((a:0.1,b:0.2)x:0.05,c:0.3)y:0.1,(d:0.2,e:0.1)z:"
                        "0.2)r;")
    E = len(list(tree.preorder()))
    rng = np.random.default_rng(10)
    obs = np.where(rng.random((200_000, E, 4)) < 0.3, 1.0,
                   1e-3).astype(np.float32)
    obs[:, [0, 1, 4]] = 1.0                      # ancestors: missing
    sc = np.exp(rng.normal(size=(33, E - 1)))
    got = phast.column_ll_multi(obs, tree, sc, device=cuda)
    want = phast.column_ll_multi(obs, tree, sc, device="cpu")
    ulp = np.spacing(np.abs(want).max(axis=0).astype(np.float32))
    assert float((np.abs(got - want) / ulp).max()) <= 4
    small = phast.felsenstein_bytes_per_column(33, E) * 1000
    chunked = phast.column_ll_multi(obs, tree, sc, device=cuda, budget=small)
    np.testing.assert_array_equal(chunked, got)


def test_make_mesh_refuses_more_cards_than_the_process_has(cuda):
    from cactus_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    mesh = make_mesh(n, device=cuda)
    assert all(s.device.type == "cuda" for s in mesh.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(n + 1, device=cuda)


_RANK = r"""
import sys
sys.path.insert(0, sys.argv[4])
import torch
from cactus_tpu_torch.parallel import distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = torch.device("cuda", 0)
assert dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=2, process_id=rank, backend="gloo",
                       device=dev)
import test_torch_parallel as t
t._maf("cactus_tpu_torch", out, device=dev, n_devices=2)
dist.shutdown()
"""


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two ranks on cuda:0 (NCCL refuses two ranks a card, so gloo):
    both MAFs of the multi-chip driver workload equal the one-process
    run's on the card."""
    import os
    import socket
    import subprocess
    import sys
    import test_torch_parallel as tpar
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(port), str(tmp_path / f"r{r}.maf"),
                               os.path.join(repo, "tests")], env=env,
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    _res, want = tpar._maf("cactus_tpu_torch", tmp_path / "one.maf",
                           device=cuda)
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-4000:]
    for r in range(2):
        assert (tmp_path / f"r{r}.maf").read_bytes() == want
