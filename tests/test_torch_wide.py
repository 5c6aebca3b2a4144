"""The wide routes of the port's kernels and poa_linear's live contract,
against the JAX package (CPU).

Rows past a kernel's widest narrow launch run a wide kernel on the card:
POA rows over POA_MAX_COVER (16,384) live cells, 5-state windows over
PAIRHMM5_MAX_CELLS (65,536) cells, 3-state bands over
PAIRHMM_MAX_NARROW_BAND (16,384).  Here, on the CPU:
- each route function picks the wide kernel exactly past its cap, and
  its cap is the one csrc/ compiles; no wrapper check refuses such a
  width;
- each plain version (what chip_smoke.py and tests/test_torch_cuda.py
  hold the wide kernels to) equals the JAX package's function past the
  cap, at a CPU-cheap row count: the POA affine scan bit for bit at band
  32768, the pair-HMMs within the ulps tests/test_torch_pairhmm.py and
  tests/test_torch_pairhmm5.py state;
- poa_linear's live contract (the real nodes v < n_nodes and the columns
  j <= l_len): the plain version on those cells equals the JAX package's
  poa_align_scan, and poa_align, which passes them, reads no other cell.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cactus_tpu.ops import banded as jb
from cactus_tpu.ops import pairhmm as jp
from cactus_tpu.ops import pairhmm5 as j5
from cactus_tpu.ops import poa as jpoa
from cactus_tpu.ops.banded import score_matrix_6
from cactus_tpu.config import PoaParams as JPoaParams
from cactus_tpu_torch.config import params_from_numpy
from cactus_tpu_torch.ops import banded_cuda, pairhmm5_cuda, pairhmm_cuda
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm5 as t5
from cactus_tpu_torch.ops import poa as tpoa
from cactus_tpu_torch.ops import poa_cuda
from test_torch_pairhmm import KEYS, _mutate, log_scale_ulp
from test_torch_pairhmm import POST_ULPS as POST_ULPS3
from test_torch_pairhmm5 import POST_ULPS as POST_ULPS5

MP = jpoa.MAX_PREDS
SUB = score_matrix_6(JPoaParams().sub_matrix).astype(np.int32)
GAPS = dict(o1=400, e1=30, o2=1200, e2=1)
CSRC = pathlib.Path(poa_cuda.__file__).parent.parent / "csrc"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run wide rows of many small ops; beside the other test
    workers, torch's intra-op threads only contend for the cores (tens of
    times slower), so each test here runs on one and restores the count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constant(src: str, name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


# ---------------------------------------------------------------- routes

def test_routes_pick_the_wide_kernels_exactly_past_each_cap():
    assert poa_cuda.POA_MAX_COVER == 16384
    assert poa_cuda.poa_route(1) == "team"
    assert poa_cuda.poa_route(16384) == "team"
    assert poa_cuda.poa_route(16385) == "wide"
    assert poa_cuda.poa_route(20001) == "wide"
    assert pairhmm5_cuda.PAIRHMM5_MAX_CELLS == 65536
    assert pairhmm5_cuda.pairhmm5_route(65536) == "narrow"
    assert pairhmm5_cuda.pairhmm5_route(65537) == "wide"
    assert pairhmm5_cuda.pairhmm5_route(70001) == "wide"
    assert pairhmm_cuda.PAIRHMM_MAX_NARROW_BAND == 16384
    assert pairhmm_cuda.pairhmm_route(16384) == "narrow"
    assert pairhmm_cuda.pairhmm_route(16385) == "wide"
    assert pairhmm_cuda.pairhmm_route(32768) == "wide"


def test_caps_are_the_ones_csrc_compiles():
    """Each Python cap equals the widest narrow launch its source builds:
    the widest team cover of csrc/poa.cu's shape macros, csrc/pairhmm5.cu
    kMaxCells (32 kMaxWarps warps of 64 cells) and csrc/pairhmm.cu's
    kMaxWarps warps of 32 cells a lane."""
    poa = (CSRC / "poa.cu").read_text()
    covers = [int(c) * int(tl) * int(nw) for c, tl, nw in
              re.findall(r"\((\d+), (\d+), (\d+)\)", poa)]
    assert max(covers) == poa_cuda.POA_MAX_COVER
    for kernel, table in poa_cuda.TEAM_SHAPES.items():
        assert max(table) == poa_cuda.POA_MAX_COVER, kernel
    p5 = (CSRC / "pairhmm5.cu").read_text()
    warps5 = int(_constant(p5, "kMaxWarps"))
    assert _constant(p5, "kMaxCells") == "32 * kMaxWarps * 64"
    assert 32 * warps5 * 64 == pairhmm5_cuda.PAIRHMM5_MAX_CELLS
    p3 = (CSRC / "pairhmm.cu").read_text()
    assert (32 * int(_constant(p3, "kMaxWarps")) * 32
            == pairhmm_cuda.PAIRHMM_MAX_NARROW_BAND)
    # the largest cells a lane the narrow 3-state launch takes
    assert "if (32 * kMaxWarps * c < B) c = 32;" in p3


def test_pairhmm5_cluster_constants_cover_the_wide_route():
    """csrc/pairhmm5.cu's cluster kernels: 16 CTAs of up to 1024 threads
    of 8 cells a lane hold twice the narrow kernels' widest row in shared
    memory, within the 227 KB a CTA may take (five state rows forward),
    and past that cover every width takes the global-scratch instance,
    with no cap in the source, its size stated once."""
    p5 = (CSRC / "pairhmm5.cu").read_text()
    ctas = int(_constant(p5, "kClusterMax"))
    threads = int(_constant(p5, "kClusterThreads"))
    cells = int(_constant(p5, "kClusterCells"))
    assert (ctas, threads, cells) == (16, 1024, 8)
    assert ctas * threads * cells == 2 * pairhmm5_cuda.PAIRHMM5_MAX_CELLS
    n = threads * cells
    assert 5 * (n + n // 32 + 1) * 4 <= 227 * 1024 - 16 * 1024
    launch = p5[p5.index("int pairhmm5_fwd_wide_launch"):]
    assert "kMaxCells" not in launch[:launch.index("int pairhmm5_bwd")]
    # one source sizes the global scratch: the kernels' pair offsets and
    # pairhmm5_cluster_shape's words (which the wrapper allocates) take
    # the same row counts
    for rows in ("kClusterFwdRows", "kClusterBwdRows"):
        assert p5.count(f"(size_t)p * {rows} * RW") == 1
        assert f"= {rows} * words;" in p5


def test_pairhmm_cluster_constants_cover_the_wide_route():
    """csrc/pairhmm.cu's cluster kernels: up to 16 CTAs of 8 cells a lane;
    with the state rows in shared memory up to 21 warps a CTA, whose ten
    rows (forward the step's eight M rows, X and Y; backward its eight
    fM x bM rows, bM and bX) fit the 227 KB a CTA may take
    beside its static exchange and 22 warps' would not; past that cover
    (86,016 cells) the global-scratch instance of 1024 threads, with no
    cap in the launch; one source sizes the global scratch; the tile
    kernels are gone, and the cluster launcher lives in csrc/cluster.cuh,
    which both pair-HMM sources include."""
    p3 = (CSRC / "pairhmm.cu").read_text()
    ctas = int(_constant(p3, "kClusterMax"))
    cells = int(_constant(p3, "kClusterCells"))
    warps = int(_constant(p3, "kClusterSmemWarps"))
    threads = int(_constant(p3, "kClusterThreads"))
    assert (ctas, cells, warps, threads) == (16, 8, 21, 1024)
    # CTAs of up to 8 warps take a 256-thread instance (registers enough
    # for a lane's cells)
    assert int(_constant(p3, "kClusterSmallThreads")) == 8 * 32
    assert _constant(p3, "kClusterFwdSmemRows") == "kStepRows + 2"
    assert _constant(p3, "kClusterBwdSmemRows") == "kStepRows + 2"

    def smem(w):
        n = 32 * w * cells
        return 10 * (n + n // 32 + 1) * 4

    static = 3908     # struct ClusterSmem's bytes
    assert smem(warps) + static <= 227 * 1024 < smem(warps + 1) + static
    assert ctas * warps * 32 * cells == 86016
    launch = p3[p3.index("int pairhmm_fwd_wide_launch"):]
    assert "kMaxWarps" not in launch[:launch.index("int pairhmm_bwd")]
    for rows in ("kClusterFwdRows", "kClusterBwdRows"):
        assert p3.count(f"(size_t)p * {rows} * RW") == 1
        assert f"= {rows} * words;" in p3
    for gone in ("pairhmm_fwd_wide_kernel", "pairhmm_bwd_wide_kernel",
                 "wide_cover", "pairhmm_wide_scratch_floats"):
        assert gone not in p3
    p5 = (CSRC / "pairhmm5.cu").read_text()
    header = (CSRC / "cluster.cuh").read_text()
    for fn in ("cudaError_t cluster_fits(", "cudaError_t launch_cluster(",
               "cudaError_t allow_smem("):
        assert header.count(fn) == 1
        assert fn not in p3 and fn not in p5
    for src in (p3, p5):
        assert '#include "cluster.cuh"' in src


def test_pairhmm_wrappers_check_max_live_on_the_cpu():
    """pairhmm_fwd, pairhmm_bwd and posterior_banded_batch take max_live
    at or above every pair's live width min(band, n + 1) (the same
    outputs as without it) and raise below it or below 1, on the CPU as
    on the card."""
    rng = np.random.default_rng(64)
    band = 64
    pairs = []
    for m in (10, 30, 45):
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, _mutate(rng, q)))
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    p = tp.HmmParams()
    em = torch.from_numpy(p.emissions())
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    widest = max(min(band, len(t) + 1) for _q, t in pairs)
    ref = pairhmm_cuda.pairhmm_fwd(*targs, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(*ref, *targs, em, **kw)
    for ok in (widest, band, band + 9, None):
        got = pairhmm_cuda.pairhmm_fwd(*targs, em, **kw, max_live=ok)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert torch.equal(pairhmm_cuda.pairhmm_bwd(*ref, *targs, em, **kw,
                                                    max_live=ok), post)
    for bad in (widest - 1, 0):
        with pytest.raises(ValueError, match="max_live"):
            pairhmm_cuda.pairhmm_fwd(*targs, em, **kw, max_live=bad)
        with pytest.raises(ValueError, match="max_live"):
            pairhmm_cuda.pairhmm_bwd(*ref, *targs, em, **kw, max_live=bad)
        with pytest.raises(ValueError, match="max_live"):
            tp.posterior_banded_batch(*targs, em, **kw, max_live=bad)


@pytest.mark.parametrize("band", [128, 16448])
def test_posterior_pairs_passes_the_host_max_live(monkeypatch, band):
    """posterior_pairs_banded gives each wide-route batch its widest live
    row max(min(band, n + 1)) from the host lengths (so the cluster is
    sized without reading n_len back from the card), and the narrow route
    none (its kernels take the band whole and the default path launches
    as before)."""
    rng = np.random.default_rng(band)
    pairs = []
    for m in (20, 40, 70, 100):
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, _mutate(rng, q)))
    seen = []
    real = tp.posterior_banded_batch

    def spy(*a, **kw):
        seen.append((int(a[3].max()), kw.get("max_live")))
        return real(*a, **kw)

    monkeypatch.setattr(tp, "posterior_banded_batch", spy)
    got = tp.posterior_pairs_banded(pairs, tp.HmmParams(), band=band,
                                    min_rows_bin=32, device="cpu")
    assert len(got) == len(pairs) and seen
    for n_max, live in seen:
        wide = pairhmm_cuda.pairhmm_route(band) == "wide"
        assert live == (min(band, n_max + 1) if wide else None)


def test_wrappers_take_every_width():
    """The argument checks the CUDA routes run before a launch accept
    widths past the caps (only argument errors remain)."""
    P, N, band = 1, 8, 32768
    preds = torch.full((P, N, MP), -1, dtype=torch.int32)
    off = torch.zeros((P, N), dtype=torch.int32)
    l_len = torch.tensor([20000], dtype=torch.int32)
    n_nodes, max_live = poa_cuda._live_args(preds, off, l_len, None, band,
                                            20001)
    assert max_live == 20001 and int(n_nodes[0]) == N
    with pytest.raises(ValueError, match="max_live"):
        poa_cuda._live_args(preds, off, l_len, None, band, band + 1)
    assert poa_cuda.team_cover(20001) == 32768
    q = torch.zeros((1, 8), dtype=torch.uint8)
    t = torch.zeros((1, 8 + band), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    em = torch.ones((6, 6), dtype=torch.float32)
    for check in (pairhmm_cuda._check_inputs, pairhmm5_cuda._check_inputs):
        check(q, t, one, one, one, em, band)
        with pytest.raises(ValueError, match="band"):
            check(q, t[:, :8], one, one, one, em, 0)
    assert banded_cuda.check_max_live(torch.tensor([70000]), 131072,
                                      70001) == 70001


def _wide_bin_chunks(monkeypatch, chain, max_launch_bytes):
    """The chunks (problems, max_live) align_bin runs a bin of three
    problems (8 nodes, a query of 20,000 bases, band 32768) in: chains,
    or the same with a second predecessor on nodes 4-7 (a DAG)."""
    rng = np.random.default_rng(3)
    P, N, band = 3, 8, 32768
    stack = dict(bases=rng.integers(0, 4, (P, N)).astype(np.uint8),
                 preds=np.full((P, N, MP), -1, np.int32),
                 off=np.zeros((P, N), np.int32),
                 q_ext=np.full((P, 20001), 5, np.uint8))
    stack["preds"][:, 1:, 0] = np.arange(N - 1)
    if not chain:
        stack["preds"][:, 4:, 1] = 1
    assert poa_cuda.chain_certified(stack["preds"], stack["off"]) == chain
    l_len = np.full(P, 20000, np.int32)
    chunks = []
    name = "poa_chain" if chain else "poa_affine"
    real = getattr(poa_cuda, name)

    def spy(*args, **kw):
        chunks.append((args[0].shape[0], kw["max_live"]))
        return real(*args, **kw)

    monkeypatch.setattr(poa_cuda, name, spy)
    poa_cuda.align_bin(stack, l_len, SUB, band, **GAPS, device="cpu",
                       max_launch_bytes=max_launch_bytes)
    return chunks


def test_align_bin_budgets_the_wide_route(monkeypatch):
    """align_bin counts the wide route's history rows on a DAG (H, F1, F2
    of the live cells: POA_WIDE_SCRATCH_BYTES_PER_CELL, 12 bytes a band
    cell) into its launch budget: a bin whose live row passes the widest
    cover runs in chunks that each fit."""
    per = 8 * 32768 * (poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL
                       + poa_cuda.POA_WIDE_SCRATCH_BYTES_PER_CELL)
    assert _wide_bin_chunks(monkeypatch, False, 2 * per) == [(2, 20001),
                                                            (1, 20001)]


def test_align_bin_budgets_the_wide_chain_route(monkeypatch):
    """The wide route's chain launches keep no history rows: align_bin
    budgets their outputs alone."""
    per = 8 * 32768 * poa_cuda.POA_AFFINE_OUT_BYTES_PER_CELL
    assert _wide_bin_chunks(monkeypatch, True, 2 * per) == [(2, 20001),
                                                           (1, 20001)]
    assert _wide_bin_chunks(monkeypatch, True, 3 * per) == [(3, 20001)]


# ------------------------------------------------- plain versions vs JAX

def _embedded(rng, m, n, at):
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = np.concatenate([rng.integers(0, 4, at).astype(np.uint8),
                        _mutate(rng, q),
                        rng.integers(0, 4, n).astype(np.uint8)])[:n]
    return q, t


@pytest.mark.parametrize("chain", [True, False])
def test_poa_affine_scan_past_the_cover_matches_jax(chain):
    """poa_align_scan_affine at band 32768 (12 nodes, queries of 16,400
    and 16,393 bases, rows of 16,401 live cells), bit-equal to the JAX
    package's XLA scan on every cell."""
    rng = np.random.default_rng(12 + chain)
    P, n, band = 2, 12, 32768
    bases = rng.integers(0, 4, (P, n)).astype(np.uint8)
    preds = np.full((P, n, MP), -1, np.int32)
    preds[:, 1:, 0] = np.arange(n - 1)
    if not chain:
        preds[:, 5, 1] = 2
        preds[:, 9, 1] = 11        # a forward predecessor
    q_ext = np.full((P, 16401), 5, np.uint8)
    l_len = np.array([16400, 16393], np.int32)
    for i in range(P):
        q_ext[i, 1:l_len[i] + 1] = rng.integers(0, 4, l_len[i])
    off = np.zeros((P, n), np.int32)
    assert poa_cuda.chain_certified(preds, off) == chain
    n_nodes = np.full(P, n, np.int32)
    assert poa_cuda.check_live(preds, off, l_len, n_nodes, band) == 16401
    tens = [torch.from_numpy(a) for a in (bases, preds, off, q_ext, l_len)]
    H, dirs, ends = tpoa.poa_align_scan_affine(*tens, torch.from_numpy(SUB),
                                               band=band, **GAPS)
    sm = jnp.asarray(SUB)
    run = jax.vmap(lambda b, pr, of, qe, ll: jpoa.poa_align_scan_affine(
        b, pr, of, qe, sm, band=band, l_len=ll, **GAPS))
    jH, jd, je = (np.asarray(x) for x in run(*(jnp.asarray(a) for a in (
        bases, preds, off, q_ext, l_len))))
    np.testing.assert_array_equal(jH, H.numpy())
    np.testing.assert_array_equal(jd.astype(np.int32),
                                  dirs.numpy().astype(np.int32))
    np.testing.assert_array_equal(je, ends.numpy())


def test_pairhmm_band_past_the_cap_matches_jax():
    """The 3-state plain versions at band 16448, past the narrow kernels'
    16384 (a 24-base query inside a 16,000-base target and a short
    homologous pair), within POST_ULPS of the JAX package's
    posterior_banded_batch."""
    rng = np.random.default_rng(32768)
    q = rng.integers(0, 4, 30).astype(np.uint8)
    pairs = [_embedded(rng, 24, 16000, 8000), (q, _mutate(rng, q))]
    band = 16448
    assert pairhmm_cuda.pairhmm_route(band) == "wide"
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    p = jp.HmmParams()
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    ref = np.asarray(jp.posterior_banded_batch(
        *[packed[k] for k in KEYS], p.emissions(), **kw))
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(tp.HmmParams().emissions())
    fM, lsF, logZ = tp.forward_banded(*targs, em, **kw)
    post = tp.backward_posterior(fM, lsF, logZ, *targs, em, **kw)
    assert post.shape == ref.shape
    diff = float(np.abs(post.numpy() - ref).max())
    assert diff <= POST_ULPS3 * log_scale_ulp(lsF, logZ, packed), diff
    # the long pair's posterior is diffuse (a global model spends 15,976
    # target bases on gaps); the short pair aligns inside the wide band
    assert float(post[1].max()) > 0.5


def test_pairhmm5_window_past_the_cap_matches_jax():
    """The 5-state plain versions at max_live 65,601, past the live-window
    kernels' 65,536 (a 24-base query inside a 65,600-base target, band
    65,608) beside a short pair, within POST_ULPS of the JAX package's
    posterior_banded_batch5 (the card tests take max_live 70,001)."""
    rng = np.random.default_rng(70001)
    q = rng.integers(0, 4, 20).astype(np.uint8)
    pairs = [_embedded(rng, 24, 65600, 30000), (q, _mutate(rng, q))]
    band = 65608
    packed = jb.pack_band_batch(pairs, band, min_batch=1)
    assert banded_cuda.live_width(packed["n_len"], band) == 65601
    assert pairhmm5_cuda.pairhmm5_route(65601) == "wide"
    jparams = j5.Hmm5Params(p_match=0.8)
    tparams = params_from_numpy(t5.Hmm5Params, dataclasses.asdict(jparams))
    ref = np.asarray(j5.posterior_banded_batch5(
        *[packed[k] for k in KEYS], jparams.emissions(), band=band,
        params=jparams))
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(tparams.emissions())
    fM, lsF, logZ = t5.forward_banded5(*targs, em, band=band, params=tparams)
    post = t5.backward_posterior5(fM, lsF, logZ, *targs, em, band=band,
                                  params=tparams)
    assert post.shape == ref.shape
    diff = float(np.abs(post.numpy() - ref).max())
    assert diff <= POST_ULPS5 * log_scale_ulp(lsF, logZ, packed), diff
    assert float(post[1].max()) > 0.5


# ------------------------------------------------ poa_linear live cells

def _dag(rng, n, forward=2):
    bases = rng.integers(0, 4, n).astype(np.uint8)
    preds = np.full((n, MP), -1, np.int32)
    for v in range(1, n):
        preds[v, 0] = v - 1
        if v > 3 and rng.random() < 0.3:
            preds[v, 1] = int(rng.integers(0, v - 1))
    for _ in range(forward):
        v = int(rng.integers(1, n - 2))
        preds[v, 2] = int(rng.integers(v + 1, n))
    return bases, preds


def test_linear_live_mask_definition():
    live = poa_cuda.linear_live_mask(6, 9, 4, 5).numpy()
    v, j = np.nonzero(live)
    assert live.shape == (6, 10)
    assert set(zip(v, j)) == {(a, b) for a in range(4) for b in range(6)}


@pytest.mark.parametrize("n,N,l_len,L", [(30, 32, 50, 64), (64, 64, 100, 100),
                                         (5, 64, 1, 64)])
def test_poa_linear_live_cells_match_jax(n, N, l_len, L):
    """The plain poa_linear on its live cells (the graph's n nodes in a
    bin of N, a query of l_len codes padded to L as poa_align pads it)
    equals the JAX package's poa_align_scan."""
    rng = np.random.default_rng(n + N + l_len)
    bases = np.zeros(N, np.uint8)
    preds = np.full((N, MP), -1, np.int32)
    bases[:n], preds[:n] = _dag(rng, n, forward=2 if n > 4 else 0)
    q = np.full(L, 5, np.uint8)
    q[:l_len] = rng.integers(0, 4, l_len)
    kw = dict(gap=30, match=10, mismatch=-15)
    jout = jpoa.poa_align_scan(jnp.asarray(bases), jnp.asarray(preds),
                               jnp.asarray(q), **kw)
    tens = [torch.from_numpy(a) for a in (bases, preds, q)]
    tout = poa_cuda.poa_linear(*tens, **kw, n_nodes=n, l_len=l_len)
    live = poa_cuda.linear_live_mask(N, L, n, l_len).numpy()
    for a, b in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(np.asarray(a)[live], b.numpy()[live])
    if l_len == L:
        np.testing.assert_array_equal(np.asarray(jout[2])[:n],
                                      tout[2].numpy()[:n])


def test_poa_align_reads_only_live_cells(monkeypatch):
    """poa_align passes the graph's nodes and the query's length as
    n_nodes and l_len: with every other cell of H and dirs random it
    builds the JAX package's alignment; with the first traceback cell
    changed, another one."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 4, 90).astype(np.uint8)
    t = np.concatenate([s[:20], s[31:70], rng.integers(0, 4, 5), s[70:]])
    jg, tg = jpoa.PoaGraph.from_sequence(s), tpoa.PoaGraph.from_sequence(s)
    plain = poa_cuda.poa_linear
    seen = []

    def poisoned(bases, preds, q, gap, match, mismatch, n_nodes=None,
                 l_len=None, flip=False):
        H, dirs, ends = plain(bases, preds, q, gap, match, mismatch)
        N, W = H.shape
        seen.append((n_nodes, l_len, N, W))
        live = poa_cuda.linear_live_mask(N, W - 1, n_nodes, l_len)
        g = torch.Generator().manual_seed(5)
        H = torch.where(live, H, torch.randint(-9, 9, H.shape, generator=g,
                                               dtype=torch.int32))
        dirs = torch.where(live, dirs, torch.randint(
            0, 16, dirs.shape, generator=g, dtype=torch.uint8))
        if flip:
            dirs = dirs.clone()
            dirs[n_nodes - 1, l_len] ^= 3
        return H, dirs, ends

    monkeypatch.setattr(poa_cuda, "poa_linear", poisoned)
    assert tpoa.poa_align(tg, t, device="cpu") == jpoa.poa_align(jg, t)
    assert seen == [(90, len(t), 128, 129)]
    monkeypatch.setattr(poa_cuda, "poa_linear",
                        lambda *a, **k: poisoned(*a, **k, flip=True))
    assert tpoa.poa_align(tg, t, device="cpu") != jpoa.poa_align(jg, t)
