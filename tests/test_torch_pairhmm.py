"""The PyTorch port's 3-state pair-HMM against the JAX package (CPU).

Both packages evaluate the same float32 operations in the same order, but
XLA's CPU code generator fuses multiply-adds (tMM*fM + (1-e)*(fX+fY) is
one FMA) and brings its own pow, log and exp, each of which rounds some
values one ulp away from ATen's.  The posterior is
fM*bM*exp(lsF + lsB - logZ), a function of running float32 sums of
per-row log-scales, and any one-ulp change in a summand can flip the
rounding of those sums.  So the posteriors agree to POST_ULPS ulps of the
largest log-scale sum, not to a fixed absolute bound: at the ~600 these
300 bp inputs reach, one ulp is 6.1e-5 (measured gap: 3.1e-5 at band 128
and 6.1e-5 at band 256), and over 48 seeded batches the gap was at most
2.31 ulps (tests/pairhmm_gap_report.py prints these readings).  The hit
lists derived from the posteriors, and the nested phase's seedless runs,
are identical.
"""

import numpy as np
import pytest
import torch

from cactus_tpu.io.fasta import revcomp
from cactus_tpu.ops import banded as jb
from cactus_tpu.ops import pairhmm as jp
from cactus_tpu.phases import nested as jn
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm_cuda
from cactus_tpu_torch.phases import nested as tn

POST_ULPS = 3
KEYS = ("q", "t_shift", "m_len", "n_len", "lo")


def log_scale_ulp(lsF, logZ, packed) -> float:
    """One float32 ulp of the largest log-scale sum of a batch: the running
    sums lsF over the rows each pair uses, and the totals logZ."""
    lsF, logZ = np.asarray(lsF), np.asarray(logZ)
    used = np.arange(1, lsF.shape[1] + 1)[None, :] <= \
        packed["m_len"][:, None]
    mag = max(float(np.abs(lsF[used]).max(initial=0.0)),
              float(np.abs(logZ).max()))
    return float(np.spacing(np.float32(mag)))


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


def _pairs(seed, n, max_len):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        m = int(rng.integers(1, max_len))
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, _mutate(rng, q)))
    pairs.append((rng.integers(0, 4, 90).astype(np.uint8),
                  rng.integers(0, 4, 97).astype(np.uint8)))
    return pairs


@pytest.mark.parametrize("band", [128, 256])
def test_posteriors_match_jax(band):
    pairs = _pairs(band, 7, 300)
    packed = jb.pack_band_batch(pairs, band)
    p = jp.HmmParams()
    kw = dict(band=band, delta=p.delta, epsilon=p.epsilon)
    ref = np.asarray(jp.posterior_banded_batch(
        *[packed[k] for k in KEYS], p.emissions(), **kw))
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(tp.HmmParams().emissions())
    got = tp.posterior_banded_batch(*targs, em, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # the two halves behind the wrappers, called on CPU tensors
    fM, lsF, logZ = pairhmm_cuda.pairhmm_fwd(*targs, em, **kw)
    post = pairhmm_cuda.pairhmm_bwd(fM, lsF, logZ, *targs, em, **kw)
    diff = float(np.abs(got.numpy() - ref).max())
    assert diff <= POST_ULPS * log_scale_ulp(lsF, logZ, packed), diff
    np.testing.assert_array_equal(post.numpy(), got.numpy())
    assert fM.shape == ref.shape and lsF.shape == ref.shape[:2]


def test_forward_float64_runs_the_same_steps():
    """dtype=torch.float64, the reference tests/pairhmm_float64_report.py
    reads the float32 forward values against, returns float64 and agrees
    with the float32 run where float32 holds the values: logZ, and the
    forward values of the cells within 1e-6 of their row's maximum."""
    pairs = _pairs(3, 7, 300)
    packed = jb.pack_band_batch(pairs, 128)
    p = tp.HmmParams()
    kw = dict(band=128, delta=p.delta, epsilon=p.epsilon)
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(p.emissions())
    f32 = tp.forward_banded(*targs, em, **kw)
    f64 = tp.forward_banded(*targs, em, **kw, dtype=torch.float64)
    assert all(x.dtype == torch.float64 for x in f64)
    assert all(x.shape == y.shape for x, y in zip(f32, f64))
    torch.testing.assert_close(f64[2], f32[2].double(), rtol=1e-5, atol=0)
    big = f32[0] > 1e-6
    gap = ((torch.log(f32[0].double()) + f32[1].double()[..., None])
           - (torch.log(f64[0]) + f64[1][..., None]))[big].abs().max()
    assert float(gap) < 1e-3, float(gap)


@pytest.mark.parametrize("band,gamma", [(128, 0.5), (256, 0.9)])
def test_hit_lists_identical(band, gamma):
    pairs = _pairs(7 + band, 9, 400)
    ref = jp.posterior_pairs_banded(pairs, jp.HmmParams(), band=band,
                                    gamma=gamma)
    got = tp.posterior_pairs_banded(pairs, tp.HmmParams(), band=band,
                                    gamma=gamma, device="cpu")
    packed = jb.pack_band_batch(pairs, band)
    p = tp.HmmParams()
    _fM, lsF, logZ = tp.forward_banded(
        *[torch.from_numpy(packed[k]) for k in KEYS],
        torch.from_numpy(p.emissions()), band=band, delta=p.delta,
        epsilon=p.epsilon)
    tol = POST_ULPS * log_scale_ulp(lsF, logZ, packed)
    assert [[(i, j) for i, j, _p in h] for h in ref] == \
        [[(i, j) for i, j, _p in h] for h in got]
    for hr, hg in zip(ref, got):
        for (_i, _j, pr), (_i2, _j2, pg) in zip(hr, hg):
            assert abs(pr - pg) <= tol
    assert sum(len(h) for h in ref) > 500
    # a byte cap of one pair per dispatch gives the same hits
    one = tp.posterior_pairs_banded(pairs, tp.HmmParams(), band=band,
                                    gamma=gamma, device="cpu",
                                    max_batch_bytes=1)
    assert [[(i, j) for i, j, _p in h] for h in one] == \
        [[(i, j) for i, j, _p in h] for h in got]


def _seedless_jobs():
    """Interval pairs as the nested phase hands them to the pair-HMM: a
    diverged forward pair, an inverted one, an unrelated one, and slivers
    under the 200 bp floor that are skipped."""
    rng = np.random.default_rng(11)
    jobs = []
    a = rng.integers(0, 4, 420).astype(np.uint8)
    jobs.append((a, _mutate(rng, a, sub=0.12, indel=0.03), 1000, 5000))
    b = rng.integers(0, 4, 360).astype(np.uint8)
    jobs.append((b, revcomp(_mutate(rng, b, sub=0.1, indel=0.02)), 2000,
                 6000))
    jobs.append((rng.integers(0, 4, 300).astype(np.uint8),
                 rng.integers(0, 4, 310).astype(np.uint8), 3000, 7000))
    c = rng.integers(0, 4, 150).astype(np.uint8)
    jobs.append((c, c.copy(), 4000, 8000))
    return jobs


def test_nested_seedless_runs_identical():
    jobs = _seedless_jobs()
    ref = jn._seedless_runs_batch(jobs)
    got = tn._seedless_runs_batch(jobs, device="cpu")
    assert got == ref
    strands = {r[3] for r in ref}
    assert strands == {1, -1}, ref
    assert sum(r[2] for r in ref) > 300


def test_hmm_params_and_bins_are_the_reference_ones():
    np.testing.assert_array_equal(jp.HmmParams(p_match=0.8).emissions(),
                                  tp.HmmParams(p_match=0.8).emissions())
    pairs = _pairs(3, 12, 3000)
    assert jp.length_bins(pairs) == tp.length_bins(pairs)
    assert tp.NESTED_MAX_BAND == jp.MAX_PALLAS_BAND == 2048
