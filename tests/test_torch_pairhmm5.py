"""The PyTorch port's 5-state pair-HMM against the JAX package (CPU).

The port's plain forward_banded5/backward_posterior5 evaluate the same
float32 operations in the same order as cactus_tpu's XLA path (the matrix
Kogge-Stone of the in-row chains included), but XLA's CPU code generator
fuses multiply-adds and brings its own log and exp, each of which rounds
some values one ulp away from ATen's, and the posterior is
fM*bM*exp(lsF + lsB - logZ), a function of running float32 sums of
per-row log-scales.  So, as for the 3-state model, the posteriors agree
to POST_ULPS ulps of the largest log-scale sum: over 48 seeded batches of
this file's inputs (ragged pairs under 300 or under 40 bp, an unrelated
pair and a 30 bp deletion) at bands 128 and 256 the gap was at most 3.00
ulps, 1.2e-4 at most (section 5 of `JAX_PLATFORMS=cpu python
tests/pairhmm_gap_report.py` prints these readings; the five-state
recurrence offers XLA more multiply-adds to fuse than the 3-state one,
whose gap stays under 2.31 ulps).  The Pallas kernel (interpret mode)
rescales every 8 rows, so it is held at the JAX package's own 2e-3; the
float64 full-matrix oracle at 1e-4 on short pairs.  The hit lists derived
from the posteriors are identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cactus_tpu.ops import banded as jb
from cactus_tpu.ops import pairhmm as jp
from cactus_tpu.ops import pairhmm5 as j5
from cactus_tpu.ops.pairhmm5_pallas import posterior_banded_batch5_pallas
from cactus_tpu_torch.config import params_from_numpy
from cactus_tpu_torch.ops import pairhmm as tp
from cactus_tpu_torch.ops import pairhmm5 as t5
from cactus_tpu_torch.ops import pairhmm5_cuda
from test_torch_pairhmm import KEYS, _mutate, log_scale_ulp

POST_ULPS = 4
DEGEN_ULPS = 8


def _pairs(seed, n, max_len):
    """Ragged homologous pairs, an unrelated pair and a 30 bp deletion."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        m = int(rng.integers(1, max_len))
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, _mutate(rng, q)))
    pairs.append((rng.integers(0, 4, 90).astype(np.uint8),
                  rng.integers(0, 4, 97).astype(np.uint8)))
    q = rng.integers(0, 4, 160).astype(np.uint8)
    pairs.append((q, np.concatenate([q[:70], q[100:]])))
    return pairs


def _params(p_match=0.94):
    """The same parameters in both packages, carried across by asdict."""
    jparams = j5.Hmm5Params(p_match=p_match)
    return jparams, params_from_numpy(t5.Hmm5Params,
                                      dataclasses.asdict(jparams))


def _port(packed, band, params):
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(params.emissions())
    fM, lsF, logZ = t5.forward_banded5(*targs, em, band=band, params=params)
    post = t5.backward_posterior5(fM, lsF, logZ, *targs, em, band=band,
                                  params=params)
    return post, lsF, logZ


@pytest.mark.parametrize("band,p_match", [(128, 0.94), (256, 0.94),
                                          (256, 0.7)])
def test_posteriors_match_jax_xla(band, p_match):
    pairs = _pairs(band + int(p_match * 100), 7, 300)
    packed = jb.pack_band_batch(pairs, band)
    jparams, tparams = _params(p_match)
    assert tparams == t5.Hmm5Params(p_match=p_match)
    ref = np.asarray(j5.posterior_banded_batch5(
        *[packed[k] for k in KEYS], jparams.emissions(), band=band,
        params=jparams))
    post, lsF, logZ = _port(packed, band, tparams)
    assert post.dtype == torch.float32 and post.shape == ref.shape
    diff = float(np.abs(post.numpy() - ref).max())
    assert diff <= POST_ULPS * log_scale_ulp(lsF, logZ, packed), diff
    # the wrappers hand CPU tensors to the plain versions
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    em = torch.from_numpy(tparams.emissions())
    got = t5.posterior_banded_batch5(*targs, em, band=band, params=tparams)
    np.testing.assert_array_equal(got.numpy(), post.numpy())
    fM, lsF2, _ = pairhmm5_cuda.pairhmm5_fwd(*targs, em, band=band,
                                             params=tparams)
    assert fM.shape == ref.shape and lsF2.shape == ref.shape[:2]


@pytest.mark.parametrize("band", [128, 256])
def test_posteriors_match_pallas_interpret(band):
    pairs = _pairs(band + 3, 2, 150)
    packed = jb.pack_band_batch(pairs, band)
    jparams, tparams = _params()
    ref = np.asarray(posterior_banded_batch5_pallas(
        *[jnp.asarray(packed[k]) for k in KEYS],
        jnp.asarray(jparams.emissions()), band=band, params=jparams,
        interpret=True))
    post, _lsF, _logZ = _port(packed, band, tparams)
    np.testing.assert_allclose(post.numpy(), ref, atol=2e-3)
    # the deletion pair keeps confident matches on both sides of the gap
    row_best = post.numpy()[len(pairs) - 1, :160].max(axis=1)
    assert np.median(row_best[:60]) > 0.7
    assert np.median(row_best[110:]) > 0.7


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_matches_full_oracle(seed):
    rng = np.random.default_rng(seed)
    p = t5.Hmm5Params()
    band = 64
    for _trial in range(2):
        m = int(rng.integers(20, 60))
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = _mutate(rng, q, sub=0.08, indel=0.02)
        full = t5.posterior5_np(q, t, p)
        np.testing.assert_array_equal(full, j5.posterior5_np(q, t, p))
        packed = jb.pack_band_batch([(q, t)], band)
        post = _port(packed, band, p)[0].numpy()[0, :m]
        lo = int(packed["lo"][0])
        i = np.arange(1, m + 1)[:, None]
        j = i + lo + np.arange(band)[None, :]
        inside = (j >= 1) & (j <= len(t))
        ref = full[np.nonzero(inside)[0], (j - 1)[inside]]
        np.testing.assert_allclose(post[inside], ref, atol=1e-4)


@pytest.mark.parametrize("band,gamma", [(128, 0.5), (256, 0.2)])
def test_hit_lists_identical(band, gamma):
    pairs = _pairs(11 + band, 9, 400)
    jparams, tparams = _params(0.8)
    ref = j5.posterior_pairs_banded5(pairs, jparams, band=band, gamma=gamma)
    got = t5.posterior_pairs_banded5(pairs, tparams, band=band, gamma=gamma,
                                     device="cpu")
    assert [[(i, j) for i, j, _p in h] for h in ref] == \
        [[(i, j) for i, j, _p in h] for h in got]
    for hr, hg in zip(ref, got):
        for (_i, _j, pr), (_i2, _j2, pg) in zip(hr, hg):
            assert abs(pr - pg) <= 1e-3
    assert sum(len(h) for h in ref) > 500
    # a byte cap of one pair per dispatch gives the same hits
    one = t5.posterior_pairs_banded5(pairs, tparams, band=band, gamma=gamma,
                                     device="cpu", max_batch_bytes=1)
    assert one == got


@pytest.mark.parametrize("seed", [2, 5])
def test_degenerate_equals_three_state_port(seed):
    """With long-gap opens and switches at ~0 the 5-state machine
    collapses onto the 3-state machine of ops/pairhmm.py: exactly in the
    float64 oracles (as tests/test_pairhmm5.py holds them), and to
    DEGEN_ULPS in the banded float32 passes, which evaluate different
    expressions (two more gap states, other sums) for the same values:
    over seeds 0-7 the gap was at most 3.94 ulps (section 6 of
    tests/pairhmm_gap_report.py)."""
    band = 128
    p3 = tp.HmmParams()
    p5 = t5.Hmm5Params(match_continue=1.0 - 2.0 * p3.delta,
                       open_short=p3.delta, open_long=1e-12,
                       extend_short=p3.epsilon, extend_long=1e-12,
                       switch_sl=0.0, switch_ls=0.0, p_match=p3.p_match)
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, 30).astype(np.uint8)
    t = _mutate(rng, q, sub=0.08, indel=0.02)
    np.testing.assert_allclose(t5.posterior5_np(q, t, p5),
                               jp.posterior_np(q, t, jp.HmmParams()),
                               atol=1e-6)
    pairs = _pairs(seed, 5, 120)
    packed = jb.pack_band_batch(pairs, band)
    post5, lsF, logZ = _port(packed, band, p5)
    targs = [torch.from_numpy(packed[k]) for k in KEYS]
    post3 = tp.posterior_banded_batch(*targs,
                                      torch.from_numpy(p3.emissions()),
                                      band=band, delta=p3.delta,
                                      epsilon=p3.epsilon)
    diff = float((post5 - post3).abs().max())
    assert diff <= DEGEN_ULPS * log_scale_ulp(lsF, logZ, packed), diff
    assert float(post3.max()) > 0.9


def test_long_gap_state_bridges_a_deletion():
    """A 60 bp deletion: the 5-state port keeps the far flank confident,
    the 3-state one does no better."""
    rng = np.random.default_rng(3)
    left, mid, right = (rng.integers(0, 4, n).astype(np.uint8)
                        for n in (50, 60, 50))
    q = np.concatenate([left, right])
    t = np.concatenate([left, mid, right])
    h5 = t5.posterior_pairs_banded5([(q, t)], t5.Hmm5Params(), band=256,
                                    gamma=0.5, device="cpu")[0]
    h3 = tp.posterior_pairs_banded([(q, t)], tp.HmmParams(), band=256,
                                   gamma=0.5, device="cpu")[0]
    far5 = {(i, j) for i, j, _p in h5 if i >= 50}
    far3 = {(i, j) for i, j, _p in h3 if i >= 50}
    assert sum((50 + k, 110 + k) in far5 for k in range(40)) > 32
    assert len(far5) >= len(far3)
