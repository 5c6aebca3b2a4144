"""The plain references against brute force at tiny sizes, and against
the port's plain versions (the tie-breaking of the banded DP)."""

import itertools

import gpubench_small  # noqa: F401
import numpy as np
import pytest
import torch

from gpubench import traffic
from gpubench.reference import banded as rb
from gpubench.reference import pairhmm as rp
from gpubench.reference import pairhmm5 as rp5

SUB = np.full((6, 6), -1000, np.int32)
SUB[:5, :5] = np.array(
    [91, -114, -61, -123, -100, -114, 100, -125, -61, -100, -61, -125, 100,
     -114, -100, -123, -61, -114, 91, -100, -100, -100, -100, -100,
     100]).reshape(5, 5)
NEG = -(1 << 40)


def random_pairs(seed, count, lo_len, hi_len):
    rng = traffic.rng_for(seed)
    out = []
    for _ in range(count):
        m = int(rng.integers(lo_len, hi_len + 1))
        n = int(rng.integers(lo_len, hi_len + 1))
        call = {"pairs": [[m, n]], "substitution_rate": 0.2,
                "gap_open_rate": 0.05, "gap_mean_length": 2.0}
        out += traffic.make_call(rng, call)
    return out


def gotoh(q, t, go, ge):
    """Best global affine score by the full 3-matrix DP (H: the match
    state; I consumes the query, D the target; no I <-> D step)."""
    m, n = len(q), len(t)
    H = np.full((m + 1, n + 1), NEG)
    I = np.full((m + 1, n + 1), NEG)
    D = np.full((m + 1, n + 1), NEG)
    H[0, 0] = 0
    for i in range(1, m + 1):
        I[i, 0] = -(go + i * ge)
    for j in range(1, n + 1):
        D[0, j] = -(go + j * ge)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            H[i, j] = max(H[i - 1, j - 1], I[i - 1, j - 1],
                          D[i - 1, j - 1]) + SUB[q[i - 1], t[j - 1]]
            I[i, j] = max(H[i - 1, j] - go, I[i - 1, j]) - ge
            D[i, j] = max(H[i, j - 1] - go, D[i, j - 1]) - ge
    return max(H[m, n], I[m, n], D[m, n])


def cigar_score(q, t, ops, go, ge):
    i = j = score = 0
    for op, k in ops:
        if op == "M":
            score += sum(int(SUB[q[i + x], t[j + x]]) for x in range(k))
            i += k
            j += k
        else:
            score -= go + k * ge
            i += k if op == "I" else 0
            j += k if op == "D" else 0
    assert (i, j) == (len(q), len(t))
    return score


def test_banded_reference_is_the_optimal_alignment():
    """Band wide enough for the whole matrix: the reference's score is the
    full DP's, and its CIGAR spells both sequences and scores that."""
    for q, t in random_pairs(1, 30, 1, 14):
        band = 2 * (len(q) + len(t)) + 2
        (score, ops), = rb.align([(q, t)], SUB, band, 400, 30)
        assert score == gotoh(q, t, 400, 30)
        assert cigar_score(q, t, ops, 400, 30) == score


@pytest.mark.parametrize("band", [16, 40, 128])
def test_banded_reference_breaks_ties_as_the_port(band):
    from cactus_tpu_torch.ops.banded import (GapParams, align_pairs_banded,
                                             banded_align_batch)
    pairs = [p for p in random_pairs(band, 40, 1, 160)
             if abs(len(p[0]) - len(p[1])) < band]
    ours = rb.align(pairs, SUB, band, 400, 30)
    port = align_pairs_banded(pairs, SUB, GapParams(400, 30), band=band,
                              device="cpu", backend=banded_align_batch)
    assert [(s, list(o)) for s, o in port] == [(s, list(o))
                                               for s, o in ours]


def test_banded_control_wraps_where_scores_pass_int16():
    q = np.zeros(500, np.uint8)             # 500 matches: 45,500 > 32,767
    ((s32, _), (s16, _)) = (rb.align([(q, q)], SUB, 128, 400, 30, dtype)[0]
                            for dtype in (np.int32, np.int16))
    assert s32 == 500 * 91 and s16 != s32


def full_posterior3(q, t, d, e, p_match):
    """fM * bM / Z of the 3-state model over the whole matrix (float64)."""
    em = rp.emissions(p_match, torch.float64, "cpu").numpy()
    m, n = len(q), len(t)
    tMM = 1 - 2 * d
    fM, fX, fY = (np.zeros((m + 1, n + 1)) for _ in range(3))
    fM[0, 0] = 1.0
    for i, j in itertools.product(range(m + 1), range(n + 1)):
        if i and j:
            fM[i, j] = em[q[i - 1], t[j - 1]] * (
                tMM * fM[i - 1, j - 1]
                + (1 - e) * (fX[i - 1, j - 1] + fY[i - 1, j - 1]))
        if i:
            fX[i, j] = d * fM[i - 1, j] + e * fX[i - 1, j]
        if j:
            fY[i, j] = d * fM[i, j - 1] + e * fY[i, j - 1]
    Z = fM[m, n] + fX[m, n] + fY[m, n]
    bM, bX, bY = (np.zeros((m + 1, n + 1)) for _ in range(3))
    for i in range(m, -1, -1):
        for j in range(n, -1, -1):
            if (i, j) == (m, n):
                bM[i, j] = bX[i, j] = bY[i, j] = 1.0
                continue
            mm = (em[q[i], t[j]] * bM[i + 1, j + 1]
                  if i < m and j < n else 0.0)
            x = bX[i + 1, j] if i < m else 0.0
            y = bY[i, j + 1] if j < n else 0.0
            bM[i, j] = tMM * mm + d * x + d * y
            bX[i, j] = (1 - e) * mm + e * x
            bY[i, j] = (1 - e) * mm + e * y
    return (fM * bM / Z)[1:, 1:]


def full_posterior5(q, t, p):
    """fM * bM / Z of the 5-state model over the whole matrix (float64)."""
    em = rp.emissions(p["p_match"], torch.float64, "cpu").numpy()
    mc, os_, ol, es, el, wsl, wls = (p[k] for k in rp5.TRANSITIONS)
    ms, ml = 1 - es - wsl, 1 - el - wls
    m, n = len(q), len(t)
    f = {k: np.zeros((m + 1, n + 1)) for k in ("M", "SX", "LX", "SY", "LY")}
    f["M"][0, 0] = 1.0
    for i, j in itertools.product(range(m + 1), range(n + 1)):
        if i and j:
            f["M"][i, j] = em[q[i - 1], t[j - 1]] * (
                mc * f["M"][i - 1, j - 1]
                + ms * (f["SX"][i - 1, j - 1] + f["SY"][i - 1, j - 1])
                + ml * (f["LX"][i - 1, j - 1] + f["LY"][i - 1, j - 1]))
        if i:
            f["SX"][i, j] = (os_ * f["M"][i - 1, j] + es * f["SX"][i - 1, j]
                             + wls * f["LX"][i - 1, j])
            f["LX"][i, j] = (ol * f["M"][i - 1, j] + el * f["LX"][i - 1, j]
                             + wsl * f["SX"][i - 1, j])
        if j:
            f["SY"][i, j] = (os_ * f["M"][i, j - 1] + es * f["SY"][i, j - 1]
                             + wls * f["LY"][i, j - 1])
            f["LY"][i, j] = (ol * f["M"][i, j - 1] + el * f["LY"][i, j - 1]
                             + wsl * f["SY"][i, j - 1])
    Z = sum(f[k][m, n] for k in f)
    b = {k: np.zeros((m + 1, n + 1)) for k in f}
    for i in range(m, -1, -1):
        for j in range(n, -1, -1):
            if (i, j) == (m, n):
                for k in b:
                    b[k][i, j] = 1.0
                continue
            mm = (em[q[i], t[j]] * b["M"][i + 1, j + 1]
                  if i < m and j < n else 0.0)
            sx = b["SX"][i + 1, j] if i < m else 0.0
            lx = b["LX"][i + 1, j] if i < m else 0.0
            sy = b["SY"][i, j + 1] if j < n else 0.0
            ly = b["LY"][i, j + 1] if j < n else 0.0
            b["M"][i, j] = mc * mm + os_ * (sx + sy) + ol * (lx + ly)
            b["SX"][i, j] = ms * mm + es * sx + wsl * lx
            b["LX"][i, j] = ml * mm + el * lx + wls * sx
            b["SY"][i, j] = ms * mm + es * sy + wsl * ly
            b["LY"][i, j] = ml * mm + el * ly + wls * sy
    return (f["M"] * b["M"] / Z)[1:, 1:]


def band_to_full(post, lo, m, n):
    out = np.zeros((m, n))
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            out[i - 1, j - 1] = post[i - 1, j - i - lo]
    return out


P5 = {"match_continue": 0.9703833696510062, "open_short": 0.0129868352330243,
      "open_long": 0.0018197996414636, "extend_short": 0.7126062401851738,
      "extend_long": 0.99656342579062, "switch_sl": 0.0007315179552849,
      "switch_ls": 0.0007315179552849, "p_match": 0.72}


@pytest.mark.parametrize("model", ["3-state", "5-state"])
def test_pairhmm_references_are_forward_backward(model):
    """Band wide enough for the whole matrix: every posterior is the full
    forward-backward's fM * bM / Z."""
    pairs = random_pairs(7, 6, 2, 12)
    band = 64
    if model == "3-state":
        post, lo = rp.posterior(pairs, band, 0.025, 0.79, 0.94)
    else:
        post, lo = rp5.posterior(pairs, band, P5)
    for p, (q, t) in enumerate(pairs):
        want = (full_posterior3(q, t, 0.025, 0.79, 0.94)
                if model == "3-state" else full_posterior5(q, t, P5))
        got = band_to_full(post[p], int(lo[p]), len(q), len(t))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("model", ["3-state", "5-state"])
def test_pairhmm_references_match_the_port_plain_versions(model):
    """Against the port's float32 plain versions at a band narrower than
    the pairs: the same band placement, masks and rescaling."""
    from cactus_tpu_torch.ops import pairhmm as tp
    from cactus_tpu_torch.ops import pairhmm5 as tp5
    from cactus_tpu_torch.ops.banded import pack_band_batch
    pairs = [p for p in random_pairs(11, 5, 40, 90)
             if abs(len(p[0]) - len(p[1])) < 24]
    band = 32
    pk = pack_band_batch(pairs, band, min_batch=1, min_rows=1)
    t = [torch.from_numpy(pk[k]) for k in ("q", "t_shift", "m_len",
                                           "n_len", "lo")]
    if model == "3-state":
        em = torch.from_numpy(tp.HmmParams().emissions())
        kw = dict(band=band, delta=0.025, epsilon=0.79)
        f = tp.forward_banded(*t, em, **kw)
        port = tp.backward_posterior(*f, *t, em, **kw).numpy()
        ours, lo = rp.posterior(pairs, band, 0.025, 0.79, 0.94)
    else:
        hp = tp5.Hmm5Params(**P5)
        em = torch.from_numpy(hp.emissions())
        f = tp5.forward_banded5(*t, em, band=band, params=hp)
        port = tp5.backward_posterior5(*f, *t, em, band=band,
                                       params=hp).numpy()
        ours, lo = rp5.posterior(pairs, band, P5)
    assert (lo == pk["lo"][:len(pairs)]).all()
    for p, (q, _t) in enumerate(pairs):
        np.testing.assert_allclose(ours[p, :len(q)], port[p, :len(q)],
                                   atol=1e-4)
