"""What the two pair-HMM drivers share: `HmmDriver` and the comparison
of hits.

An engine answer is, per pair, the hits (qpos, tpos, posterior): each
query row's first band argmax of the match posterior, kept where it
reaches gamma and lands inside the target.  The reference gives the
posterior of every band cell.  `hit_gap` is the widest error over the
rows of every sampled answer:

- a row the program hits at (i, j) with posterior p: the larger of
  |p - ref(i, j)| (the posterior it reports against the reference's at
  that cell) and best(i) - ref(i, j) (how far the reference's best cell
  of the row lies above the cell it chose; 0 on the same cell or a tie);
  1 where (i, j) is no cell of the row's band or i no row of the query;
- a row the reference hits and the program does not: best(i) - gamma,
  how far above the threshold the reference puts it.

A row on which rounding alone flips the threshold reads that rounding; a
row left out, moved or altered reads the posterior it lost or gained.
"""

from __future__ import annotations

import numpy as np

from .. import roofline


def row_errors(hits, post, lo: int, m: int, n: int, gamma: float):
    """Errors of one answer (hits of one pair) against the reference's
    posterior rows post (>= m, B) of that pair."""
    B = post.shape[1]
    rows = post[:m]
    best = rows.max(axis=1) if m else np.zeros(0)
    bestb = rows.argmax(axis=1) if m else np.zeros(0, np.int64)
    j1 = np.arange(1, m + 1) + lo + bestb
    ref_hit = (best >= gamma) & (j1 >= 1) & (j1 <= n)
    err = np.where(ref_hit, best - gamma, 0.0)
    seen = np.zeros(m, bool)
    for i, j, p in hits or ():
        i, j = int(i), int(j)
        if not 0 <= i < m or seen[i]:
            return 1.0
        seen[i] = True
        b = j - i - lo
        if not 0 <= b < B or not 0 <= j < n:
            err[i] = 1.0
            continue
        at = float(rows[i, b])
        err[i] = max(abs(float(p) - at), float(best[i]) - at)
    return float(err.max()) if m else 0.0


def hits_of(post, lo, pairs, gamma: float):
    """Hits in the engine's form from reference posteriors: each query
    row's first band argmax, kept where it reaches gamma and lands inside
    the target (the control's answers)."""
    out = []
    for rows, lo_p, (q, t) in zip(post, lo, pairs):
        m = len(q)
        best_b = rows[:m].argmax(axis=1)
        pr = rows[:m].max(axis=1)
        j = np.arange(1, m + 1) + int(lo_p) + best_b
        keep = np.flatnonzero((pr >= gamma) & (j >= 1) & (j <= len(t)))
        out.append([(int(i), int(j[i] - 1), float(pr[i])) for i in keep])
    return out


def compare(items) -> dict:
    """items: (spec, pair, answers of every pass, (post, lo) reference)."""
    gap = 0.0
    for spec, (q, t), got, (post, lo) in items:
        gamma = float(spec["kw"]["gamma"])
        for hits in got:
            gap = max(gap, row_errors(hits, post, int(lo), len(q), len(t),
                                      gamma))
    return {"hit_gap": gap}


class HmmDriver:
    """A pair-HMM entry's driver but for the entry itself (`call`), its
    reference (`reference`) and their names, which a subclass gives."""
    checks = ("hit_gap",)

    def __init__(self, config: dict, workload: dict, device):
        self.device = device
        self._work = {}

    @staticmethod
    def params(spec):
        return dict(spec["kw"]["params"])

    @staticmethod
    def entry_kw(spec):
        return {k: v for k, v in spec["kw"].items() if k != "params"}

    def control(self, spec, pairs):
        """The control's answers: the reference in bfloat16, as hits."""
        post_lo = self.reference(spec, pairs, control=True)
        return hits_of([p for p, _lo in post_lo], [lo for _p, lo in post_lo],
                       pairs, float(spec["kw"]["gamma"]))

    def compare(self, items):
        return compare(items)

    def _shape_work(self, c, spec):
        if c not in self._work:
            lens = np.asarray(spec["pairs"], np.int64).reshape(-1, 2)
            m, n = lens[:, 0], lens[:, 1]
            self._work[c] = (
                {k: roofline.pairhmm_work(k, m, n, spec["band"]) + ("fp32",)
                 for k in self.kernels},
                int(roofline.live_cells(m, n, spec["band"]).sum()))
        return self._work[c]

    def work(self, c, spec, answers):
        return self._shape_work(c, spec)[0]

    def live_cells(self, c, spec):
        return self._shape_work(c, spec)[1]
