"""Driver of ops/banded.py::align_pairs_banded (blast's gap fill, BAR)."""

from __future__ import annotations

import numpy as np

from .. import roofline
from ..reference import banded as ref


class Driver:
    kernels = {"banded_dp": ("banded_dp_warp_kernel", "banded_dp_kernel"),
               "banded_traceback": ("banded_traceback_kernel",)}
    launch = ("cactus_tpu_torch.ops.banded_cuda", "banded_dp")
    entry_span = "cactus.align_pairs_banded"
    spans = (("cactus_tpu_torch.ops.banded", "pack_band_batch"),
             ("cactus_tpu_torch.ops.banded", "_to_device"),
             ("cactus_tpu_torch.ops.banded", "moves_to_ops"))
    # exact integer answers: the workloads give both the limit 0
    checks = ("score_mismatches", "cigar_mismatches")

    def __init__(self, config: dict, workload: dict, device):
        sc = config["scoring"]
        self.submat = np.asarray(sc["submat"], np.int32)
        self.gap_open, self.gap_extend = sc["gap_open"], sc["gap_extend"]
        self.device = device
        self._work = {}

    def call(self, spec, pairs):
        from cactus_tpu_torch.ops.banded import GapParams, align_pairs_banded
        return align_pairs_banded(
            pairs, self.submat, GapParams(self.gap_open, self.gap_extend),
            band=spec["band"], device=self.device)

    def reference(self, spec, pairs, control=False):
        return ref.align(pairs, self.submat, spec["band"], self.gap_open,
                         self.gap_extend,
                         dtype=np.int16 if control else np.int32)

    def control(self, spec, pairs):
        """The control's answers: the reference in int16."""
        return self.reference(spec, pairs, control=True)

    def compare(self, items):
        """items: (spec, pair, answers of every pass, reference answer)."""
        score = cigar = 0
        for _spec, _pair, got, want in items:
            for g in got:
                score += int(g is None or int(g[0]) != want[0])
                cigar += int(g is None or [tuple(o) for o in g[1]]
                             != [tuple(o) for o in want[1]])
        return {"score_mismatches": score, "cigar_mismatches": cigar}

    def _shape_work(self, c, spec):
        if c not in self._work:
            lens = np.asarray(spec["pairs"], np.int64).reshape(-1, 2)
            self._work[c] = (roofline.banded_work(lens[:, 0], lens[:, 1],
                                                  spec["band"]),
                             int(roofline.live_cells(lens[:, 0], lens[:, 1],
                                                     spec["band"]).sum()))
        return self._work[c]

    def work(self, c, spec, answers):
        (ops, bytes_), _live = self._shape_work(c, spec)
        steps = sum(sum(k for _op, k in ops_) for score, ops_ in answers
                    if score != ref.NEG32)
        tb_ops, tb_bytes = roofline.traceback_work(steps, len(answers))
        return {"banded_dp": (ops, bytes_, "int32"),
                "banded_traceback": (tb_ops, tb_bytes, "int32")}

    def live_cells(self, c, spec):
        return self._shape_work(c, spec)[1]
