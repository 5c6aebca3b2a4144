"""Driver of ops/pairhmm5.py::posterior_pairs_banded5 (BAR pecan's 5-state
pair-HMM on its piece bins)."""

from __future__ import annotations

import torch

from ..reference import pairhmm5 as ref
from .hits import HmmDriver


class Driver(HmmDriver):
    kernels = {"pairhmm5_fwd": ("pairhmm5_fwd_kernel",
                                "pairhmm5_fwd_cluster_kernel"),
               "pairhmm5_bwd": ("pairhmm5_bwd_kernel",
                                "pairhmm5_bwd_cluster_kernel")}
    launch = ("cactus_tpu_torch.ops.pairhmm5_cuda", "pairhmm5_fwd")
    entry_span = "cactus.posterior_pairs_banded5"
    spans = (("cactus_tpu_torch.ops.pairhmm5", "pack_to_device"),
             ("cactus_tpu_torch.ops.pairhmm5", "banded_hits"))

    def call(self, spec, pairs):
        from cactus_tpu_torch.ops.pairhmm5 import (Hmm5Params,
                                                   posterior_pairs_banded5)
        return posterior_pairs_banded5(pairs,
                                       Hmm5Params(**self.params(spec)),
                                       band=spec["band"], device=self.device,
                                       **self.entry_kw(spec))

    def reference(self, spec, pairs, control=False):
        post, lo = ref.posterior(pairs, spec["band"], self.params(spec),
                                 dtype=torch.bfloat16 if control
                                 else torch.float64, device=self.device)
        return list(zip(post, lo))
