"""Driver of ops/pairhmm.py::posterior_pairs_banded (the nested seedless
refinement's 3-state pair-HMM)."""

from __future__ import annotations

import torch

from ..reference import pairhmm as ref
from .hits import HmmDriver


class Driver(HmmDriver):
    kernels = {"pairhmm_fwd": ("pairhmm_fwd_kernel",
                               "pairhmm_fwd_cluster_kernel"),
               "pairhmm_bwd": ("pairhmm_bwd_kernel",
                               "pairhmm_bwd_cluster_kernel")}
    launch = ("cactus_tpu_torch.ops.pairhmm_cuda", "pairhmm_fwd")
    entry_span = "cactus.posterior_pairs_banded"
    spans = (("cactus_tpu_torch.ops.pairhmm", "pack_to_device"),
             ("cactus_tpu_torch.ops.pairhmm", "banded_hits"))

    def call(self, spec, pairs):
        from cactus_tpu_torch.ops.pairhmm import (HmmParams,
                                                  posterior_pairs_banded)
        return posterior_pairs_banded(pairs, HmmParams(**self.params(spec)),
                                      band=spec["band"], device=self.device,
                                      **self.entry_kw(spec))

    def reference(self, spec, pairs, control=False):
        p = self.params(spec)
        post, lo = ref.posterior(pairs, spec["band"], p["delta"],
                                 p["epsilon"], p["p_match"],
                                 dtype=torch.bfloat16 if control
                                 else torch.float64, device=self.device)
        return list(zip(post, lo))
