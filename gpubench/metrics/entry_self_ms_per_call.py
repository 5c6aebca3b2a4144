"""entry_self_ms_per_call: the mean over the traced window's engine calls
of the port's entry span (`cactus.align_pairs_banded`,
`cactus.posterior_pairs_banded` or `cactus.posterior_pairs_banded5`)
less the part of it that its `cactus.pack`, `cactus.fetch` and
`cactus.unpack` spans cover, in ms: the entry's own host work (binning,
chunking, launches, result bookkeeping; gpubench/program_spans.py).
None for a program without the spans."""

from gpubench.program_spans import entry_self_ms_per_call as read  # noqa: F401
