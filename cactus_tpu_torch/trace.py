"""Named spans of the program's stages, on torch.profiler's clock.

`span(name)` times the block it wraps with `time.perf_counter()`
(`.seconds` after exit).  While a torch.profiler is recording on this
thread it also opens `torch.profiler.record_function(name)`, a range on
the profiler's one timeline beside the card's kernels and copies, so a
trace can put each wait of the card down to a stage of the program.
With no profiler recording it opens no range.

The spans: the engine entries `cactus.align_pairs_banded`,
`cactus.posterior_pairs_banded` and `cactus.posterior_pairs_banded5`,
and inside them, once per batch, `cactus.pack` (packing and the copy to
the device), `cactus.fetch` (the copies of results back to the host,
which wait for the kernels) and `cactus.unpack` (turning the arrays into
answers); the phases of an ancestor step, `cactus.blast`, `cactus.caf`,
`cactus.bar` and `cactus.reference`.
"""

from __future__ import annotations

import time

import torch

_clock = time.perf_counter
_recording = torch.autograd._profiler_enabled


class span:
    """Context manager: the named stage's wall time, and its profiler
    range while a profiler records."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _recording():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
