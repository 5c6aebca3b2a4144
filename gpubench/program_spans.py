"""The program's own spans in a traced window, per engine call.

The port opens a span (cactus_tpu_torch/trace.py, a torch.profiler
range) around each engine entry, which the window's driver names
(`entry_span`: "cactus.align_pairs_banded" for the banded driver), and,
once per batch inside it,
`cactus.pack` (packing and the copy to the card), `cactus.fetch` (the
copies of results back, which wait for the kernels) and `cactus.unpack`
(the host loop that turns the arrays into answers).  A reading sums, for
each of the window's "gpubench.call" spans, the named spans whose start
and end lie inside it, and takes the mean over the calls, in ms.

A program without these spans (one older than them, or an entry the
program opens no span around: a driver's `entry_span` of None) reads
None: the window then holds no entry span at all.  A call with an entry
but no stage span reads 0.
"""

from __future__ import annotations

import bisect

from .tracing import covered, merge

STAGES = ("cactus.pack", "cactus.fetch", "cactus.unpack")


def _by_name(ctx):
    """{name: [(start, end)] sorted} of the driver's entry span and the
    stage spans of the traced window's host events, kept on ctx for the
    other readers."""
    found = getattr(ctx, "program_spans", None)
    if found is None:
        names = {ctx.driver.entry_span, *STAGES}
        found = {}
        for name, s, e in ctx.trace.host:
            if name in names:
                found.setdefault(name, []).append((s, e))
        for spans in found.values():
            spans.sort()
        ctx.program_spans = found
    return found


def _inside(spans, lo: float, hi: float):
    """The (start, end) of sorted spans that lie inside [lo, hi]."""
    k = bisect.bisect_left(spans, (lo, lo))
    out = []
    while k < len(spans) and spans[k][0] <= hi:
        if spans[k][1] <= hi:
            out.append(spans[k])
        k += 1
    return out


def has_entries(found, entry) -> bool:
    return bool(entry and found.get(entry))


def stage_ms_per_call(ctx, stage: str):
    """The mean over the window's calls of the summed `stage` spans inside
    each, in ms (None without entry spans)."""
    found = _by_name(ctx)
    if not has_entries(found, ctx.driver.entry_span):
        return None
    calls = ctx.trace.calls()
    spans = found.get(stage, [])
    total = sum(e - s for lo, hi in calls for s, e in _inside(spans, lo, hi))
    return total / len(calls) / 1e3


def entry_self_ms_per_call(ctx):
    """The mean over the window's calls of each entry span inside the
    call less the part of it its stage spans cover (their union), in ms
    (None without entry spans)."""
    entry = ctx.driver.entry_span
    found = _by_name(ctx)
    if not has_entries(found, entry):
        return None
    stages = sorted(x for name in STAGES for x in found.get(name, []))
    calls = ctx.trace.calls()
    total = 0.0
    for lo, hi in calls:
        for s, e in _inside(found[entry], lo, hi):
            total += (e - s) - covered(merge(_inside(stages, s, e)), s, e)
    return total / len(calls) / 1e3
