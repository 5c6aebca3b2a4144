"""host_ms_per_call: the mean over the traced window's engine calls of
the call's wall (the benchmark's "gpubench.call" span) less the time the
card was busy inside it (the union of the profiler's kernels, copies and
fills), in ms: the host work of the entry and its ops batching."""

from gpubench.tracing import covered


def read(ctx):
    spans = ctx.trace.calls()
    host = sum((e - s) - covered(ctx.union, s, e) for s, e in spans)
    return host / len(spans) / 1e3
