"""traced_call_p95_ms: call_p95_ms read from the traced window, in the
cells whose runs spread too widely for it to stand end to end: the 95th
percentile (nearest rank) of the traced window's call latencies, in ms,
the profiler's overhead in it."""

from gpubench import stats


def read(ctx):
    return stats.p95(ctx.latencies) * 1e3
