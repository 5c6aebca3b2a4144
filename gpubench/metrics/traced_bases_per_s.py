"""traced_bases_per_s: aligned_bases_per_s read from the traced window,
in the cells whose runs spread too widely for it to stand end to end:
query plus target bases of every call answered in the traced window over
its wall (first call's start to last call's end), in bases/s.  The
profiler's overhead is in it, so it reads below the untraced rate."""


def read(ctx):
    return ctx.bases / ctx.window_s
