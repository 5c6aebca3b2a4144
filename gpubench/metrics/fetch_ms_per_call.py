"""fetch_ms_per_call: the mean over the traced window's engine calls of the
summed time of the port's `cactus.fetch` spans inside each call (the
copies of each batch's results back to the host, which wait for its
kernels), in ms (gpubench/program_spans.py).  None for a program without
the spans."""

from gpubench.program_spans import stage_ms_per_call


def read(ctx):
    return stage_ms_per_call(ctx, "cactus.fetch")
