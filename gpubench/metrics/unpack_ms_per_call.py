"""unpack_ms_per_call: the mean over the traced window's engine calls of
the summed time of the port's `cactus.unpack` spans inside each call
(the host loop that turns each batch's arrays into answers: moves_to_ops
and gap_fallback, or banded_hits' rows), in ms
(gpubench/program_spans.py).  None for a program without the spans."""

from gpubench.program_spans import stage_ms_per_call


def read(ctx):
    return stage_ms_per_call(ctx, "cactus.unpack")
