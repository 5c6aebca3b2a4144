"""pack_ms_per_call: the mean over the traced window's engine calls of the
summed time of the port's `cactus.pack` spans inside each call (each
batch's packing and its copy to the card: pack_band_batch and
_to_device, or pack_to_device), in ms (gpubench/program_spans.py).  None
for a program without the spans."""

from gpubench.program_spans import stage_ms_per_call


def read(ctx):
    return stage_ms_per_call(ctx, "cactus.pack")
