"""pairhmm_bwd_roofline: pairhmm_bwd's least time (gpubench/roofline.py, on the traced
window's pairs) over its device time in the trace, in %."""

from gpubench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "pairhmm_bwd")
