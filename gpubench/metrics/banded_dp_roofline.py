"""banded_dp_roofline: banded_dp's least time (gpubench/roofline.py, on the traced
window's pairs) over its device time in the trace, in %."""

from gpubench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "banded_dp")
