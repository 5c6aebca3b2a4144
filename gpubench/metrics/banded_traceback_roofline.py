"""banded_traceback_roofline: banded_traceback's least time (gpubench/roofline.py, on the traced
window's pairs) over its device time in the trace, in %."""

from gpubench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "banded_traceback")
