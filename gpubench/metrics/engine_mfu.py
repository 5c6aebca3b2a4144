"""engine_mfu: the whole window's share of the card's peak, in %: the sum
of every kernel's least time on the traced window's pairs (each its
operations over the peak of their kind or its bytes over the memory
bandwidth, whichever is larger) over the window's wall time.  It bounds
every kernel's roofline from above in its time share, and stays when a
kernel leaves the path."""

from gpubench.roofline import least_seconds, window_work


def read(ctx):
    total = 0.0
    for kernel in ctx.driver.kernels:
        total += least_seconds(*window_work(ctx, kernel))
    return 100.0 * total / ctx.window_s
