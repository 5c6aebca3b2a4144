"""device_idle_share: the share of the traced window (first call's start
to last call's end) in which no kernel, copy or fill ran on the card,
in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
