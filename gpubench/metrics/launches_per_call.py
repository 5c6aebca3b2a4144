"""launches_per_call: kernel launches of the traced window, counted by
the port's cuda_build.LAUNCHES, over its engine calls."""


def read(ctx):
    return sum(ctx.launches.values()) / ctx.n_calls
