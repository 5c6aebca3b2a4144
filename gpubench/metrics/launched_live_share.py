"""launched_live_share: the live cells of the traced window's pairs (rows
1..m, columns 0..n inside the band) over the cells the port's DP
launches computed as it counts them (`cuda_build.cells()` of the
driver's DP kernel and its wide route: P x rows x band of each launch,
padding included), in %.  None for a program without the counter, or
where no launch ran on the card."""


def read(ctx):
    from cactus_tpu_torch.ops import cuda_build
    cells = getattr(cuda_build, "cells", None)
    if cells is None:
        return None
    counted = cells()
    kernel = ctx.driver.launch[1]
    computed = counted.get(kernel, 0) + counted.get(kernel + "_wide", 0)
    if not computed:
        return None
    return 100.0 * ctx.live_cells / computed
