"""live_cell_share: the live cells of the traced window's pairs (rows
1..m, columns 0..n inside the band) over the cells its DP launches
computed (P x M x band of every launch of the driver's `launch`
wrapper, padding included), in %."""


def read(ctx):
    if not ctx.computed_cells:
        return None
    return 100.0 * ctx.live_cells / ctx.computed_cells
