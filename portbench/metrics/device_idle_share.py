"""Share of the profiled megasteps' wall time in which no device
operation ran, in %."""


def read(ctx):
    t = ctx.tail
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
