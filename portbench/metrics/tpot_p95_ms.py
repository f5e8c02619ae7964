"""95th percentile, over the requests completed in the window with at
least 2 tokens, of (done - first token) / (tokens - 1), in ms (host
clock)."""

from portbench import timeline


def read(ctx):
    v = timeline.p95(timeline.tpot_values(ctx.window.recs, ctx.window.t_end))
    return None if v is None else v * 1e3
