"""95th percentile of the time from ``submit()`` to the end of the
megastep whose readback held the first token, over every request
submitted in the window (one still waiting counts its wait so far), in
ms (host clock)."""

from portbench import timeline


def read(ctx):
    v = timeline.p95(timeline.ttft_values(ctx.window.recs, ctx.window.t_end))
    return None if v is None else v * 1e3
