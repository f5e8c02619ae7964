"""Mean ms from ``submit()`` to the boundary at which a request left
``WAITING``, over the requests admitted in the window (host clock)."""

from portbench import timeline


def read(ctx):
    v = timeline.queue_waits(ctx.window.recs, ctx.window.t_end)
    return sum(v) / len(v) * 1e3 if v else None
