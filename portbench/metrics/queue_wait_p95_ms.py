"""95th percentile, by nearest rank, of a request's wait in the program's
admission queue, in ms: from ``ServeEngine.submit`` to its admission by
``RequestQueue.dispatch``, as the program stamps them on the engine
tracer's host clock (``Request.trace``), over the requests submitted in
the window and admitted by its end. Nothing to read where the program
stamps no request."""

from portbench import stamps, timeline


def read(ctx):
    return timeline.p95((s["admit_us"] - s["submit_us"]) / 1e3
                        for s in stamps.admitted(ctx.window))
