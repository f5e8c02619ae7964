"""95th percentile, by nearest rank, of the requests that the program's
admission queue admitted ahead of a request although they were behind it
in FIFO order (arrival step, then submission), over the requests
submitted in the window and admitted by its end: the ``overtaken`` count
of ``Request.trace``. Nothing to read where the program stamps no
request."""

from portbench import stamps, timeline


def read(ctx):
    return timeline.p95(s["overtaken"] for s in stamps.admitted(ctx.window))
