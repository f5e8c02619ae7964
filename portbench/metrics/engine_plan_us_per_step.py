"""Host µs of the engine's ``plan`` span (``serve/trace.py``, host
clock) an engine step, over the window of a traced run: admission and
every live row's trajectory, host work with no device sync. The
``dispatch`` span is left out: on the card it also waits on the device
(``engine_host_idle_ms_per_step`` reads what of it the device waits
for)."""


def read(ctx):
    w = ctx.window
    if w.plan_us is None or not w.steps:
        return None
    return w.plan_us / w.steps
