"""Device idle ms an engine step while the host is inside the engine's
``plan`` or ``dispatch`` span: the host work of the engine that the card
waits for, from the profiled engine steps after the window (device
trace, the spans placed on it by the host clock)."""


def read(ctx):
    t = ctx.tail
    if t is None or not t.steps:
        return None
    return t.engine_idle_s / t.steps * 1e3
