"""Profiled device ms of every device operation but the three stream
kernels (the model's micro-steps and the engine's own copies), per
``decode_step`` the engine ran (its ``decode_steps`` count: one per
micro-step), over the profiled megasteps after the window."""


def read(ctx):
    t = ctx.tail
    if t is None or not t.micro:
        return None
    return t.other_s / t.micro * 1e3
