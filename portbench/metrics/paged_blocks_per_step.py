"""Blocks the pool moved between HBM and the host tier (``page_ins`` +
``page_outs`` of its stats) an engine step, over the window."""


def read(ctx):
    w = ctx.window
    if not w.steps:
        return None
    return (w.page_ins + w.page_outs) / w.steps
