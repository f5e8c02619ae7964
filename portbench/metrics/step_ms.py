"""Host ms an engine step: the window's seconds over the engine steps it
ran (the change of ``stats()["steps"]``)."""


def read(ctx):
    w = ctx.window
    return w.seconds / w.steps * 1e3 if w.steps else None
