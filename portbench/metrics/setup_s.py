"""Seconds from the start of the process to the window's first
submit: imports, loading (or, in a new checkout, building) the kernels,
the weights, the engine with its graphs, and the warm-up."""


def read(ctx):
    return ctx.setup_s
