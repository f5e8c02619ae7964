"""Model FLOPs of the window's forward passes (each prompt token
consumed and each generated token fed back, by the family's count), over
the window's seconds and the card's 989 TFLOP/s bf16 peak, in %."""

from portbench.devtrace import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx.window
    if w.seconds <= 0 or w.flops <= 0:
        return None
    return w.flops / w.seconds / PEAK_BF16_FLOPS * 100.0
