"""Share of the stream kernels' roofline, in %: the bytes that the
profiled megasteps' page-ins and page-outs had to move through
``duplex_kv_stream`` / ``quant_stream`` / ``dequant_stream``, each read
and write once, over 3.35 TB/s, against the profiled device time of
those kernels. Nothing to read where no stream kernel ran."""

from portbench.devtrace import PEAK_HBM_BYTES


def read(ctx):
    t = ctx.tail
    if t is None or t.stream_s <= 0 or t.stream_bytes <= 0:
        return None
    return t.stream_bytes / PEAK_HBM_BYTES / t.stream_s * 100.0
