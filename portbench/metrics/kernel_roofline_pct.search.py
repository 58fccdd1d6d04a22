"""The fused scoring kernels' share of their roofline: the least time
their work needs (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s,
counted from each batch's terms and each scored segment's posting
layout) over their device time in the profiler's trace."""
from portbench.lib import readers


def read(ctx):
    if ctx.events is None:
        return None
    return readers.roofline_pct(ctx, readers.live_calls(ctx))
