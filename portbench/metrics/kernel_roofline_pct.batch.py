"""The fused candidate kernel's share of its roofline: the least time
its work needs (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s,
counted from each batch's terms and the index's posting layout) over
its device time in the profiler's trace."""
from portbench.lib import readers


def read(ctx):
    if ctx.events is None:
        return None
    return readers.roofline_pct(ctx, readers.static_calls(ctx))
