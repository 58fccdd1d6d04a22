"""Device time (profiler) of every operation the scoring thread launched
that is not one of the port's hand-written kernels, per scored batch."""
from portbench.lib import readers


def read(ctx):
    return readers.torch_ops_ms_per_batch(ctx)
