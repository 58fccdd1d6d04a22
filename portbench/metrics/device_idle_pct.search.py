"""Share of the traced window in which no operation ran on the card,
from the profiler's timeline."""
from portbench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
