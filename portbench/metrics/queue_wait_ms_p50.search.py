"""Median wait of a query in the server's admission queue, from the
server's own ``queue_wait`` stage spans (every query traced): submit to
the batch's pickup."""
from portbench.lib import readers


def read(ctx):
    return readers.p50(sp.duration_us / 1e3 for t in ctx.session.tickets
                       if t.trace is not None for sp in t.trace.spans
                       if sp.name == "queue_wait")
