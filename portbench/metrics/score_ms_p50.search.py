"""Median time a batch spends in the live view, from the server's
``score`` stage span of each batch: dispatch to the one host copy of the
answers, which waits for the card."""
from portbench.lib import readers


def read(ctx):
    return readers.p50(sp.duration_us / 1e3 for b in ctx.session.batches()
                       for sp in b["spans"] if sp.name == "score")
