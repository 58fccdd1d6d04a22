"""Median duration of the seals the index made in the window, from the
``seal`` events of its ``EventLog`` (host clock)."""
from portbench.lib import readers


def read(ctx):
    t0 = ctx.session.t_wall_start
    return readers.p50(e["duration_us"] / 1e3 for e in ctx.session.events
                       if e["kind"] == "seal" and "duration_us" in e
                       and e["t_wall"] >= t0)
