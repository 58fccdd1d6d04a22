"""Postings merged (seal builds plus compaction merges) per posting
appended in the window, from the index's cumulative ``stats``."""


def read(ctx):
    s0, s1 = ctx.session.stats0, ctx.session.stats1
    appended = s1["postings_appended"] - s0["postings_appended"]
    if appended <= 0:
        return None
    return (s1["postings_merged"] - s0["postings_merged"]) / appended
