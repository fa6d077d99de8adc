"""Blocking reads of device values per solve: the program's host_syncs
counter (each level's download, each per-level miss count, each reach
count of a sweep, the root), stats["trace"] summed over the traced
window's solves / solves. None where a solve has no trace. Moves the solve
rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return sum(s["trace"]["host_syncs"] for s in stats) / len(stats)
