"""Host time per solve before its first level and after its last, in ms:
the program's dense_enter (status tracker, watchers, peak-stats reset)
and dense_exit (root read, reach counts, miss counts, stats) spans,
stats["trace"] summed over the traced window's solves / solves. The
harness's own work between solves is outside them. None where a solve has
no trace. Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_enter"]["s"]
                     + s["trace"]["dense_exit"]["s"]
                     for s in stats) / len(stats)
