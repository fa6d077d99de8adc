"""Host time per solve in the root read that ends a dense solve, in ms:
the program's dense_drain span (inside dense_exit: the host's wait for
every kernel and copy the solve queued), stats["trace"] summed over the
traced window's solves / solves. None where a solve has no trace or no
such span. Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("dense_drain" not in s.get("trace", {})
                        for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_drain"]["s"]
                     for s in stats) / len(stats)
