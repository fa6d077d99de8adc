"""Host time per solve enqueueing the dense level kernels, in ms: the
program's dense_launch spans (level geometry, the output's allocation, the
launch checks, the counter's fill, the launch arguments and the launch;
one per level), stats["trace"] summed over the traced window's solves /
solves. None where a solve has no trace. Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_launch"]["s"]
                     for s in stats) / len(stats)
