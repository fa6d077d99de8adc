"""The classic engine's backward per solve, in ms: the result's
stats["secs_backward"] summed over the traced window's solves / solves.
Moves solve_ms."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any(s.get("secs_backward") is None for s in stats):
        return None
    return 1e3 * sum(s["secs_backward"] for s in stats) / len(stats)
