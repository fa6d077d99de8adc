"""Device idle share of the traced window of solves, in %: 1 - (the union
of every kernel, copy and memset interval / the window's wall time), from
torch.profiler (devtrace.py). Moves the solve rate."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("solves") or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
