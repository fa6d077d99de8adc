"""Device time of host<->device copies per solve of the traced window, in
ms (every "Memcpy ..." activity of torch.profiler; the run's stderr gives
them by kind). Moves the solve rate."""


def read(ctx):
    tr = ctx.get("trace")
    n = ctx.get("solves")
    if not tr or not n:
        return None
    return 1e3 * tr["copy_s"] / n
