"""Reachable positions solved per second over the traced window: the
reference's reachable count times the window's solves, over the window's
wall time (all its work and all its time, as the end-to-end rate of an
untraced run would be). The per-solve wall times on stderr show how far
the host's stalls spread it."""


def read(ctx):
    n = ctx.get("solves")
    if not n or not ctx.get("positions") or ctx["window_s"] <= 0:
        return None
    return ctx["positions"] * n / ctx["window_s"]
