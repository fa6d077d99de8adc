"""The solve's share of the card's roofline, in %: the least work the
board's strong solve needs (work.least_work: frozen, computed from the
board by the reference's reachability sweep) times the solves of the
traced window, over the device's busy time in that window (all device
activity, whatever implements it). Notes which bound binds and the card's
power limit. Moves the solve rate."""

import work


def read(ctx):
    tr = ctx.get("trace")
    n = ctx.get("solves")
    if not tr or not n or not ctx.get("work") or tr["busy_s"] <= 0:
        return None
    ops, nbytes = ctx["work"]
    share, bound = work.roofline(ops * n, nbytes * n, tr["busy_s"])
    ctx["notes"].append(
        f"dense_roofline_pct.solve: bound by {bound} ({ops} integer "
        f"operations at {work.PEAK_INT_OPS:.4g}/s, {nbytes} bytes at "
        f"{work.PEAK_BYTES:.4g} B/s per solve); card {ctx.get('card')}")
    return share
