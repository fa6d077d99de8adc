"""Host time per solve in the blocking download of each level's cells, in
ms: the program's dense_download spans (the wait for the level's kernel,
the device copy to pageable memory and the host's staging tail; one per
level), stats["trace"] summed over the traced window's solves / solves.
None where a solve has no trace. Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_download"]["s"]
                     for s in stats) / len(stats)
