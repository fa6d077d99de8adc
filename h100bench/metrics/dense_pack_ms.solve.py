"""Host time per solve building and sending up the dense level loop's
constants, in ms: the program's dense_pack spans (kernel_pack on the host,
pin_memory, the upload's enqueue; one per level), stats["trace"] summed
over the traced window's solves / solves. None where a solve has no trace
(a program without the spans). Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_pack"]["s"] for s in stats) / len(stats)
