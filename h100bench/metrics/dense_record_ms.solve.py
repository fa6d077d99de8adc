"""Host time per solve between one level's download and the next level,
in ms: the program's dense_record spans (the backward span's own fan-out,
the JSONL record, the status tracker, the flight recorder's boundary; one
per level), stats["trace"] summed over the traced window's solves /
solves. None where a solve has no trace. Moves the solve rate."""


def read(ctx):
    stats = ctx.get("stats")
    if not stats or any("trace" not in s for s in stats):
        return None
    return 1e3 * sum(s["trace"]["dense_record"]["s"]
                     for s in stats) / len(stats)
