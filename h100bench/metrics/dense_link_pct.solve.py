"""The host link's share of its peak while a dense solve's cells go down,
in %: the bytes of cells the traced window's solves sent to host memory
(every level's P * C one-byte cells, each solve's
stats["encodable_positions"], where the config keeps the tables) over the
device time of the window's device-to-host copies (torch.profiler's
"Memcpy DtoH ..." activities, devtrace.py's copies), over the link's
peak. None without a trace or such a copy, where the config keeps no
tables, or where a solve resumed levels it did not send down. Moves the
solve rate."""

#: The H100 SXM's host link, PCIe 5.0 x16: 128 GB/s both ways together
#: (NVIDIA H100 Tensor Core GPU data sheet), 64 GB/s each way.
PEAK_BYTES_PER_S = 64e9


def read(ctx):
    tr, stats = ctx.get("trace"), ctx.get("stats")
    kwargs = (ctx.get("config") or {}).get("solver", {}).get("kwargs", {})
    if (not tr or not stats or not kwargs.get("store_tables", True)
            or any(s.get("levels_resumed") for s in stats)):
        return None
    dtoh_s = sum(v for k, v in tr["copies"].items()
                 if k.startswith("Memcpy DtoH"))
    if dtoh_s <= 0:
        return None
    nbytes = sum(s["encodable_positions"] for s in stats)
    return 100.0 * nbytes / dtoh_s / PEAK_BYTES_PER_S
