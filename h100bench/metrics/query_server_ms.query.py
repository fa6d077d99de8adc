"""Mean server-side time per POST /query over the window, in ms: the
gamesman_http_request_seconds histogram's growth in sum over its growth in
count, summed over every worker's /metrics, scraped before and after the
window. Moves query_p95_ms."""


def read(ctx):
    pair = ctx.get("scrape")
    if not pair:
        return None
    before, after = pair
    if not after or set(after) != set(before):
        return None
    name = "gamesman_http_request_seconds"
    ds = sum(after[w].get(name + "_sum", 0.0) - before[w].get(name + "_sum", 0.0)
             for w in after)
    dn = sum(after[w].get(name + "_count", 0.0)
             - before[w].get(name + "_count", 0.0) for w in after)
    return 1e3 * ds / dn if dn > 0 else None
