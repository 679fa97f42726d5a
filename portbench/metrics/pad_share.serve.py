"""Padded rows of the serving layer's searches (``Searcher.stats``), as a
share of all rows it searched, in %."""


def read(ctx):
    s = ctx.counters.get("serve")
    if not s:
        return None
    rows = s["queries_served"] + s["rows_padded"]
    return 100.0 * s["rows_padded"] / rows if rows else None
