"""Requested query rows a search of the serving layer carried
(``Searcher.stats``: queries served over searches launched)."""


def read(ctx):
    s = ctx.counters.get("serve")
    if not s or not s["launches"]:
        return None
    return s["queries_served"] / s["launches"]
