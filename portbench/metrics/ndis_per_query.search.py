"""Distances computed a query (``SearchStats.ndis``, fresh candidates of
the hops), summed over the window's queries."""


def read(ctx):
    c = ctx.counters
    if not c.get("queries") or "ndis" not in c:
        return None
    return c["ndis"] / c["queries"]
