"""Result rows the ranks exchanged a batch (every rank's [batch, k])."""


def read(ctx):
    c = ctx.counters
    if not c.get("batches") or "gathered_rows" not in c:
        return None
    return c["gathered_rows"] / c["batches"]
