"""K3 on uint8 rows (``vec_dist_bytes_kernel``): its share of its roofline
in the traced part of the window, in %. Time: the profiler's sum of the
kernel's events. Work (``roofline.vec_dist_work``): the traced batches'
fresh distances (``ndis``), each reading its d-byte row, and each K3
launch on uint8 rows (the program's launch counter) reading its query
rows and writing at least one distance a query."""

from portbench import roofline

KERNEL = "vec_dist_bytes_kernel"
COUNTER = "gathered_vec_dist/uint8"


def read(ctx):
    t = ctx.trace
    tr = ctx.counters.get("traced")
    if t is None or not tr or not tr.get("batches"):
        return None
    seconds = t.op_seconds(KERNEL)
    launches = tr.get("launches", {}).get(COUNTER, 0)
    if seconds <= 0 or launches <= 0:
        return None
    d = ctx.cfg["d"]
    nbytes, flops = roofline.vec_dist_work(tr["ndis"], launches,
                                           tr["q_rows"], d, row_bytes=d)
    return roofline.share_percent(nbytes, flops, seconds)
