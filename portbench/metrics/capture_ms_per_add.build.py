"""Milliseconds of CUDA graph capture an ``add()`` (the sum of each
``add()``'s ``capture_ms`` over the window's calls)."""


def read(ctx):
    st = ctx.counters.get("build_stats")
    if not st:
        return None
    return sum(sum(s.get("capture_ms", [])) for s in st) / len(st)
