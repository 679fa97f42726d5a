"""The device's idle share of the traced part of the window, in %: one
less the union of its operations' time over the window's length."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_percent()
