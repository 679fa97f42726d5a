"""The devices' idle share of the traced part of the window, in %: one
less the union of a card's operations' time over the window's length,
with both times the mean over the cards."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_percent()
