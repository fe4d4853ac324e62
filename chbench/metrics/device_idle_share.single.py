"""The share of the traced span in which the device runs no operation."""


def read(ctx):
    return ctx.idle_pct()
