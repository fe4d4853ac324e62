"""The hand-written kernels' share of their roofline: the sum of each
launch's byte bound (kernels/, each field read or written once at 3.35
TB/s) over the sum of their device time, in the traced span."""


def read(ctx):
    return ctx.roofline_pct()
