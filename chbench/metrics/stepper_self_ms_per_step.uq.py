"""Host ms a step iteration of the step's own bookkeeping: the self time of
the span ``ch.step`` (the step less its K1, transform, update and
statistics spans: the selects, the row, the stop predicate)."""

from chbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ('ch.step',), key='self_ms')
