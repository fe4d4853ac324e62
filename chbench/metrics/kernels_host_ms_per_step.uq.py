"""Host ms a step iteration in the hand-written kernels' wrappers: the
spans ``ch.mu`` (K1), ``ch.update`` (K2 / K12) and ``ch.stats`` (K3, K4
with Ra, the float64 finish)."""

from chbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ('ch.mu', 'ch.update', 'ch.stats'))
