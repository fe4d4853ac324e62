"""Host ms a step iteration spent waiting on the device and copying rows:
the spans ``ch.poll`` (the stop flag read every STOP_POLL steps) and
``ch.sync`` (the chunk's rows and stops to the host)."""

from chbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ('ch.poll', 'ch.sync'))
