"""Host ms a step iteration in the chunk loop: the spans ``ch.chunk`` (the
chunk's steps, launched from Python, and its stop polls) and ``ch.sync``
(the chunk's host sync).  Beside the device's busy ms a step iteration it
says how long the host takes to hand the device its work."""

from chbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ('ch.chunk', 'ch.sync'))
