"""Host ms a step iteration in the transforms: the spans ``ch.dct2`` and
``ch.idct2`` (their products' launches; the solve's entry transform is
one ``ch.dct2`` of the traced span)."""

from chbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ('ch.dct2', 'ch.idct2'))
