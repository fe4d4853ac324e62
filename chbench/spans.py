"""The port's own spans (``chsimpy_tpu_torch/tracing.py``) as the
per-layer readers read them: host ms a step iteration of the traced span.

The spans are on while the traced span's profiler session is open, so
their totals are that session's: the entry transform, the traced chunk
and its sync.  A program without the spans (no ``tracing`` module, or
none of the names recorded) reads nothing."""

from __future__ import annotations


def ms_per_step(ctx, names, key='total_ms'):
    """Σ ``key`` ('total_ms' or 'self_ms') of the spans ``names`` over the
    traced span's step iterations, or None."""
    try:
        from chsimpy_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    found = [spans[n][key] for n in names if n in spans]
    if not ctx.steps or not found:
        return None
    return sum(found) / ctx.steps
