"""Share of the traced span's step iterations that ran in CUDA graph
replays: each span ``ch.replay`` (the port's ``ChunkGraph``) runs
``STOP_POLL`` steps, over the span's step iterations (K1_members'
launches).  A program that records no replay reads nothing."""


def read(ctx):
    try:
        from chsimpy_tpu_torch import tracing
        from chsimpy_tpu_torch.core.stepper import STOP_POLL
    except ImportError:
        return None
    replays = tracing.summary().get('ch.replay')
    if not ctx.steps or not replays:
        return None
    return 100.0 * replays['count'] * STOP_POLL / ctx.steps
