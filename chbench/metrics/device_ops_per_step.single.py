"""Device operations in the traced span over its step iterations: the
launch path of the step (the hand-written kernels, the library's and
PyTorch's eager operations, copies)."""


def read(ctx):
    return ctx.ops_per_step()
