"""Device ms a step iteration of every operation that is neither a
transform nor a hand-written kernel under kernels/: PyTorch's
elementwise operations, copies, selects and reductions (the step's
bookkeeping and the FFT route's twiddles and folds)."""


def read(ctx):
    return ctx.ms_per_step('eager')
