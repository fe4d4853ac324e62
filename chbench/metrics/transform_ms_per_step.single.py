"""Device ms a step iteration of the transforms: the library's products and
FFTs and K6 (classes/transform.json, kernels/ of class transform)."""


def read(ctx):
    return ctx.ms_per_step('transform')
