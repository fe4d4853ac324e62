"""Device ops: coefficient grids, stencil, DCT products and the kernels."""
