"""Device ops: coefficient grids, stencil, DCT products (matmul and the int8
ozaki route) and the kernels."""
