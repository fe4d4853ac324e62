"""``np.gradient``-compatible finite-difference stencil.

The E2 surface-energy functional uses ``np.gradient(U, delx, axis=[0, 1],
edge_order=1)``: central differences in the interior, one-sided at the two
edges, with *division* by the spacing (not multiplication by a reciprocal)
to match NumPy's rounding.  The plain PyTorch form of what the statistics
kernel computes per element (ops/kernels.py).
"""

from __future__ import annotations

import torch


def _gradient_axis0(U: torch.Tensor, delx: float) -> torch.Tensor:
    interior = (U[2:, :] - U[:-2, :]) / (2.0 * delx)
    first = (U[1:2, :] - U[0:1, :]) / delx
    last = (U[-1:, :] - U[-2:-1, :]) / delx
    return torch.cat([first, interior, last], dim=0)


def gradient2d(U: torch.Tensor, delx: float):
    """(dU/dx, dU/dy) with edge_order=1."""
    dux = _gradient_axis0(U, delx)
    duy = _gradient_axis0(U.T, delx).T
    return dux, duy
