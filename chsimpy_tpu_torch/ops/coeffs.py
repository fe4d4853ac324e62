"""Spectral coefficient grids for the semi-implicit DCT update.

The DCT diagonalizes the Laplacian under no-flux boundaries; the eigenvalues
use the (N-1) convention ``2*cos(pi*k/(N-1)) - 2`` of the reference, and

    CHeig = 1 + lam2 * leig^2      (implicit biharmonic denominator)
    Seig  = lam1 * leig            (explicit Laplacian of the nonlinear term)

with lam1 = delt/delx^2, lam2 = kappa_tilde*lam1/delx^2.  The operations
and their order are those of ``chsimpy_tpu/ops/coeffs.py``, so the float64
grids agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def eigenvalue_axis(N: int) -> np.ndarray:
    """1-D eigenvalue vector 2*cos(pi*k/(N-1)) - 2, k = 0..N-1 (float64)."""
    k = np.arange(N, dtype=np.float64)
    return 2.0 * np.cos(np.pi * k / (N - 1)) - 2.0


def eigenvalues(N: int, dtype=torch.float64, device='cpu') -> torch.Tensor:
    """(N, N) grid: leig[i, j] = e[i] + e[j] (summed in float64)."""
    e = eigenvalue_axis(N)
    return torch.as_tensor(e[:, None] + e[None, :]).to(device=device,
                                                       dtype=dtype)


def get_coefficients(leig: torch.Tensor, kappa_tilde: torch.Tensor,
                     delt: torch.Tensor, delx2: float):
    """(CHeig, Seig) from the eigenvalue grid; ``kappa_tilde`` and ``delt``
    are 0-d tensors of the grid's dtype."""
    lam1 = delt / delx2
    lam2 = kappa_tilde * lam1 / delx2
    CHeig = 1.0 + lam2 * (leig * leig)
    Seig = lam1 * leig
    return CHeig, Seig
