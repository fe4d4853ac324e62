"""2-D DCT-II / DCT-III as matrix products (the matmul route).

The orthonormal DCT-II along an axis is a product with the (N, N) cosine
matrix C, so

    dct2(U)  = C @ U @ C^T          idct2(X) = C^T @ X @ C

as in ``chsimpy_tpu/ops/dct.py``.  The JAX package leaves these products to
XLA outside any Pallas kernel; here they go to ``torch.matmul``.  The
transposes are views, so no copy of C is made.

float32 products run in full float32: :func:`require_full_fp32` turns
TF32 off.  The JAX float32 route contracts at 3-pass bf16 ('high', about
float32 accuracy) and its E trace is held to the float32 class against
float64 (1e-5 relative); TF32 keeps about three decimal digits and would
leave that class.  Whether a TF32 or 3xTF32 product keeps the class is a
measurement for a later change.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dct_matrix_np(N: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, computed in float64:
    C[k, n] = s_k * cos(pi * (2n + 1) * k / (2N)),
    s_0 = sqrt(1/N), s_k = sqrt(2/N)."""
    k = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(N, dtype=np.float64)[None, :]
    C = np.cos(np.pi * (2.0 * n + 1.0) * k / (2.0 * N))
    C *= np.sqrt(2.0 / N)
    C[0, :] *= np.sqrt(0.5)
    C.setflags(write=False)
    return C


def dct_matrix(N: int, dtype=torch.float64, device='cpu') -> torch.Tensor:
    return torch.tensor(_dct_matrix_np(N)).to(device=device, dtype=dtype)


def require_full_fp32() -> None:
    """Keep float32 matrix products in full float32 on the card (see the
    module docstring for why the slice does not take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def dct2(U: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II (equals scipy ``dctn(U, norm='ortho')``)."""
    return torch.matmul(torch.matmul(C, U), C.T)


def idct2(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-III, the exact inverse of :func:`dct2`."""
    return torch.matmul(torch.matmul(C.T, X), C)


@functools.lru_cache(maxsize=64)
def _split_permutation_np(N: int, levels: int) -> np.ndarray:
    """perm with (P·C x)[i] == (C x)[perm[i]] for the permuted block order
    [E-leaf, O_levels, ..., O_1] of the recursive even/odd fold (the order
    the ozaki rfold route emits, ops/ozaki.py)."""
    def rec(n, lv):
        if lv == 0 or n % 2:
            return np.arange(n)
        even = 2 * rec(n // 2, lv - 1)
        odd = 1 + 2 * np.arange(n // 2)
        return np.concatenate([even, odd])
    return rec(N, levels)


def split_permute_grid(G: np.ndarray, N: int, levels: int) -> np.ndarray:
    """Conjugate an (N, N) spectral-space grid into the permuted basis
    (host-side, at setup)."""
    p = _split_permutation_np(N, levels)
    return np.asarray(G)[np.ix_(p, p)]


def split_permute_axis(v: np.ndarray, N: int, levels: int) -> np.ndarray:
    """Permute a 1-D spectral axis into the same block order: the
    separable factor of :func:`split_permute_grid`."""
    return np.asarray(v)[_split_permutation_np(N, levels)]
