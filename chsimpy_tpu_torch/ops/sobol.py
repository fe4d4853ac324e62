"""Scrambled Sobol points as a function of the point index.

Port of ``chsimpy_tpu/ops/sobol.py``.  The ``sobol`` generator draws from a
``scipy.stats.qmc.Sobol(d=N, seed)`` engine.  Its construction (direction
numbers, Owen linear-matrix scramble, digital shift) is seeded host work;
after it the stream is a pure function of the point index n:

    x_n = (shift XOR (XOR over set bits k < 30 of gray(n) of sv[:, k])) * 2^-30
    gray(n) = n ^ (n >> 1),  n taken mod 2^32

so the card can make any window of points from the scrambled tables with no
host stream: kernel K9 (``ops/kernels.py`` ``sobol_jitter``) adds them as
the step's jitter.  :func:`sobol_points_ref` is the plain version: 30
XOR-select passes over the (points, dims) plane, in int64 tensors masked to
32 bits (torch's uint32 arithmetic is partial), so ``start + i`` wraps mod
2^32 as the JAX package's uint32 does.
"""

from __future__ import annotations

import numpy as np
import torch

SOBOL_BITS = 30  # scipy.stats.qmc.Sobol default 'bits'
MASK32 = 0xFFFFFFFF


def sobol_tables(N: int, seed) -> tuple:
    """(sv (N, 30) uint32, shift (N,) uint32) of scipy's scrambled engine
    for d=N dimensions; scipy builds them, so the scramble is the stream's
    to the bit."""
    from scipy.stats import qmc
    e = qmc.Sobol(d=N, seed=seed)
    if e.bits != SOBOL_BITS:
        raise RuntimeError(f"scipy Sobol bits changed ({e.bits}); the "
                           f"device path assumes {SOBOL_BITS}")
    return (np.ascontiguousarray(e._sv, dtype=np.uint32),
            np.asarray(e._shift, dtype=np.uint32))


def sobol_points_ref(sv: torch.Tensor, shift: torch.Tensor, start,
                     npoints: int) -> torch.Tensor:
    """Points ``start .. start+npoints-1`` (mod 2^32) of the scrambled
    sequence as a float64 (npoints, d) tensor: the values of
    ``engine.fast_forward(start); engine.random(npoints)`` to the bit.
    ``sv`` (d, 30) and ``shift`` (d,) are int64 tensors; ``start`` an int
    or a 0-d int64 tensor on their device (read with no host sync)."""
    dev = sv.device
    n = (torch.arange(npoints, dtype=torch.int64, device=dev) + start) \
        & MASK32
    g = n ^ (n >> 1)
    sv = sv & MASK32
    acc = torch.zeros((npoints, sv.shape[0]), dtype=torch.int64, device=dev)
    for k in range(SOBOL_BITS):
        bit = ((g >> k) & 1).bool()
        acc = acc ^ torch.where(bit[:, None], sv[:, k][None, :], 0)
    acc = acc ^ (shift & MASK32)[None, :]
    return acc.to(torch.float64) * (2.0 ** -SOBOL_BITS)
