"""Random-field generation for the initial condition.

Host-side and bit-exact with ``chsimpy_tpu/rng.py`` for the two generators
of this slice, each on an explicit numpy generator (torch's global RNG is
never used):

* ``lcg``     — MATLAB-style float64 LCG, column-major placement (the
                plain numpy loop of the JAX package's fallback);
* ``uniform`` — numpy PCG64 stream.

``sobol`` and ``simplex`` come with ROADMAP.md queue A item 7.
"""

from __future__ import annotations

import numpy as np

# MATLAB-style LCG: float64 semantics are part of the spec (a*x exceeds
# 2^53, so each iteration's rounding defines the sequence)
_LCG_A = np.float64(1103515245)
_LCG_C = np.float64(12345)
_LCG_M = np.float64(2 ** 31)


def matlab_lcg_sample(n1: int, n2: int, seed) -> np.ndarray:
    """n1 x n2 matrix of pseudo-random values on [0,1), column-major order."""
    x = np.float64(seed)
    total = n1 * n2
    flat = np.empty(total, dtype=np.float64)
    a, c, m = _LCG_A, _LCG_C, _LCG_M
    for i in range(total):
        x = (a * x + c) % m
        flat[i] = x
    sample = flat.reshape(n2, n1).T.copy()
    sample /= (m - 1)
    return sample


class FieldGenerator:
    """Host-side random-field source: ``initial_field(XXX)`` builds U0."""

    def __init__(self, kind: str, N: int, seed: int):
        self.kind = kind
        self.N = N
        self.seed = seed
        self._rng = None
        if kind == 'uniform':
            self._rng = np.random.Generator(np.random.PCG64(seed))
        elif kind in ('sobol', 'simplex'):
            raise NotImplementedError(
                f"the '{kind}' generator is not ported to chsimpy_tpu_torch "
                "yet (ROADMAP.md queue A item 7)")
        elif kind != 'lcg':
            raise ValueError(f"unknown generator '{kind}'")

    def next_sample(self) -> np.ndarray:
        """Next (N, N) sample from the stream."""
        if self.kind == 'uniform':
            return self._rng.random((self.N, self.N))
        raise ValueError("the 'lcg' generator has no sample stream")

    def initial_field(self, XXX: float) -> np.ndarray:
        """U0 from mean concentration XXX and 1% relative deviations."""
        if self.kind == 'lcg':
            return XXX + (XXX * 0.01
                          * matlab_lcg_sample(self.N, self.N, self.seed))
        return XXX + (XXX * 0.01 * (self.next_sample() - 0.5))
