"""Random-field generation for the initial condition and per-step jitter.

Host-side and bit-exact with ``chsimpy_tpu/rng.py``, each generator on an
explicit stream of its own (torch's global RNG is never used):

* ``lcg``     — MATLAB-style float64 LCG, column-major placement (the
                plain numpy loop of the JAX package's fallback);
* ``uniform`` — numpy PCG64 stream;
* ``sobol``   — scipy ``qmc.Sobol(d=N, seed)`` stream (scipy imported when
                this generator is built);
* ``simplex`` — OpenSimplex noise over ``linspace(0, 48, N)`` (noise.py;
                deterministic, unseeded).

Per-step jitter draws from the same stream (``next_sample``).  The
device-side streams of the jitter (``jitter_backend='device'``) live in
the solver.
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
    """Host-side random-field source: ``initial_field(XXX)`` builds U0,
    ``next_sample()`` draws the next (N, N) sample of the same stream."""

    def __init__(self, kind: str, N: int, seed: int):
        self.kind = kind
        self.N = N
        self.seed = seed
        self._qrng = None
        self._rng = None
        self._simplex_field = None
        if kind == 'sobol':
            from scipy.stats import qmc
            self._qrng = qmc.Sobol(d=N, seed=seed)
        elif kind == 'uniform':
            self._rng = np.random.Generator(np.random.PCG64(seed))
        elif kind == 'simplex':
            from . import noise
            lin = np.linspace(0, 48, N)
            self._simplex_field = noise.noise2array(lin, lin)
        elif kind != 'lcg':
            raise ValueError(f"unknown generator '{kind}'")

    def next_sample(self) -> np.ndarray:
        """Next (N, N) sample from the stream."""
        if self.kind == 'uniform':
            return self._rng.random((self.N, self.N))
        if self.kind == 'sobol':
            return self._qrng.random(self.N)
        if self.kind == 'simplex':
            return self._simplex_field  # deterministic: same field each draw
        raise ValueError("the 'lcg' generator has no sample stream")

    @property
    def sobol_position(self) -> int:
        """Points the sobol engine has drawn (0 for the other kinds)."""
        return 0 if self._qrng is None else int(self._qrng.num_generated)

    # -- the stream position as plain data (no pickle) ------------------

    def state_dict(self) -> dict:
        """JSON-serializable stream position (see :meth:`from_state`): the
        PCG64 words for 'uniform', the draw count for 'sobol'."""
        d = {'kind': self.kind, 'N': self.N, 'seed': self.seed}
        if self.kind == 'uniform':
            st = self._rng.bit_generator.state
            # 128-bit ints as strings: survives any JSON reader
            d['pcg64'] = {'state': str(st['state']['state']),
                          'inc': str(st['state']['inc']),
                          'has_uint32': int(st['has_uint32']),
                          'uinteger': int(st['uinteger'])}
        elif self.kind == 'sobol':
            d['sobol_num_generated'] = self.sobol_position
        return d

    @classmethod
    def from_state(cls, d: dict) -> 'FieldGenerator':
        """A generator at the stream position captured by
        :meth:`state_dict` (bit-exact continuation)."""
        gen = cls(d['kind'], int(d['N']), d['seed'])
        if d['kind'] == 'uniform':
            p = d['pcg64']
            gen._rng.bit_generator.state = {
                'bit_generator': 'PCG64',
                'state': {'state': int(p['state']), 'inc': int(p['inc'])},
                'has_uint32': int(p['has_uint32']),
                'uinteger': int(p['uinteger'])}
        elif d['kind'] == 'sobol':
            n = int(d['sobol_num_generated'])
            if n:
                gen._qrng.fast_forward(n)
        return gen

    def initial_field(self, XXX: float) -> np.ndarray:
        """U0 from mean concentration XXX and 1% relative deviations."""
        if self.kind == 'lcg':
            return XXX + (XXX * 0.01
                          * matlab_lcg_sample(self.N, self.N, self.seed))
        return XXX + (XXX * 0.01 * (self.next_sample() - 0.5))
