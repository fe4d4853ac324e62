"""OpenSimplex 2-D noise (Kurt Spencer's 2014 algorithm).

Self-contained reimplementation of the subset of the ``opensimplex`` PyPI
package used by the reference (``chsimpy/solver.py:71-74`` calls
``opensimplex.noise2array`` with the module-default seed): the 64-bit-LCG
permutation-table construction and the 2-D surflet-sum noise, vectorized over
NumPy arrays.  The reference never seeds the generator, so the package
default seed (3) is the default here as well.

Everything is float64 arithmetic over small integers and lattice offsets, so
the vectorized evaluation is bitwise identical to the scalar loop.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 3

_STRETCH2 = -0.211324865405187   # (1/sqrt(2+1)-1)/2
_SQUISH2 = 0.366025403784439     # (sqrt(2+1)-1)/2
_NORM2 = 47.0

_GRADIENTS2 = np.array(
    [5, 2, 2, 5, -5, 2, -2, 5, 5, -2, 2, -5, -5, -2, -2, -5],
    dtype=np.float64)

_M64 = (1 << 64)


def _overflow_i64(x: int) -> int:
    """Wrap a Python int to signed 64-bit (two's complement)."""
    x &= _M64 - 1
    return x - _M64 if x >= (1 << 63) else x


def build_permutation(seed: int = DEFAULT_SEED) -> np.ndarray:
    """256-entry permutation table from the 64-bit LCG shuffle."""
    perm = np.zeros(256, dtype=np.int64)
    source = np.arange(256, dtype=np.int64)
    for _ in range(3):
        seed = _overflow_i64(seed * 6364136223846793005 + 1442695040888963407)
    for i in range(255, -1, -1):
        seed = _overflow_i64(seed * 6364136223846793005 + 1442695040888963407)
        r = int((seed + 31) % (i + 1))
        if r < 0:
            r += i + 1
        perm[i] = source[r]
        source[r] = source[i]
    return perm


class OpenSimplex:
    def __init__(self, seed: int = DEFAULT_SEED):
        self._perm = build_permutation(seed)

    # -- vectorized helpers ------------------------------------------------
    def _extrapolate(self, xsb, ysb, dx, dy):
        perm = self._perm
        index = perm[(perm[xsb & 0xFF] + ysb) & 0xFF] & 0x0E
        g1 = _GRADIENTS2[index]
        g2 = _GRADIENTS2[index + 1]
        return g1 * dx + g2 * dy

    def noise2(self, x, y):
        """2-D OpenSimplex noise; accepts scalars or equal-shape arrays."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)

        stretch = (x + y) * _STRETCH2
        xs = x + stretch
        ys = y + stretch
        xsb = np.floor(xs).astype(np.int64)
        ysb = np.floor(ys).astype(np.int64)
        squish = (xsb + ysb) * _SQUISH2
        xb = xsb + squish
        yb = ysb + squish
        xins = xs - xsb
        yins = ys - ysb
        in_sum = xins + yins
        dx0 = x - xb
        dy0 = y - yb

        value = np.zeros_like(dx0)

        # contribution from lattice vertex (1, 0)
        dx1 = dx0 - 1.0 - _SQUISH2
        dy1 = dy0 - 0.0 - _SQUISH2
        attn1 = 2.0 - dx1 * dx1 - dy1 * dy1
        c1 = attn1 > 0
        a1 = np.where(c1, attn1, 0.0) ** 2
        value += np.where(c1, a1 * a1 * self._extrapolate(xsb + 1, ysb, dx1, dy1), 0.0)

        # contribution from lattice vertex (0, 1)
        dx2 = dx0 - 0.0 - _SQUISH2
        dy2 = dy0 - 1.0 - _SQUISH2
        attn2 = 2.0 - dx2 * dx2 - dy2 * dy2
        c2 = attn2 > 0
        a2 = np.where(c2, attn2, 0.0) ** 2
        value += np.where(c2, a2 * a2 * self._extrapolate(xsb, ysb + 1, dx2, dy2), 0.0)

        inside = in_sum <= 1.0  # which simplex triangle the point falls in

        # --- branch A: inside triangle (0,0) ---
        zins_a = 1.0 - in_sum
        cond_a1 = (zins_a > xins) | (zins_a > yins)   # (0,0) is furthest
        xgy = xins > yins
        a_xsv = np.where(cond_a1, np.where(xgy, xsb + 1, xsb - 1), xsb + 1)
        a_ysv = np.where(cond_a1, np.where(xgy, ysb - 1, ysb + 1), ysb + 1)
        a_dx = np.where(cond_a1, np.where(xgy, dx0 - 1.0, dx0 + 1.0),
                        dx0 - 1.0 - 2.0 * _SQUISH2)
        a_dy = np.where(cond_a1, np.where(xgy, dy0 + 1.0, dy0 - 1.0),
                        dy0 - 1.0 - 2.0 * _SQUISH2)

        # --- branch B: inside triangle (1,1) ---
        zins_b = 2.0 - in_sum
        cond_b1 = (zins_b < xins) | (zins_b < yins)   # (1,1) is furthest
        b_xsv = np.where(cond_b1, np.where(xgy, xsb + 2, xsb), xsb)
        b_ysv = np.where(cond_b1, np.where(xgy, ysb, ysb + 2), ysb)
        b_dx = np.where(cond_b1,
                        np.where(xgy, dx0 - 2.0 - 2.0 * _SQUISH2,
                                 dx0 + 0.0 - 2.0 * _SQUISH2),
                        dx0)
        b_dy = np.where(cond_b1,
                        np.where(xgy, dy0 + 0.0 - 2.0 * _SQUISH2,
                                 dy0 - 2.0 - 2.0 * _SQUISH2),
                        dy0)
        # in branch B the (0,0)-style contribution shifts to (1,1)
        b_xsb = xsb + 1
        b_ysb = ysb + 1
        b_dx0 = dx0 - 1.0 - 2.0 * _SQUISH2
        b_dy0 = dy0 - 1.0 - 2.0 * _SQUISH2

        xsv_ext = np.where(inside, a_xsv, b_xsv)
        ysv_ext = np.where(inside, a_ysv, b_ysv)
        dx_ext = np.where(inside, a_dx, b_dx)
        dy_ext = np.where(inside, a_dy, b_dy)
        xsb_c = np.where(inside, xsb, b_xsb)
        ysb_c = np.where(inside, ysb, b_ysb)
        dx0_c = np.where(inside, dx0, b_dx0)
        dy0_c = np.where(inside, dy0, b_dy0)

        # contribution from (0,0) or (1,1)
        attn0 = 2.0 - dx0_c * dx0_c - dy0_c * dy0_c
        c0 = attn0 > 0
        a0 = np.where(c0, attn0, 0.0) ** 2
        value += np.where(c0, a0 * a0 * self._extrapolate(xsb_c, ysb_c, dx0_c, dy0_c), 0.0)

        # contribution from the extra vertex
        attn_e = 2.0 - dx_ext * dx_ext - dy_ext * dy_ext
        ce = attn_e > 0
        ae = np.where(ce, attn_e, 0.0) ** 2
        value += np.where(ce, ae * ae * self._extrapolate(xsv_ext, ysv_ext, dx_ext, dy_ext), 0.0)

        return value / _NORM2

    def noise2array(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Noise on the Cartesian product grid; shape (y.size, x.size),
        matching the ``opensimplex`` package API."""
        xx, yy = np.meshgrid(np.asarray(x, dtype=np.float64),
                             np.asarray(y, dtype=np.float64))
        return self.noise2(xx, yy)


_default = OpenSimplex(DEFAULT_SEED)


def noise2array(x, y):
    return _default.noise2array(x, y)


def noise2(x, y):
    return _default.noise2(x, y)
