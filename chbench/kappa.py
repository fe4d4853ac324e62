"""kappa_tilde of a member from its Gibbs curve, in NumPy.

Upstream chsimpy derives the gradient-energy parameter from the common
tangent of the Flory–Huggins Gibbs curve with linear Redlich–Kister
interaction, f(c) = RT (c (ln c − B) + (1 − c) ln(1 − c)) +
(A0 + A1 (1 − 2c)) c (1 − c): the tangent's contact points (c_A, c_B)
solve f'(x1) = f'(x2) = (f(x2) − f(x1)) / (x2 − x1), found by Newton's
method from (0.7, 0.9999) as upstream's sympy ``nsolve``; the base value
is the curve's height above the tangent at the mean concentration, and
kappa_tilde = base / (0.1602564 · 64)².  The height is stationary in the
contact points at the solution, so the result does not depend on how
tightly they are solved.  The machine with the card has no sympy; a CPU
test holds this solve to the sympy one.
"""

from __future__ import annotations

import math

KAPPA_SCALE = (0.1602564 * 64) ** 2


def _f(c, RT, B, a0, a1):
    return (RT * (c * (math.log(c) - B) + (1 - c) * math.log(1 - c))
            + (a0 + a1 * (1 - 2 * c)) * c * (1 - c))


def _df(c, RT, B, a0, a1):
    return (RT * (math.log(c) - math.log(1 - c) - B)
            - 2 * a1 * c * (1 - c) + (a0 + a1 * (1 - 2 * c)) * (1 - 2 * c))


def _d2f(c, RT, B, a0, a1):
    return (RT / (c * (1 - c)) - 4 * a1 * (1 - 2 * c)
            - 2 * (a0 + a1 * (1 - 2 * c)))


def miscibility_gap(R, T, B, a0, a1, start=(0.7, 0.9999), iters=100):
    """(c_A, c_B), the common tangent's contact points."""
    RT = R * T
    x1, x2 = start
    for _ in range(iters):
        d1, d2 = _df(x1, RT, B, a0, a1), _df(x2, RT, B, a0, a1)
        h1, h2 = _d2f(x1, RT, B, a0, a1), _d2f(x2, RT, B, a0, a1)
        g1 = d1 - d2
        g2 = d1 * (x2 - x1) - (_f(x2, RT, B, a0, a1) - _f(x1, RT, B, a0, a1))
        # Jacobian of (g1, g2) in (x1, x2)
        j11, j12 = h1, -h2
        j21, j22 = h1 * (x2 - x1), d1 - d2
        det = j11 * j22 - j12 * j21
        s1 = (g1 * j22 - j12 * g2) / det
        s2 = (j11 * g2 - j21 * g1) / det
        # keep both points inside (0, 1)
        t = 1.0
        while not (0 < x1 - t * s1 < 1 and 0 < x2 - t * s2 < 1):
            t *= 0.5
        x1, x2 = x1 - t * s1, x2 - t * s2
        if abs(s1) < 1e-15 and abs(s2) < 1e-15:
            break
    return x1, x2


def kappa_tilde(R, T, B, a0, a1, at) -> float:
    """kappa_tilde of the curve (R, T, B, a0, a1) at concentration ``at``."""
    RT = R * T
    ca, cb = miscibility_gap(R, T, B, a0, a1)
    fa, fb = _f(ca, RT, B, a0, a1), _f(cb, RT, B, a0, a1)
    m = (fb - fa) / (cb - ca)
    base = _f(at, RT, B, a0, a1) - m * (at - ca) - fa
    return base / KAPPA_SCALE
