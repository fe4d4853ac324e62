"""Material model for the Na2O-SiO2 glass system.

Host-side, setup-time-only math, carried over from ``chsimpy_tpu/material.py``
(which cannot be imported: importing any ``chsimpy_tpu`` module imports jax):
the linear Redlich-Kister interaction fit of Kim & Sander (1991) and the
common-tangent analysis that derives the gradient-energy parameter kappa.

``sympy`` is imported inside the solvers only.  Runs that pass
``kappa_tilde`` (``-K``) never need it, which is how runs go on machines
without sympy: the solve uses ``nsolve(prec=7)``, so no other solver gives
the same kappa to the last digit.  The UQ experiment's post-processing
(the miscibility gap and the spinodal roots of each member) needs it too.
"""

from __future__ import annotations

import functools

import numpy as np


def A0(T: float) -> float:
    """Redlich-Kister A0(T) [kJ/mol], Kim & Sander (1991) fit."""
    return 186.0575 - 0.3654 * T


def A1(T: float) -> float:
    """Redlich-Kister A1(T) [kJ/mol], Kim & Sander (1991) fit."""
    return 43.7207 - 0.1401 * T


def _gibbs_expr(sym, c, R, T, B, a0, a1):
    """Flory-Huggins Gibbs energy with linear Redlich-Kister interaction."""
    return (R * T * (c * (sym.log(c) - B) + (1 - c) * sym.log(1 - c))
            + (a0 + a1 * (1 - 2 * c)) * c * (1 - c))


@functools.lru_cache(maxsize=256)
def get_miscibility_gap(R: float, T: float, B: float, a0: float, a1: float,
                        xlower: float = 0.7, xupper: float = 0.9999,
                        prec: int = 7):
    """Common tangent of the Gibbs curve -> (c_A, c_B): solves
    f'(x1) == f'(x2) == (f(x2)-f(x1))/(x2-x1) with sympy nsolve."""
    import sympy as sym
    x1 = sym.Symbol('x1', real=True)
    x2 = sym.Symbol('x2', real=True)
    y1 = _gibbs_expr(sym, x1, R, T, B, a0, a1)
    y2 = _gibbs_expr(sym, x2, R, T, B, a0, a1)
    dy1 = sym.diff(y1, x1)
    dy2 = sym.diff(y2, x2)
    eq1 = sym.Eq(dy1, dy2)
    eq2 = sym.Eq(dy1, (y2 - y1) / (x2 - x1))
    sol = sym.nsolve((eq1, eq2), (x1, x2), (xlower, xupper), prec=prec)
    return (float(sol[0]), float(sol[1]))


@functools.lru_cache(maxsize=256)
def get_distance_common_tangent(R: float, T: float, B: float, a0: float,
                                a1: float, at: float) -> float:
    """Vertical distance between the Gibbs curve and its common tangent at
    concentration ``at`` -- the base value of kappa."""
    import sympy as sym
    x = sym.Symbol('x', real=True)
    E = _gibbs_expr(sym, x, R, T, B, a0, a1)
    ca, cb = get_miscibility_gap(R, T, B, a0, a1)
    m = (E.subs(x, cb) - E.subs(x, ca)) / (cb - ca)
    dist = (E - m * (x - ca) - E.subs(x, ca)).subs(x, at)
    return float(np.float64(dist))


@functools.lru_cache(maxsize=256)
def get_roots_of_EPP(R: float, T: float, a0: float, a1: float):
    """Spinodal points: roots of the rational EPP expression on (0, 1)
    (reference ``chsimpy/utils.py:176-180``), as sympy's ``solveset``
    orders them."""
    import sympy as sym
    x = sym.Symbol('x', real=True, positive=True)
    c = x
    EPP = (-2 * a0 * c**2 + 2 * a0 * c + 12 * a1 * c**3
           - 18 * a1 * c**2 + 6 * a1 * c - R * T) / (c**2 - c)
    roots = sym.solveset(EPP, x, domain=sym.Interval(0, 1))
    return [float(r) for r in roots]
