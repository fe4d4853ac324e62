"""The inputs of a run, made by the benchmark from ``--seed``.

Both sides get the same inputs: the program through its public API
(``U_init=``, ``A_pairs=``, ``kappas=``), the plain reference directly.

* The initial field: U0 = c0 + c0 · 0.01 · (r − 0.5), r uniform on [0, 1),
  upstream's construction, drawn in float64 on the run's device by a
  ``torch.Generator`` seeded with the seed.
* The Monte-Carlo members: upstream's experiment script as its defaults
  run it, ``runs`` pairs of A-factors uniform on the configuration's
  interval from numpy's PCG64 stream of its fixed ``A_seed`` (upstream's
  ``--A-seed``), for each of the configuration's ``designs``: ``uniform``
  (both factors of a run vary: ``runs`` members) and ``independent``
  (the same draws, A0's alone then A1's alone: ``2 * runs`` members), each
  factor multiplying the Kim & Sander (1991) fit at the configuration's
  temperature.  Each design is cut into batches of consecutive runs as
  the experiment cuts them (:func:`batch_width`).  The seed draws the
  order in which the batches run (a fresh permutation each time round):
  every seed runs the same batches.
* Each member's kappa_tilde: the common tangent of its Gibbs curve
  (:mod:`chbench.kappa`).
* Which results the check samples: a PCG64 stream of (seed, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .kappa import kappa_tilde

SEED_MASK = (1 << 63) - 1


def initial_field(N: int, c0: float, seed: int, device) -> torch.Tensor:
    """The (N, N) float64 initial field of ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    r = torch.rand((N, N), generator=g, dtype=torch.float64, device=device)
    return c0 + c0 * 0.01 * (r - 0.5)


def a_fit(temp: float) -> tuple:
    """(A0, A1) [kJ/mol] of the Kim & Sander (1991) linear fit."""
    return 186.0575 - 0.3654 * temp, 43.7207 - 0.1401 * temp


def design_factors(runs: int, lo: float, hi: float, A_seed: int,
                   design: str) -> np.ndarray:
    """The (members, 2) A-factors of one design, as the experiment draws
    them (``experiment.py`` ``generate_A_factors``, source ``uniform``)."""
    rng = np.random.Generator(np.random.PCG64(int(A_seed)))
    draws = rng.uniform(lo, hi, size=(runs, 2))
    if design == 'uniform':
        return draws
    if design == 'independent':
        fac = np.ones((2 * runs, 2))
        fac[:runs, 0] = draws[:, 0]
        fac[runs:, 1] = draws[:, 1]
        return fac
    raise ValueError(f"not a design: {design!r}")


def batch_width(members: int, processes: int, host_pool: bool) -> int:
    """Members a device batch, as the experiment's ``-P`` sets it: the
    given width, or (``-P -1``) every member at once, except that with the
    host pool on and at least 8 members the design splits in two
    (``experiment.py`` ``_auto_batch_width``)."""
    if processes > 0:
        return processes
    if members >= 8 and host_pool:
        return (members + 1) // 2
    return members


class MemberStream:
    """Batches of the design's members, (A_pairs (R, 2), kappas (R,)), in
    the order the seed draws; a batch's R is its design's width."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        p = config['params']
        lo, hi = config['A_factors']
        runs = int(config['runs'])
        base = np.array(a_fit(p['temp']))
        self.batches = []
        for design in config['designs']:
            A = design_factors(runs, lo, hi, config['A_seed'], design) * base
            kap = np.array([kappa_tilde(p['R'], p['temp'], p['B'], a0, a1,
                                        p['XXX']) for a0, a1 in A])
            width = batch_width(len(A), int(traffic['processes']),
                                bool(config['host_pool']))
            self.batches += [(A[i:i + width], kap[i:i + width])
                             for i in range(0, len(A), width)]
        self.order = np.random.Generator(
            np.random.PCG64(int(seed) & SEED_MASK))
        self._next = []

    def widths(self) -> list:
        """Every batch width the design takes, each once."""
        return sorted({len(A) for A, _ in self.batches})

    def first_of_width(self, R: int):
        return next(b for b in self.batches if len(b[0]) == R)

    def batch(self):
        if not self._next:
            self._next = list(self.order.permutation(len(self.batches)))
        return self.batches[self._next.pop(0)]


def sample_stream(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) & SEED_MASK, 1]))
