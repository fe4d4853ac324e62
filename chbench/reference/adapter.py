"""The reference in the program's place: the part of the port's
``Solver`` API that the ``single`` runner calls (``prepare``,
``solve_or_resume``, ``solution.computed_steps``, ``solution.U``,
``solution.timedata.data()``), served by :class:`~.ch.Reference` at a
given precision.  The check's control runs it in TF32 where the program
has no lower-precision path of its own."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..inputs import a_fit
from .ch import Physics, Reference


class _Rows:
    def __init__(self):
        self.blocks = []

    def data(self) -> np.ndarray:
        return np.concatenate(self.blocks)


class _Solution:
    def __init__(self, U):
        self.U = U
        self.computed_steps = 1
        self.timedata = _Rows()


class ReferenceSolver:
    """A single run of the reference, pinned ``kappa_tilde`` and the
    temperature's A-fit, at ``precision``."""

    def __init__(self, params, U_init, precision: str = 'tf32'):
        p = params
        A0, A1 = a_fit(p.temp)
        self.ref = Reference(Physics.from_params(dataclasses.asdict(p)),
                             [A0], [A1], [p.kappa_tilde], device=p.device,
                             precision=precision, full_sim=p.full_sim)
        self.U_init = torch.as_tensor(np.asarray(U_init))
        self.solution = None
        self._E2_first = None

    def prepare(self):
        self.solution = _Solution(self.U_init.to(self.ref.device))

    def solve_or_resume(self, nsteps: int):
        sol = self.solution
        fresh = sol.computed_steps == 1
        out = self.ref.run(sol.U, nsteps - 1 if fresh else nsteps,
                           start_step=sol.computed_steps, rows0=fresh,
                           E2_first=self._E2_first)
        rows = out['rows'][0, :out['n_rows'][0]]
        if fresh:
            self._E2_first = rows[0, 2]
        sol.timedata.blocks.append(rows)
        sol.computed_steps = int(out['computed_steps'][0])
        sol.U = out['U'][0]
        return sol
