"""Host loop of the Cahn-Hilliard integrator.

Port of ``chsimpy_tpu/core/solver.py`` for the slice: ``prepare()`` then
``solve_or_resume(nsteps)``.  Time stepping runs in chunks of
``chunk_size`` steps on the device (core/stepper.py); the host syncs once
per chunk: it reads the chunk's timedata rows and the scalar state, and
maps the stop code.  The reference's iteration-count semantics hold:

* a fresh solve (computed_steps == 1) runs ``nsteps - 1`` iterations, a
  resume runs ``nsteps``;
* ``hat_U`` is recomputed from U at every API entry, and carried across
  the internal chunks (so the chunk size never shows in the results);
* ``prepare()`` resets what the reference resets, and NOT time_delta_sum,
  delt or skip_check.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..derived import Derived
from ..device import resolve_device
from ..ops import dct as dct_ops
from ..params import Parameters, check_solver_scope
from ..rng import FieldGenerator
from ..solution import Solution
from ..timedata import TimeData
from . import state as state_mod
from .state import STOP_NAN, STOP_NONE, STOP_STRINGS, SolverState
from .stepper import (StepConfig, entry_dct2, make_consts, prepare_row0,
                      run_chunk)


class Solver:
    """Cahn-Hilliard (CH) integrator: semi-implicit spectral method over the
    2-D DCT, Flory-Huggins energy with linear Redlich-Kister interaction.
    See Ghiass et al (2016), JMS Part B 55(4):411-425."""

    def __init__(self, params: Parameters = None, U_init=None):
        self.params = params if params is not None else Parameters()
        params = self.params
        check_solver_scope(params)
        self.device = resolve_device(params.device)
        self.derived = Derived.from_params(params)
        self.solution = Solution(params, self.derived)
        N = params.N

        self.skip_check = False
        self.time_delta_sum = 0.0
        self.time_passed = 0.0
        self._prepared = False
        self.delt = params.delt

        # initial field: host-side, bit-exact generators
        if U_init is not None:
            U_init = np.asarray(U_init)
            if U_init.shape != (N, N):
                raise ValueError(
                    f"U_init has wrong shape {U_init.shape}, "
                    f"must be ({N}, {N})")
            self.U_init = np.asarray(U_init, dtype=np.float64)
        else:
            gen = FieldGenerator(params.generator, N, params.seed)
            self.U_init = gen.initial_field(params.XXX)

        time_limit = None
        if params.time_max is not None and params.time_max > 0:
            time_limit = params.time_max * 60.0

        d = self.derived
        self.cfg = StepConfig(
            N=N, dtype=params.precision,
            RT=d.RT, BRT=d.BRT, B=params.B,
            Amr=d.Amr, L=params.L, delx=d.delx, delx2=d.delx2,
            M_tilde=params.M_tilde, threshold=params.threshold,
            A0=d.A0, A1=d.A1, kappa_tilde=d.kappa_tilde,
            time_limit=time_limit, full_sim=params.full_sim)
        # chunk size: device steps per host round-trip
        self.chunk_size = max(1, int(params.chunk_size))
        dct_ops.require_full_fp32()
        self._consts = make_consts(self.cfg, self.delt, device=self.device)
        self._state: Optional[SolverState] = None

    # ------------------------------------------------------------------
    def prepare(self) -> None:
        """Initial computations before the simulation loop."""
        U0 = torch.as_tensor(self.U_init).to(device=self.device,
                                             dtype=self.cfg.tdtype)
        row0 = prepare_row0(self.cfg, self._consts, U0)
        E, E2, Ra, PS = torch.stack(row0).tolist()

        data = TimeData()
        data.insert(it=0, delt=self.delt, E=E, E2=E2, SA=0, domtime=0,
                    Ra=Ra, L2=0, PS=PS)

        state = state_mod.init_state(
            U0=U0, hat_U0=torch.zeros_like(U0),  # rebuilt at solve entry
            delt=self.delt, E2_first=E2, chunk_cap=self.chunk_size)
        # quirk parity: prepare() does NOT reset time_delta_sum/skip_check
        self._state = state.replace(
            time_delta_sum=torch.tensor(self.time_delta_sum,
                                        dtype=torch.float64,
                                        device=self.device),
            skip_check=torch.tensor(bool(self.skip_check),
                                    device=self.device))
        self.solution.U = U0
        self.solution.timedata = data
        self.solution.tau0 = 0.0
        self.solution.t0 = 0.0
        self.solution.stop_reason = 'None'
        self.solution.computed_steps = 1
        self._prepared = True

    # ------------------------------------------------------------------
    def solve_or_resume(self, nsteps: Optional[int] = None) -> Solution:
        """Run (or continue) the simulation; returns the Solution."""
        if not self._prepared:
            raise RuntimeError("call prepare() before solve_or_resume()")
        if nsteps is None:
            nsteps = max(self.params.ntmax, 0)

        # iteration-count semantics of the reference
        if self.solution.computed_steps == 1:
            n_iters = max(nsteps - 1, 0)
        else:
            n_iters = nsteps

        state = self._state
        # the reference recomputes the spectral image at every (re)entry
        state = state.replace(hat_U=entry_dct2(state.U, self._consts))
        if n_iters > 0:
            # re-entering after a stop continues the simulation
            state = state.replace(
                stop_reason=torch.full_like(state.stop_reason, STOP_NONE))
            self.solution.stop_reason = 'None'

        while n_iters > 0 and self.solution.stop_reason == 'None':
            k = min(n_iters, self.chunk_size)
            state = run_chunk(self.cfg, self._consts, state, k)
            n_iters -= k
            state = self._sync(state)

        self._state = state
        self.solution.U = state.U
        return self.solution

    def _sync(self, state: SolverState) -> SolverState:
        """Per-chunk host sync: pull rows, update host mirrors, map stop."""
        f64 = torch.float64
        scalars = torch.stack([
            state.rows.to(f64), state.stop_reason.to(f64),
            state.computed_steps.to(f64), state.tau0, state.t0,
            state.skip_check.to(f64), state.delt,
            state.time_delta_sum]).cpu().tolist()
        rows, stop, steps, tau0, t0, skip, delt, tds = scalars
        rows, stop = int(rows), int(stop)
        if rows > 0:
            # a copy: the device buffer is written in place by the next
            # chunk (and on the CPU .cpu() would alias it)
            block = state.rowbuf[:rows].to('cpu', copy=True).numpy()
            try:
                self.solution.timedata.insert_block(block)
            except FloatingPointError:
                self.solution.stop_reason = 'nan'
                raise
        if stop == STOP_NAN:
            self.solution.stop_reason = 'nan'
            raise FloatingPointError(
                f"NaN encountered in timedata (step {int(steps)})")
        if stop != STOP_NONE:
            self.solution.stop_reason = STOP_STRINGS[stop]
        self.solution.computed_steps = int(steps)
        self.solution.tau0 = tau0
        self.solution.t0 = t0
        self.skip_check = bool(skip)
        self.delt = delt
        self.time_delta_sum = tds
        self.time_passed = self.time_delta_sum / self.params.M_tilde
        return state.replace(rows=torch.zeros_like(state.rows))
