"""Member-batched Monte-Carlo ensemble solver.

Port of ``chsimpy_tpu/ensemble.py``: the UQ members of the reference's
process pool (``chsimpy/experiment.py:84-126,197-216``) as a leading batch
axis of one solve.  Every member shares the step; the perturbed physics
scalars (A0, A1 and the kappa_tilde each pair implies) are per-member (R,)
tensors; per-member early stop freezes a stopped member while the others
run on.  Each step launches each of K1-K4 once for all members
(``ops/kernels.py`` ``*_members``); the DCTs are products (or FFTs)
batched over the member axis.  On the float64 ozaki route each slicing
is one K5_members call for all members (each member its own scale, as
the JAX ensemble's ``vmap`` gives it) and each int8 product serves all
members (``ops/ozaki.py``).

All members share the initial field (the reference re-uses the same seed
for every run, ``experiment.py:87-89``) and, with per-step jitter, the host
stream (``stream``; ``static`` for simplex), as in the JAX package.

The ozaki layout is resolved as the JAX ensemble resolves it off the
TPU: the level-1 fold for even N at every R, the recursive fold at
N >= 1024, the forward pair cutoffs as the single solver's, the rfold
inverse's pin-only (None: untrimmed).  The JAX package's TPU batch-width
gates (``_warn_wide_f64_batch``, the ozaki ``R > 4`` unfold, and the
experiment's four-wide clamp) have no counterpart: they guard a TPU
compiler fault.

Refused, each with its ROADMAP.md item: a ``mesh`` (the ensemble over an
'ens' mesh of cards) and ``--mesh`` (item 11).  The JAX ensemble has no
device jitter, so ``jitter_backend='device'`` is refused too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import material
from .core.solver import (_JITTER_BUF_BYTES, _resolve_rfold_levels,
                          check_split_levels, resolve_ozaki_fwd_pairs,
                          resolve_transform)
from .core.state import STOP_NAN, STOP_NONE, STOP_STRINGS, init_members_state
from .core.stepper import (StepConfig, entry_dct2, make_members_consts,
                           prepare_members_row0, run_members_chunk)
from .derived import Derived
from .device import resolve_device
from .ops import dct as dct_ops
from .params import Parameters, check_solver_scope, not_ported
from .rng import FieldGenerator
from .solution import Solution
from .timedata import TimeData


def derive_member_constants(params: Parameters, A0: float, A1: float):
    """kappa_tilde implied by a member's (A0, A1) pair — the sympy
    common-tangent solve the reference performs per process
    (``chsimpy/solution.py:39-48``); ``params.kappa_tilde`` where pinned.
    Host-side, cached by argument.  The card's machine has no sympy: pass
    the members' ``kappas`` (or pin ``kappa_tilde``) there."""
    if params.kappa_tilde is not None:
        return params.kappa_tilde
    kappa_base = material.get_distance_common_tangent(
        R=params.R, T=params.temp, B=params.B, a0=A0, a1=A1, at=params.XXX)
    return kappa_base / (0.1602564 * 64) ** 2


def ensemble_scope_errors(params: Parameters, mesh=None) -> list:
    """Why the ensemble cannot run ``params`` (empty: it can), beyond the
    single solver's refusals."""
    errs = []
    if mesh is not None:
        errs.append(not_ported("the ensemble over an 'ens' mesh of cards",
                               11))
    if params.mesh_shape is not None:
        errs.append(not_ported('the ensemble with grid-sharded member '
                               'fields (--mesh)', 11))
    return errs


class EnsembleSolver:
    """Batched Cahn-Hilliard integrator over UQ members.

    ``A_pairs`` is an (R, 2) array of (A0, A1) values (already perturbed);
    ``kappas`` (R,) the members' kappa_tilde where known (else each is
    derived, :func:`derive_member_constants`).  API of the JAX package:
    ``prepare()`` then ``solve_or_resume(nsteps)``; results come back as
    one Solution per member via ``solutions()``."""

    def __init__(self, params: Parameters, A_pairs: np.ndarray,
                 U_init: Optional[np.ndarray] = None, mesh=None,
                 kappas: Optional[np.ndarray] = None):
        self.params = params
        errs = ensemble_scope_errors(params, mesh)
        if errs:
            raise NotImplementedError('; '.join(errs))
        check_solver_scope(params)
        self.device = resolve_device(params.device)
        A_pairs = np.asarray(A_pairs, dtype=np.float64)
        if A_pairs.ndim != 2 or A_pairs.shape[1] != 2 \
                or A_pairs.shape[0] < 1:
            raise ValueError("A_pairs must be (R, 2)")
        self.R = A_pairs.shape[0]
        self.A0s = A_pairs[:, 0].copy()
        self.A1s = A_pairs[:, 1].copy()
        if kappas is not None:
            self.kappas = np.asarray(kappas, dtype=np.float64).copy()
            if self.kappas.shape != (self.R,):
                raise ValueError("kappas must be (R,)")
        else:
            self.kappas = np.array([
                derive_member_constants(params, a0, a1)
                for a0, a1 in zip(self.A0s, self.A1s)])
        N = params.N

        # initial field: shared across members (reference semantics)
        self.generator = None
        if U_init is not None:
            U_init = np.asarray(U_init, dtype=np.float64)
            if U_init.shape != (N, N):
                raise ValueError(f"U_init has wrong shape {U_init.shape}")
            self.U_init = U_init
        else:
            self.generator = FieldGenerator(params.generator, N, params.seed)
            self.U_init = self.generator.initial_field(params.XXX)

        jitter_on = (params.jitter is not None
                     and 0.0 < params.jitter < 0.1)
        if jitter_on and params.generator == 'lcg':
            raise ValueError("jitter requires a sample stream; 'lcg' has none")
        if jitter_on and params.jitter_backend != 'host':
            raise ValueError(
                "the ensemble's jitter is the host stream all members share "
                "(as in the JAX ensemble, which has no device jitter): "
                "pass jitter_backend='host'")
        if jitter_on:
            jitter_mode = ('static' if params.generator == 'simplex'
                           else 'stream')
        else:
            jitter_mode = 'none'

        time_limit = None
        if params.time_max is not None and params.time_max > 0:
            time_limit = params.time_max * 60.0

        check_split_levels(params)
        # the physics scalars shared across members (Amr, delx, RT, ...)
        # do not depend on A0/A1/kappa: the step reads those per member
        # from the consts, so the unperturbed kappa is not derived here
        dp = params.deepcopy()
        if dp.kappa_tilde is None:
            dp.kappa_tilde = float(self.kappas[0])
        d = Derived.from_params(dp)
        transform = resolve_transform(params)
        inv_pairs = params.ozaki_inv_pairs
        self.cfg = StepConfig(
            N=N, dtype=params.precision,
            RT=d.RT, BRT=d.BRT, B=params.B,
            Amr=d.Amr, L=params.L, delx=d.delx, delx2=d.delx2,
            M_tilde=params.M_tilde, threshold=params.threshold,
            A0=d.A0, A1=d.A1, kappa_tilde=d.kappa_tilde,
            delt_base=params.delt, delt_max=params.delt_max,
            adaptive_time=params.adaptive_time,
            time_limit=time_limit, full_sim=params.full_sim,
            jitter=params.jitter if jitter_on else None,
            jitter_mode=jitter_mode,
            transform_backend=transform,
            split_levels=params.split_levels,
            ozaki_fold=transform == 'ozaki' and N % 2 == 0,
            ozaki_rfold_levels=_resolve_rfold_levels(params),
            ozaki_fwd_pairs=resolve_ozaki_fwd_pairs(params),
            # pin-only under the ensemble, as in the JAX package
            ozaki_inv_pairs=tuple(inv_pairs) if inv_pairs else None)

        self.chunk_size = max(1, int(params.chunk_size))
        if jitter_mode == 'stream':
            self.chunk_size = max(1, min(self.chunk_size,
                                         _JITTER_BUF_BYTES // (N * N * 8)))
        dct_ops.require_full_fp32()
        self._consts = make_members_consts(self.cfg, params.delt, self.A0s,
                                           self.A1s, self.kappas,
                                           device=self.device)
        # the simplex slab, drawn at first use (checkpoint.restore_ensemble
        # installs the saved stream after construction)
        self._static_jbuf = None
        self._states = None
        self.timedatas = [TimeData() for _ in range(self.R)]
        self._stop = np.zeros(self.R, dtype=np.int64)
        self._ckpt_extra = None

    # ------------------------------------------------------------------
    def prepare(self):
        N, R = self.params.N, self.R
        U0 = torch.as_tensor(self.U_init).to(device=self.device,
                                             dtype=self.cfg.tdtype)
        U0_b = U0.expand(R, N, N).contiguous()
        row0 = prepare_members_row0(self.cfg, self._consts, U0_b)
        E, E2, Ra, PS = torch.stack(row0).cpu().numpy()
        self._states = init_members_state(
            U0_b, self.params.delt, torch.as_tensor(E2), self.chunk_size,
            self.params.seed)
        self.timedatas = [TimeData() for _ in range(R)]
        for r in range(R):
            self.timedatas[r].insert(it=0, delt=self.params.delt, E=E[r],
                                     E2=E2[r], SA=0, domtime=0, Ra=Ra[r],
                                     L2=0, PS=PS[r])
        self._stop = np.zeros(R, dtype=np.int64)

    # ------------------------------------------------------------------
    def _ensure_generator(self) -> FieldGenerator:
        """Jitter needs a sample stream even when U_init was passed
        explicitly (e.g. by checkpoint.restore_ensemble, which installs
        the saved stream after construction)."""
        if self.generator is None:
            self.generator = FieldGenerator(
                self.params.generator, self.params.N, self.params.seed)
        return self.generator

    def _draw_jitter_buf(self, k: int):
        mode = self.cfg.jitter_mode
        if mode == 'stream':
            gen = self._ensure_generator()
            N = self.params.N
            slabs = np.empty((k, N, N), dtype=np.float64)
            for i in range(k):
                slabs[i] = gen.next_sample()
            return torch.as_tensor(slabs).to(device=self.device,
                                             dtype=self.cfg.tdtype)
        if mode == 'static':
            if self._static_jbuf is None:
                self._static_jbuf = torch.as_tensor(
                    self._ensure_generator().next_sample()).to(
                        device=self.device, dtype=self.cfg.tdtype)
            return self._static_jbuf
        return None

    def solve_or_resume(self, nsteps: Optional[int] = None, on_chunk=None,
                        preserve_stops: bool = False):
        """Run up to ``nsteps`` (reference entry semantics).  ``on_chunk``,
        if given, is called as ``on_chunk(self, states)`` after every
        chunk syncs.  ``preserve_stops=True`` keeps already-stopped
        members stopped (a checkpoint resume must not re-enter members
        whose early stop already fired); the default re-enters every
        member, as the reference's re-entry does."""
        if self._states is None:
            raise RuntimeError("call prepare() before solve_or_resume()")
        if nsteps is None:
            nsteps = max(self.params.ntmax, 0)
        computed = self._states.computed_steps.cpu().numpy()
        # entry semantics (a fresh solve runs nsteps-1 iterations, a
        # resume nsteps) are member 0's; a mix of fresh (== 1) and resumed
        # (> 1) members has no shared iteration count
        fresh = computed == 1
        if fresh.any() and not fresh.all():
            raise AssertionError(
                "ensemble members disagree on entry semantics: "
                f"computed_steps={computed.tolist()} mixes fresh (==1) and "
                "resumed members; re-run prepare() or resume all members")
        n_iters = nsteps - 1 if int(computed[0]) == 1 else nsteps
        n_iters = max(n_iters, 0)

        states = self._states
        # the reference recomputes the spectral image at every (re)entry
        states = states.replace(
            hat_U=entry_dct2(self.cfg, self._consts, states.U))
        if n_iters > 0 and not preserve_stops:
            states = states.replace(
                stop_reason=torch.zeros_like(states.stop_reason))
            self._stop = np.zeros(self.R, dtype=np.int64)
        elif preserve_stops:
            self._stop = states.stop_reason.cpu().numpy().astype(np.int64)

        while n_iters > 0 and np.any(self._stop == STOP_NONE):
            k = min(n_iters, self.chunk_size)
            states = run_members_chunk(self.cfg, self._consts, states, k,
                                       self._draw_jitter_buf(k))
            n_iters -= k
            states = self._sync(states)
            # publish the state before the hook: it sees the solver as it
            # is now
            self._states = states
            if on_chunk is not None:
                on_chunk(self, states)
        self._states = states
        return self.solutions()

    def _sync(self, states):
        """Per-chunk host sync: every member's new rows into its trace,
        the stop codes; NaN in a member raises."""
        f64 = torch.float64
        host = torch.stack([states.rows.to(f64),
                            states.stop_reason.to(f64)]).cpu().numpy()
        rows = host[0].astype(np.int64)
        stops = host[1].astype(np.int64)
        top = int(rows.max())
        if top > 0:
            # a copy: the device buffer is written in place by the next
            # chunk (and on the CPU .cpu() would alias it)
            bufs = states.rowbuf[:, :top].to('cpu', copy=True).numpy()
        for r in range(self.R):
            if rows[r] > 0:
                self.timedatas[r].insert_block(bufs[r, :rows[r]])
            if stops[r] == STOP_NAN:
                raise FloatingPointError(f"NaN in ensemble member {r}")
        self._stop = stops
        return states.replace(rows=torch.zeros_like(states.rows))

    # ------------------------------------------------------------------
    def solutions(self) -> Sequence[Solution]:
        s = self._states
        f64 = torch.float64
        host = torch.stack([s.computed_steps.to(f64), s.tau0, s.t0,
                            s.stop_reason.to(f64)]).cpu().numpy()
        sols = []
        for r in range(self.R):
            p = self.params.deepcopy()
            p.A0_const = float(self.A0s[r])
            p.A1_const = float(self.A1s[r])
            p.kappa_tilde = float(self.kappas[r])
            sol = Solution(p)
            sol.U = s.U[r]
            sol.timedata = self.timedatas[r]
            sol.computed_steps = int(host[0, r])
            sol.tau0 = float(host[1, r])
            sol.t0 = float(host[2, r])
            sol.stop_reason = STOP_STRINGS[int(host[3, r])]
            sols.append(sol)
        return sols
