"""The Cahn-Hilliard time step and the chunk runner.

Port of ``chsimpy_tpu/core/stepper.py`` for the slice the port runs: fixed
``delt``, the matmul DCT route, ``full_sim`` and the energy early stop, the
``time_max`` limit and the NaN guard.  One step does, in order:

  nonlinear term (kernel K1) -> forward 2-D DCT (torch.matmul)
  -> semi-implicit spectral update (K2) -> inverse 2-D DCT (torch.matmul)
  -> field sums (K3) and Σ|U − mean| (K4), finalized in float64
  -> timedata row and early-stop predicate.

The JAX package runs a chunk of steps in a ``lax.while_loop`` that exits at
the stop.  Here a chunk is a Python loop of a fixed number of steps that
never waits for the host: every per-step scalar is a 0-d device tensor.  The
stop is made exact by a device flag instead of an exit.  ``active`` (no
stop yet) and ``go`` (active and inside the time limit) are 0-d booleans;
every carried field is selected by them (``torch.where``), and the step and
row counters advance by ``go``.  After the trigger the rest of the chunk
computes steps whose results are thrown away, leaving ``U``, ``hat_U``, the
counters, the bookkeeping and the rows unchanged.  The row buffer is
written in place at index ``rows`` on every step; a discarded step's row
lands beyond the rows the host reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import coeffs as coeffs_ops
from ..ops import dct as dct_ops
from ..ops import kernels as K
from .state import (STOP_ENERGY, STOP_NAN, STOP_NONE, STOP_TIME_LIMIT,
                    SolverState)

_DTYPES = {'float32': torch.float32, 'float64': torch.float64}


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of the step (the fields of the JAX
    ``StepConfig`` that the slice uses)."""
    N: int
    dtype: str                  # 'float64' | 'float32'
    RT: float
    BRT: float
    B: float
    Amr: float
    L: float
    delx: float
    delx2: float
    M_tilde: float
    threshold: float
    A0: float = 0.0
    A1: float = 0.0
    kappa_tilde: float = 0.0
    time_limit: Optional[float] = None  # seconds of simulated time
    full_sim: bool = False

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def make_consts(cfg: StepConfig, delt: float, device='cpu') -> dict:
    """DCT matrix, eigenvalue grid and axis, update coefficient grids, and
    the physics scalars.  Built on the CPU with the JAX package's
    operations and order (float64 bit-identical to its ``make_consts``),
    then moved to ``device``."""
    dtype = cfg.tdtype
    kt = cfg.kappa_tilde
    leig = coeffs_ops.eigenvalues(cfg.N, dtype)
    CHeig, Seig = coeffs_ops.get_coefficients(
        leig, torch.tensor(kt, dtype=dtype), torch.tensor(delt, dtype=dtype),
        cfg.delx2)
    eaxis = torch.tensor(coeffs_ops.eigenvalue_axis(cfg.N), dtype=dtype)
    host = {'C': dct_ops.dct_matrix(cfg.N, dtype), 'leig': leig,
            'eaxis': eaxis, 'CHeig': CHeig, 'Seig': Seig}
    consts = {k: v.to(device) for k, v in host.items()}
    consts.update(A0=float(cfg.A0), A1=float(cfg.A1), kappa_tilde=float(kt))
    return consts


def _nonlinear_term(cfg: StepConfig, consts, U):
    """Shifted nonlinear chemical potential EnergieEut (kernel K1)."""
    return K.chemical_potential(U, cfg.RT, cfg.BRT, consts['A0'],
                                consts['A1'])


def _stats(cfg: StepConfig, consts, U, EnergieEut=None):
    """Energy functionals and field statistics from the five kernel sums
    (K3) and Σ|U − mean| (K4), finalized in float64 on the device as in
    ``_stats_fast``.  Returns (E, E2, PS, L2, Ra, SA), 0-d float64 tensors;
    ``EnergieEut=None`` (prepare path) gives L2 = 0."""
    N = cfg.N
    n2 = float(N * N)
    Lsq = cfg.L ** 2
    f64 = torch.float64
    sums = K.stats_sums(U, EnergieEut, consts['A0'], consts['A1'],
                        delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                        threshold=cfg.threshold)
    E2 = 0.5 * cfg.Amr * consts['kappa_tilde'] * Lsq * (sums[1] / n2)
    E = cfg.Amr * Lsq * (sums[0] / n2) + E2
    SA = sums[3] / n2
    L2 = torch.sqrt(sums[4]) / n2
    meanU = (sums[2] / n2).to(U.dtype)
    PS = K.absdev_sum(U, meanU) / n2
    # Ra: one mid row, O(N) — plain torch, as in the JAX package
    mid = U[N // 2 + 1, :]
    Ra = torch.mean(torch.abs(mid - torch.mean(mid))).to(f64)
    return E, E2, PS, L2, Ra, SA


def prepare_row0(cfg: StepConfig, consts, U):
    """Step-0 energies for prepare(): (E, E2, Ra, PS) as 0-d f64 tensors."""
    E, E2, PS, _, Ra, _ = _stats(cfg, consts, U, None)
    return E, E2, Ra, PS


def entry_dct2(U, consts):
    """Spectral image of U, recomputed at every solve entry."""
    return dct_ops.dct2(U, consts['C'])


def _step(cfg: StepConfig, consts, s: SolverState) -> SolverState:
    f64 = torch.float64
    active = s.stop_reason == STOP_NONE
    EnergieEut = _nonlinear_term(cfg, consts, s.U)

    # time accumulation; the limit stops BEFORE the field update
    delt = s.delt
    tds = s.time_delta_sum + delt
    time_passed = tds / cfg.M_tilde
    if cfg.time_limit is None:
        over = None
        go = active
    else:
        over = time_passed > cfg.time_limit
        go = active & ~over

    # semi-implicit spectral update, eq. (12) of Ghiass et al. (2016)
    hat_E = dct_ops.dct2(EnergieEut, consts['C'])
    hat_U = K.spectral_update(s.hat_U, hat_E, consts['Seig'],
                              consts['CHeig'])
    U = dct_ops.idct2(hat_U, consts['C'])

    E, E2, PS, L2, Ra, SA = _stats(cfg, consts, U, EnergieEut)
    domtime = time_passed ** (1.0 / 3.0)
    it = s.computed_steps  # the row stores the pre-increment count
    row = torch.stack([it.to(f64), E, E2, SA, domtime, Ra, L2, PS, delt])
    s.rowbuf.index_copy_(0, s.rows.view(1), row.view(1, 9))
    steps_new = it + 1

    # NaN health guard
    has_nan = torch.isnan(row).any()

    # early-stop predicate E2[it-1] > E2[it] > E2[0]
    falls = (s.E2_prev > E2) & (E2 > s.E2_first)
    trigger = falls & ~s.skip_check
    fire = go & trigger
    if cfg.full_sim:
        skip_check = s.skip_check | fire
        stop = torch.full_like(s.stop_reason, STOP_NONE)
    else:
        skip_check = s.skip_check
        stop = torch.where(trigger, STOP_ENERGY, STOP_NONE)
    stop = torch.where(has_nan, STOP_NAN, stop)
    stop = torch.where(go, stop, s.stop_reason)
    if over is not None:
        stop = torch.where(active & over, STOP_TIME_LIMIT, stop)

    return s.replace(
        U=torch.where(go, U, s.U),
        hat_U=torch.where(go, hat_U, s.hat_U),
        time_delta_sum=torch.where(active, tds, s.time_delta_sum),
        computed_steps=s.computed_steps + go,
        skip_check=skip_check,
        stop_reason=stop.to(s.stop_reason.dtype),
        tau0=torch.where(fire, steps_new.to(f64), s.tau0),
        t0=torch.where(fire, time_passed, s.t0),
        E2_prev=torch.where(go, E2, s.E2_prev),
        rows=s.rows + go)


def run_chunk(cfg: StepConfig, consts, state: SolverState,
              n_iters: int) -> SolverState:
    """``n_iters`` steps with no host sync; steps after a stop leave the
    state unchanged (see the module docstring)."""
    for _ in range(n_iters):
        state = _step(cfg, consts, state)
    return state
