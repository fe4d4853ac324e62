"""Device-resident solver state.

The fields of ``chsimpy_tpu/core/state.py`` as torch tensors on the run's
device: the concentration field and its spectral image, the scalar
time/step counters and early-stop bookkeeping as 0-d tensors (so a chunk of
steps never waits for the host), and a chunk-local timedata row buffer.
The JAX package's ``rng_key`` belongs to the device jitter, which is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

# stop_reason codes (host maps to the reference's strings)
STOP_NONE = 0
STOP_ENERGY = 1      # 'energy'
STOP_TIME_LIMIT = 2  # 'time-limit'
STOP_NAN = 3         # NaN health guard

STOP_STRINGS = {STOP_NONE: 'None', STOP_ENERGY: 'energy',
                STOP_TIME_LIMIT: 'time-limit', STOP_NAN: 'nan'}


@dataclass(frozen=True)
class SolverState:
    U: torch.Tensor               # (N, N) concentration field
    hat_U: torch.Tensor           # (N, N) DCT-II of U
    delt: torch.Tensor            # f64, current time step
    time_delta_sum: torch.Tensor  # f64
    computed_steps: torch.Tensor  # int64 (includes the prepare() row)
    skip_check: torch.Tensor      # bool: full_sim passed its first fall
    stop_reason: torch.Tensor     # int64, STOP_* code
    tau0: torch.Tensor            # f64: step count at first energy fall
    t0: torch.Tensor              # f64: sim-time [s] at first energy fall
    E2_first: torch.Tensor        # f64: E2 of row 0 (prepare)
    E2_prev: torch.Tensor         # f64: E2 of the previous inserted row
    rows: torch.Tensor            # int64: rows written into rowbuf
    rowbuf: torch.Tensor          # (chunk_cap, 9) f64 timedata rows

    def replace(self, **kw) -> 'SolverState':
        return replace(self, **kw)


def init_state(U0: torch.Tensor, hat_U0: torch.Tensor, delt: float,
               E2_first: float, chunk_cap: int) -> SolverState:
    dev = U0.device

    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def i64(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)

    return SolverState(
        U=U0,
        hat_U=hat_U0,
        delt=f64(delt),
        time_delta_sum=f64(0.0),
        computed_steps=i64(1),
        skip_check=torch.tensor(False, device=dev),
        stop_reason=i64(STOP_NONE),
        tau0=f64(0.0),
        t0=f64(0.0),
        E2_first=f64(E2_first),
        E2_prev=f64(E2_first),
        rows=i64(0),
        rowbuf=torch.zeros((chunk_cap, 9), dtype=torch.float64, device=dev),
    )
