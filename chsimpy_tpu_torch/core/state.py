"""Device-resident solver state.

The fields of ``chsimpy_tpu/core/state.py`` as torch tensors on the run's
device: the concentration field and its spectral image, the scalar
time/step counters and early-stop bookkeeping as 0-d tensors (so a chunk of
steps never waits for the host), a chunk-local timedata row buffer, and
``rng_key``, the ``device`` jitter's threefry key: ``jax.random.PRNGKey
(seed)``'s two uint32 words in an int64 tensor on the run's device, split
on the card at every step of that mode (kernel K10).

The ensemble (``ensemble.py``) carries the same dataclass with a leading
member axis, as the JAX package's ``vmap`` batches every leaf: fields
(R, N, N), counters and stop bookkeeping (R,), ``rowbuf`` (R, cap, 9)
(:func:`init_members_state`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
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
    rng_key: torch.Tensor         # (2,) int64: the device jitter's key

    def replace(self, **kw) -> 'SolverState':
        return replace(self, **kw)


def jax_prng_key(seed: int) -> np.ndarray:
    """``np.asarray(jax.random.PRNGKey(seed))`` under 64-bit JAX: the
    threefry key [seed >> 32, seed & 0xFFFFFFFF] of the seed's two's
    complement 64-bit word, as uint32."""
    s = int(seed) % (1 << 64)
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def key_tensor(key, device) -> torch.Tensor:
    """A threefry key (uint32 words, any leading shape) as the state's
    int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(key, dtype=np.uint32).astype(
        np.int64)).to(device)


def init_state(U0: torch.Tensor, hat_U0: torch.Tensor, delt: float,
               E2_first: float, chunk_cap: int, seed: int) -> SolverState:
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
        rng_key=key_tensor(jax_prng_key(seed), dev),
    )


def init_members_state(U0: torch.Tensor, delt: float, E2_first: torch.Tensor,
                       chunk_cap: int, seed: int) -> SolverState:
    """The state of R members from their fields U0 (R, N, N) and their
    row-0 E2 (R,): every leaf of :func:`init_state` with a leading member
    axis, each its own buffer (the key the same for every member, as the
    JAX package's vmapped state holds it; the ensemble draws no device
    jitter)."""
    dev = U0.device
    R = U0.shape[0]
    f64 = torch.float64

    def full(x, dtype):
        return torch.full((R,), x, dtype=dtype, device=dev)

    E2 = E2_first.to(device=dev, dtype=f64)
    return SolverState(
        U=U0,
        hat_U=torch.zeros_like(U0),
        delt=full(delt, f64),
        time_delta_sum=full(0.0, f64),
        computed_steps=full(1, torch.int64),
        skip_check=full(False, torch.bool),
        stop_reason=full(STOP_NONE, torch.int64),
        tau0=full(0.0, f64),
        t0=full(0.0, f64),
        E2_first=E2.clone(),
        E2_prev=E2.clone(),
        rows=full(0, torch.int64),
        rowbuf=torch.zeros((R, chunk_cap, 9), dtype=f64, device=dev),
        rng_key=key_tensor(np.tile(jax_prng_key(seed), (R, 1)), dev),
    )
