"""Carry the JAX package's parameters, constants and state into the port.

Each function takes plain Python or numpy values (what
``np.asarray``/``float`` make of the JAX objects), so this module imports
neither jax nor ``chsimpy_tpu``:

* :func:`consts_from_jax` — the output of ``chsimpy_tpu.core.stepper.
  make_consts`` (C, leig, CHeig, Seig, eaxis, A0, A1, kappa_tilde);
* :func:`state_from_jax` — the fields of a ``chsimpy_tpu`` ``SolverState``;
* :func:`params_from_jax` — ``chsimpy_tpu.Parameters.scalar_dict()``,
  refusing what the port does not run yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.state import SolverState
from .params import Parameters, check_solver_scope

_CONST_ARRAYS = ('C', 'leig', 'CHeig', 'Seig', 'eaxis')
_CONST_SCALARS = ('A0', 'A1', 'kappa_tilde')
_STATE_F64 = ('delt', 'time_delta_sum', 'tau0', 't0', 'E2_first', 'E2_prev')
_STATE_INT = ('computed_steps', 'stop_reason', 'rows')


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def consts_from_jax(d: dict, device='cpu') -> dict:
    """The port's consts dict from the numpy form of the JAX consts."""
    consts = {k: _tensor(d[k], device) for k in _CONST_ARRAYS}
    consts.update({k: float(np.asarray(d[k])) for k in _CONST_SCALARS})
    return consts


def state_from_jax(d: dict, device='cpu') -> SolverState:
    """The port's SolverState from the numpy form of the JAX state (its
    ``rng_key`` belongs to the device jitter and is dropped)."""
    kw = {'U': _tensor(d['U'], device), 'hat_U': _tensor(d['hat_U'], device),
          'skip_check': _tensor(bool(np.asarray(d['skip_check'])), device),
          'rowbuf': _tensor(d['rowbuf'], device, torch.float64)}
    kw.update({k: _tensor(d[k], device, torch.float64) for k in _STATE_F64})
    kw.update({k: _tensor(d[k], device, torch.int64) for k in _STATE_INT})
    return SolverState(**kw)


def params_from_jax(scalar_dict: dict, device='cuda') -> Parameters:
    """Port Parameters from a JAX ``scalar_dict``; raises
    NotImplementedError for settings the port does not run yet (a mesh,
    the ozaki transform, ...) and ValueError for unknown keys."""
    names = {f.name for f in dataclasses.fields(Parameters)}
    unknown = sorted(set(scalar_dict) - names)
    if unknown:
        raise ValueError(f"unknown parameter fields: {unknown}")
    p = Parameters()
    for k, v in scalar_dict.items():
        if k == 'version':
            continue
        if k == 'mesh_shape' and v is not None:
            v = tuple(v)
        setattr(p, k, v)
    p.device = device
    check_solver_scope(p)
    return p
