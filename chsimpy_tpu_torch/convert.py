"""Carry the JAX package's parameters, constants and state into the port.

Each function takes plain Python or numpy values (what
``np.asarray``/``float`` make of the JAX objects), so this module imports
neither jax nor ``chsimpy_tpu``:

* :func:`consts_from_jax` — the output of ``chsimpy_tpu.core.stepper.
  make_consts`` (C, leig, CHeig, Seig, eaxis, A0, A1, kappa_tilde, the
  ozaki route's int8 slice stacks Cs, CsT, CeS, CoS, CeTS, CoTS and rf,
  and the split route's block tree), and the Sobol jitter's sobol_sv,
  sobol_shift and sobol_base where the JAX solver added them;
* :func:`split_tree_from_jax` — a split block tree (``chsimpy_tpu.ops.dct.
  split_tree``) as nested tensors;
* :func:`state_from_jax` — the fields of a ``chsimpy_tpu`` ``SolverState``
  (a folded solver's field in the natural layout, as the JAX checkpoint
  writes it, with ``folded=True``);
* :func:`params_from_jax` — ``chsimpy_tpu.Parameters.scalar_dict()``, the
  float32 knobs included, refusing what the port does not run
  (``kernel_backend='pallas'``, ``spectral_bf16``);
* :func:`members_consts_from_jax` and :func:`members_state_from_jax` —
  the ensemble's batched consts (A0, A1, kappa_tilde (R,) and CHeig
  (R, N, N) beside the shared operands) and its batched state (every leaf
  with a leading member axis), as ``chsimpy_tpu.ensemble.EnsembleSolver``
  holds them.

A generator's stream position carries across as plain data:
``chsimpy_tpu.rng.FieldGenerator.state_dict()`` restores in
:meth:`chsimpy_tpu_torch.rng.FieldGenerator.from_state`.

With ``mesh`` (a :class:`~chsimpy_tpu_torch.parallel.mesh.GridMesh`) the
consts and the state come out as this rank's blocks: a sharded JAX array
read with ``np.asarray`` is whole, and each rank keeps its block of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.state import SolverState, jax_prng_key, key_tensor
from .parallel.sharding import shard_consts, shard_state
from .params import Parameters, check_solver_scope

_CONST_ARRAYS = ('C', 'leig', 'CHeig', 'Seig', 'eaxis')
# int8 slice stacks of the ozaki routes (empty on the other routes)
_CONST_SLICES = ('Cs', 'CsT', 'CeS', 'CoS', 'CeTS', 'CoTS')
_CONST_SCALARS = ('A0', 'A1', 'kappa_tilde')
_CONST_SOBOL = ('sobol_sv', 'sobol_shift', 'sobol_base')
_STATE_F64 = ('delt', 'time_delta_sum', 'tau0', 't0', 'E2_first', 'E2_prev')
_STATE_INT = ('computed_steps', 'stop_reason', 'rows')


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def split_tree_from_jax(tree, device='cpu'):
    """The port's split block tree from the JAX one: the same nesting of
    (even subtree, odd block) pairs, each block a float tensor of the
    block's own type.  An empty tree (a route without one) stays ()."""
    if isinstance(tree, tuple):
        return tuple(split_tree_from_jax(t, device) for t in tree)
    return _tensor(tree, device)


def consts_from_jax(d: dict, device='cpu', mesh=None) -> dict:
    """The port's consts dict from the numpy form of the JAX consts.  The
    ozaki stacks and the split tree may be left out (a matmul-route dict):
    they are then empty; ``rf`` is a sequence of (block, block^T)
    stacks.  With ``mesh``, the grids are this rank's blocks."""
    consts = {k: _tensor(d[k], device) for k in _CONST_ARRAYS}
    empty = np.zeros((0,), np.int8)
    consts.update({k: _tensor(d.get(k, empty), device, torch.int8)
                   for k in _CONST_SLICES})
    consts['rf'] = tuple((_tensor(b, device, torch.int8),
                          _tensor(bt, device, torch.int8))
                         for b, bt in d.get('rf', ()))
    consts['tree'] = split_tree_from_jax(d.get('tree', ()), device)
    consts.update({k: float(np.asarray(d[k])) for k in _CONST_SCALARS})
    # the device_sobol jitter's tables and draw base (uint32 in JAX),
    # int64 here
    consts.update({k: _tensor(np.asarray(d[k]).astype(np.int64), device)
                   for k in _CONST_SOBOL if k in d})
    return consts if mesh is None else shard_consts(consts, mesh)


def _natural(U, folded: bool):
    """A field (or a stack) from a JAX state's layout: ``folded`` (a JAX
    solver with ``fold_field``) holds it level-1 folded; the fold is an
    involution, as the JAX package's ``_field_natural`` uses it."""
    if not folded:
        return U
    from .ops.dct import fold1
    return fold1(torch.as_tensor(np.array(U))).numpy()


def state_from_jax(d: dict, device='cpu', mesh=None,
                   folded: bool = False) -> SolverState:
    """The port's SolverState from the numpy form of the JAX state (its
    ``rng_key``, the device jitter's threefry key, carried as the port
    holds it; PRNGKey(0) where ``d`` has none, as for a run without that
    jitter).  With ``mesh``, U and hat_U are this rank's blocks.
    ``folded``: the JAX solver ran ``fold_field``; U comes out in the
    natural layout (the JAX checkpoint's), hat_U as it is (the spectral
    image is the same in both layouts)."""
    kw = {'U': _tensor(_natural(np.asarray(d['U']), folded), device),
          'hat_U': _tensor(d['hat_U'], device),
          'skip_check': _tensor(bool(np.asarray(d['skip_check'])), device),
          'rowbuf': _tensor(d['rowbuf'], device, torch.float64),
          'rng_key': key_tensor(d.get('rng_key', jax_prng_key(0)), device)}
    kw.update({k: _tensor(d[k], device, torch.float64) for k in _STATE_F64})
    kw.update({k: _tensor(d[k], device, torch.int64) for k in _STATE_INT})
    state = SolverState(**kw)
    return state if mesh is None else shard_state(state, mesh)


def members_consts_from_jax(d: dict, device='cpu') -> dict:
    """The ensemble's consts (``EnsembleSolver._consts`` of the port) from
    the numpy form of the JAX ensemble's: the member scalars as (R,)
    float64 tensors, CHeig (R, N, N), the rest as :func:`consts_from_jax`
    makes it."""
    consts = consts_from_jax({**d, **{k: 0.0 for k in _CONST_SCALARS}},
                             device)
    consts.update({k: _tensor(d[k], device, torch.float64)
                   for k in _CONST_SCALARS})
    consts['members'] = torch.arange(consts['A0'].shape[0], device=device)
    return consts


def members_state_from_jax(d: dict, device='cpu',
                           folded: bool = False) -> SolverState:
    """The ensemble's state from the numpy form of the JAX ensemble's
    (``EnsembleSolver._states``: every leaf with a leading member axis,
    ``rng_key`` (R, 2) included where ``d`` has it); ``folded`` as
    :func:`state_from_jax`."""
    kw = {'U': _tensor(_natural(np.asarray(d['U']), folded), device),
          'hat_U': _tensor(d['hat_U'], device),
          'skip_check': _tensor(np.asarray(d['skip_check'], dtype=bool),
                                device),
          'rowbuf': _tensor(d['rowbuf'], device, torch.float64),
          'rng_key': key_tensor(d.get('rng_key', np.tile(
              jax_prng_key(0), (len(d['delt']), 1))), device)}
    kw.update({k: _tensor(d[k], device, torch.float64) for k in _STATE_F64})
    kw.update({k: _tensor(d[k], device, torch.int64) for k in _STATE_INT})
    return SolverState(**kw)


def params_from_jax(scalar_dict: dict, device='cuda') -> Parameters:
    """Port Parameters from a JAX ``scalar_dict``; raises
    NotImplementedError for the settings the port does not run
    (``kernel_backend='pallas'``, ``spectral_bf16``) and ValueError for
    unknown keys."""
    names = {f.name for f in dataclasses.fields(Parameters)}
    unknown = sorted(set(scalar_dict) - names)
    if unknown:
        raise ValueError(f"unknown parameter fields: {unknown}")
    p = Parameters()
    for k, v in scalar_dict.items():
        if k == 'version':
            continue
        if k in ('mesh_shape', 'ozaki_fwd_pairs', 'ozaki_inv_pairs') \
                and v is not None:
            v = tuple(v)
        setattr(p, k, v)
    p.device = device
    check_solver_scope(p)
    return p
