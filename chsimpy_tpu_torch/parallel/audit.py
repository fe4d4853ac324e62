"""Collective audit of the sharded step.

Counterpart of ``chsimpy_tpu/parallel/audit.py``.  The JAX audit compiles
the grid-sharded chunk runner and reads the collectives XLA inserted from
its HLO, with each one's result shape.  The port has no compiled program
to read: its collectives are the calls of :mod:`.collectives`, which count
themselves (``collectives.traffic``: calls and result bytes a kind, under
the names of the XLA collectives they stand for).  So this audit runs a
chunk of steps on every rank of a world and reads the counts of rank 0
(every rank of a grid issues the same collectives).  What differs from
the JAX audit:

* the counts are of a run, divided by its steps: a step's collectives,
  where the HLO lists a loop body's once;
* the port's rank-order sums move the ranks' partials with an all-gather
  (``gather_world``); they are counted as ``'all-reduce'``, the
  collective that carries them in the JAX program, with their gathered
  bytes;
* the inverse ozaki transform's DC entry rides the slices' all-reduce
  MAX, so it has no collective of its own;
* an ensemble's chunk (:func:`audit_ensemble_chunk`) counts the host
  sync that ends it, where the JAX program's while_loop predicate is a
  collective of every step.

``python -m chsimpy_tpu_torch.parallel.audit -N 64 --mesh 2x2 --transform
split --device cpu`` prints the result as JSON (the JAX package's ``python
-m chsimpy_tpu.parallel.audit``).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import collectives as coll


def _counts(steps: int, field_bytes: int) -> dict:
    """The JAX audit's keys from ``collectives.traffic`` divided by
    ``steps``, and the calls and the bytes received from other ranks."""
    per_op = {op: v[1] // steps for op, v in coll.traffic.items()}
    calls = {op: v[0] // steps for op, v in coll.traffic.items()}
    largest = max(v[2] for v in coll.traffic.values())
    wire = {op: v[3] // steps for op, v in coll.traffic.items()}
    return {'per_op_bytes': per_op, 'per_op_calls': calls,
            'total_bytes': int(sum(per_op.values())),
            'field_bytes': int(field_bytes),
            'max_single_collective_bytes': int(largest),
            'n_collectives': int(sum(calls.values())),
            'per_op_wire_bytes': wire,
            'total_wire_bytes': int(sum(wire.values()))}


def count_chunk(solver, steps: int = 2) -> dict:
    """Count this rank's collectives over one chunk of ``steps`` steps of
    a prepared (or solved) sharded ``solver``, entered as a solve enters
    (the spectral image recomputed first, not counted): the JAX audit's
    keys, per step (``per_op_bytes``, ``total_bytes``,
    ``max_single_collective_bytes``, ``n_collectives``; ``field_bytes``
    is the whole field's), and ``per_op_calls`` and the bytes received
    from other ranks (``per_op_wire_bytes``, ``total_wire_bytes``)."""
    from ..core.stepper import entry_dct2, run_chunk
    state = solver._state
    state = state.replace(hat_U=entry_dct2(solver.cfg, solver._consts,
                                           state.U, solver.mesh))
    coll.reset_traffic()
    run_chunk(solver.cfg, solver._consts, state, steps, solver.mesh)
    if solver.device.type == 'cuda':
        torch.cuda.synchronize()
    N = solver.cfg.N
    item = torch.empty((), dtype=solver.cfg.tdtype).element_size()
    return {**_counts(steps, N * N * item), 'steps': steps,
            'pencil': bool(solver.cfg.pencil),
            'transform': solver.cfg.transform_backend}


def count_ensemble_chunk(ens, steps: int = 4) -> dict:
    """:func:`count_chunk` for a prepared ensemble ``ens``: this rank's
    collectives over one chunk of ``steps`` member steps and the host
    sync that ends it (the JAX audit's keys for the chunk, and
    ``bytes_per_step``).  On an ('ens',)-only mesh the members
    step without a collective; what crosses the ens axis is the sync's
    gather of every member's rows, stop and row count (the counterpart
    of the JAX program's vmapped while_loop predicate, "any member
    active"): bytes of the scalar class, the same at every N."""
    from ..core.stepper import entry_dct2, run_members_chunk
    states = ens._states.replace(hat_U=entry_dct2(
        ens.cfg, ens._consts, ens._states.U, ens._grid))
    coll.reset_traffic()
    states = run_members_chunk(ens.cfg, ens._consts, states, steps,
                               ens._draw_jitter_buf(steps), ens._grid)
    ens._sync(states)
    if ens.device.type == 'cuda':
        torch.cuda.synchronize()
    N = ens.cfg.N
    item = torch.empty((), dtype=ens.cfg.tdtype).element_size()
    out = _counts(1, N * N * item)
    return {**out, 'steps': steps,
            'bytes_per_step': out['total_bytes'] / steps,
            'members': ens.R, 'transform': ens.cfg.transform_backend}


def audit_chunk(mesh, N: int, precision: str = 'float32',
                transform: str = None, steps: int = 2) -> dict:
    """:func:`count_chunk` of a fresh solve on this world's mesh."""
    from ..core.solver import Solver
    from ..params import Parameters

    p = Parameters(N=N, precision=precision, mesh_shape=tuple(mesh.shape),
                   dist_backend=mesh.backend, no_gui=True,
                   device=mesh.device.type,
                   kappa_tilde=2.98911291966116e-4)
    if transform:
        p.transform_backend = transform
    solver = Solver(p)
    solver.prepare()
    return count_chunk(solver, steps)


def audit_ensemble(mesh, N: int, precision: str = 'float32',
                   steps: int = 4) -> dict:
    """:func:`count_ensemble_chunk` of a fresh ensemble of one member per
    ens slot (the JAX audit's (A0, A1) pairs, kappa_tilde pinned) on this
    world's mesh."""
    import numpy as np

    from .. import material
    from ..ensemble import EnsembleSolver
    from ..params import Parameters

    p = Parameters(N=N, precision=precision, no_gui=True,
                   device=mesh.device.type, dist_backend=mesh.backend,
                   kappa_tilde=2.98911291966116e-4)
    A0, A1 = material.A0(p.temp), material.A1(p.temp)
    pairs = np.array([[A0 * (1 + 0.0005 * i), A1 * (1 - 0.0005 * i)]
                      for i in range(mesh.n_ens)])
    ens = EnsembleSolver(p, pairs, mesh=mesh)
    ens.prepare()
    return count_ensemble_chunk(ens, steps)


def audit_ensemble_chunk(N: int = 256, n_ens: int = 8,
                         precision: str = 'float32', steps: int = 4,
                         device: str = 'cuda', backend: str = None,
                         timeout: float = 300.0, threads: int = 1) -> dict:
    """The collectives of an ensemble chunk sharded over an
    ('ens',)-only mesh of ``n_ens`` ranks, one member each, on a new
    world on the card (``device='cpu'``: gloo ranks on the host): rank
    0's :func:`count_ensemble_chunk` (the JAX package's
    ``audit_ensemble_chunk``, ``chsimpy_tpu/parallel/audit.py:115-160``).
    Expected: bytes of the scalar class, the ens axis moves no field."""
    from .distributed import spawn_world
    from .workers import run_tasks
    out = spawn_world(run_tasks, (n_ens, 1, 1), backend=backend,
                      device=device, timeout=timeout, threads=threads,
                      args=([('audit_ensemble', dict(
                          N=N, precision=precision, steps=steps))],))
    return out[0][0]


def audit_sharded_chunk(N: int = 256, mesh_shape=(2, 4),
                        precision: str = 'float32', transform: str = None,
                        steps: int = 2, device: str = 'cuda',
                        backend: str = None, timeout: float = 300.0,
                        threads: int = 1) -> dict:
    """:func:`audit_chunk` on a new world of ``mx*my`` ranks on the card
    (``device='cpu'``: gloo ranks on the host); rank 0's result."""
    from .distributed import spawn_grid
    from .workers import run_tasks
    out = spawn_grid(run_tasks, tuple(mesh_shape), backend=backend,
                     device=device, timeout=timeout, threads=threads,
                     args=([('audit', dict(N=N, precision=precision,
                                           transform=transform,
                                           steps=steps))],))
    return out[0][0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.parallel.audit',
        description='Bytes a step of the sharded solve moves, by '
                    'collective, on rank 0 of a new world.')
    ap.add_argument('-N', type=int, default=256)
    ap.add_argument('--mesh', default='2x2')
    ap.add_argument('--precision', default='float32')
    ap.add_argument('--transform', default=None)
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dist-backend', default=None)
    ap.add_argument('--ensemble', type=int, default=None, metavar='E',
                    help="audit an ensemble chunk on an ('ens',)-only "
                         "mesh of E ranks instead (--mesh is ignored)")
    a = ap.parse_args(argv)
    if a.ensemble:
        res = audit_ensemble_chunk(a.N, a.ensemble, a.precision,
                                   max(a.steps, 1), a.device,
                                   a.dist_backend)
    else:
        shape = tuple(int(v) for v in a.mesh.lower().split('x'))
        res = audit_sharded_chunk(a.N, shape, a.precision, a.transform,
                                  a.steps, a.device, a.dist_backend)
    json.dump(res, sys.stdout, indent=1)
    print()


if __name__ == '__main__':
    main()
