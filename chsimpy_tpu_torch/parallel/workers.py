"""What a world started by :func:`~.distributed.spawn_grid` runs.

A spawned rank imports these functions by name (never a test file's, so a
rank imports no jax).  :func:`run_tasks` runs a list of ``(name, kwargs)``
tasks in order on every rank and returns one result per task; fields come
in whole (numpy, the same on every rank) and go back whole, so a caller
can hold the world's results against a single-device or JAX run.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.solver import Solver
from ..ops import dct as dct_ops
from ..ops import kernels as K
from ..params import Parameters
from ..simulator import Simulator
from .sharding import block_slices, gather_field, shard_field

_DTYPES = {'float32': torch.float32, 'float64': torch.float64}


def _sync(mesh) -> None:
    if mesh.device.type == 'cuda':
        torch.cuda.synchronize()


def _block(mesh, a, dtype):
    t = torch.as_tensor(np.asarray(a)).to(device=mesh.device,
                                          dtype=_DTYPES[dtype])
    return shard_field(t, mesh)[0]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def solve(mesh, params: dict, U_init=None, steps=None, rate_steps=0,
          return_U=True) -> dict:
    """A grid-sharded solve of ``Parameters(**params)`` on this world's
    mesh shape and backend: through ``Simulator.solve`` (``steps`` None),
    or ``Solver.prepare`` and ``solve_or_resume(steps)``; then, with
    ``rate_steps``, one timed window of that many more steps.  The params'
    device must be the world's.  Returns the solution's scalars, its
    timedata, mean(U) (and U with ``return_U``), this rank's kernel
    launches and the seconds of the solve."""
    p = Parameters(**params)
    if torch.device(p.device).type != mesh.device.type:
        raise ValueError(f"params ask for device {p.device!r}, the world "
                         f"runs on {mesh.device.type!r}")
    p.mesh_shape = mesh.shape
    p.dist_backend = mesh.backend
    p.no_gui = True
    K.reset_launches()
    t0 = time.perf_counter()
    if steps is None:
        sim = Simulator(p, U_init)
        solver = sim.solver
        sol = sim.solve()
    else:
        solver = Solver(p, U_init)
        solver.prepare()
        sol = solver.solve_or_resume(steps)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    out = {'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0, 't0': sol.t0,
           'timedata': sol.timedata.data(),
           'U_mean': sol.U.double().mean().item(),
           'U_finite': bool(torch.isfinite(sol.U).all()),
           'U_shape': tuple(sol.U.shape),
           'launches': dict(K.launches), 'seconds': seconds,
           'mesh': mesh.describe()}
    if return_U:
        out['U'] = _np(sol.U)
    if rate_steps:
        _sync(mesh)
        t0 = time.perf_counter()
        solver.solve_or_resume(rate_steps)
        _sync(mesh)
        out['steps_per_s'] = rate_steps / (time.perf_counter() - t0)
    return out


def fused_stats(mesh, U, E, dtype: str, phys: dict) -> list:
    """``fused_stats_sharded`` of the whole fields U and E (E None: the
    prepare path) on this mesh: [E, E2, PS, L2, Ra, SA]."""
    Ub = _block(mesh, U, dtype)
    Eb = None if E is None else _block(mesh, E, dtype)
    res = K.fused_stats_sharded(
        mesh, Ub, Eb, phys['A0'], phys['A1'], phys['kappa_tilde'],
        delx=phys['delx'], RT=phys['RT'], B=phys['B'], Amr=phys['Amr'],
        L=phys['L'], threshold=phys['threshold'])
    return [t.item() for t in res]


def chemical_potential(mesh, U, dtype: str, phys: dict) -> np.ndarray:
    """``chemical_potential_sharded`` on this rank's block of U, gathered
    whole."""
    out = K.chemical_potential_sharded(mesh, _block(mesh, U, dtype),
                                       phys['RT'], phys['BRT'], phys['A0'],
                                       phys['A1'])
    return _np(gather_field(out, mesh))


def dcts(mesh, U, dtype: str) -> tuple:
    """(dct2_grid(U), idct2_grid(U)), gathered whole."""
    C = dct_ops.dct_matrix(np.asarray(U).shape[0], _DTYPES[dtype],
                           mesh.device)
    Ub = _block(mesh, U, dtype)
    return (_np(gather_field(dct_ops.dct2_grid(Ub, C, mesh), mesh)),
            _np(gather_field(dct_ops.idct2_grid(Ub, C, mesh), mesh)))


def threefry_jitter(mesh, U, key, jitter: float, dtype: str) -> tuple:
    """K10 (``ops/kernels.py`` ``threefry_jitter``) on this rank's block
    of the whole field U with the key ``key`` (uint32 words): (the field
    with the jitter, gathered whole; the next key)."""
    N = np.asarray(U).shape[0]
    Ub = _block(mesh, U, dtype)
    k = torch.as_tensor(np.asarray(key, dtype=np.int64), device=mesh.device)
    out = torch.empty_like(k)
    rows, cols = block_slices(mesh, N)
    K.threefry_jitter(Ub, k, out, jitter, N, rows.start, cols.start)
    return _np(gather_field(Ub, mesh)), _np(out)


def live_solve(mesh, params: dict, file_id: str, update_every: int) -> dict:
    """The live loop on this world: ``Simulator.solve`` with ``png`` and
    ``update_every`` (files named from ``file_id``, a path), then
    ``render``; beside it a Solver of the same world entered at the same
    boundaries.  Returns whether this rank built a view, both runs' rows
    and gathered fields, and the loop's chunk count."""
    p = Parameters(**params)
    p.mesh_shape = mesh.shape
    p.dist_backend = mesh.backend
    p.no_gui, p.png, p.update_every, p.file_id = True, True, update_every, \
        file_id
    sim = Simulator(p)
    sol = sim.solve()
    sim.render()
    q = Parameters(**params)
    q.mesh_shape, q.dist_backend, q.no_gui = mesh.shape, mesh.backend, True
    ref = Solver(q)
    ref.prepare()
    done = 0
    while done < q.ntmax:
        k = min(update_every, q.ntmax - done)
        ref.solve_or_resume(k)
        done += k
    return {'view': sim.view is not None, 'steps_total': sim.steps_total,
            'computed_steps': sol.computed_steps, 'tau0': sol.tau0,
            'timedata': sol.timedata.data(), 'U': _np(sol.U),
            'ref_timedata': ref.solution.timedata.data(),
            'ref_U': _np(ref.solution.U)}


def imported(mesh) -> list:
    """The top-level packages this rank has imported (a rank of the
    port imports no jax)."""
    return sorted({m.split('.')[0] for m in sys.modules})


TASKS = {'solve': solve, 'fused_stats': fused_stats,
         'chemical_potential': chemical_potential, 'dcts': dcts,
         'threefry_jitter': threefry_jitter, 'imported': imported,
         'live_solve': live_solve}


def run_tasks(mesh, tasks) -> list:
    """Run each ``(name, kwargs)`` of ``tasks`` in order; their results."""
    return [TASKS[name](mesh, **kw) for name, kw in tasks]
