"""What a world started by :func:`~.distributed.spawn_grid` or
:func:`~.distributed.spawn_world` runs.

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
    or ``Solver.prepare`` and ``solve_or_resume(steps)`` (a list: one
    entry per item, in turn); then, with
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
        for k in (steps if isinstance(steps, (list, tuple)) else [steps]):
            sol = solver.solve_or_resume(k)
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


def _ensemble_out(ens, sols, seconds=None, return_U=True) -> dict:
    """Every member's scalars, rows, mean(U) and (``return_U``) field
    (numpy), the rank's kernel launches and, with ``seconds``, the
    solve's time."""
    out = {'computed_steps': [s.computed_steps for s in sols],
           'stop_reason': [s.stop_reason for s in sols],
           'tau0': [s.tau0 for s in sols], 't0': [s.t0 for s in sols],
           'timedata': [s.timedata.data() for s in sols],
           'U_mean': [s.U.double().mean().item() for s in sols],
           'U_finite': all(bool(torch.isfinite(s.U).all()) for s in sols),
           'launches': dict(K.launches), 'mesh': ens.mesh.describe(),
           'local_members': (ens.local_members.start,
                             ens.local_members.stop)}
    if return_U:
        out['U'] = np.stack([_np(s.U) for s in sols])
    if seconds is not None:
        out['seconds'] = seconds
    return out


def ensemble(mesh, params: dict, pairs, kappas=None, steps=None, warm=0,
             U_init=None, save=None, then=0, return_U=True) -> dict:
    """An :class:`~chsimpy_tpu_torch.ensemble.EnsembleSolver` of
    ``Parameters(**params)`` and the (A0, A1) ``pairs`` on this world's
    mesh: prepare, ``warm`` steps, then ``solve_or_resume(steps)`` timed
    (this rank's launches counted over it).  With ``save`` (a path) the
    ensemble checkpoint is written after it, and with ``then`` the
    ensemble re-enters for that many more steps.  Returns every member's
    results (:func:`_ensemble_out`), the member-steps/s of the timed
    solve, this rank's peak card memory and, with ``then``, the
    re-entry's results."""
    from ..checkpoint import save_ensemble_checkpoint
    from ..ensemble import EnsembleSolver
    p = Parameters(**params)
    ens = EnsembleSolver(p, np.asarray(pairs), U_init=U_init, mesh=mesh,
                         kappas=None if kappas is None
                         else np.asarray(kappas))
    if mesh.device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    ens.prepare()
    if warm:
        ens.solve_or_resume(warm)
    _sync(mesh)
    K.reset_launches()
    t0 = time.perf_counter()
    sols = ens.solve_or_resume(steps)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    out = _ensemble_out(ens, sols, seconds, return_U)
    out['member_steps_per_s'] = sum(s.computed_steps - (warm or 1)
                                    for s in sols) / seconds
    if mesh.device.type == 'cuda':
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
    if save is not None:
        save_ensemble_checkpoint(save, ens)
    if then:
        out['then'] = _ensemble_out(ens, ens.solve_or_resume(then),
                                    return_U=return_U)
    return out


def restore_ensemble(mesh, path: str, steps: int, device: str,
                     save=None) -> dict:
    """The ensemble checkpoint ``path`` restored onto this world's mesh:
    its members' fields as installed (gathered: the handoff), then
    ``solve_or_resume(steps)``; with ``save`` the continued ensemble is
    saved there."""
    from ..checkpoint import restore_ensemble as restore
    from ..checkpoint import save_ensemble_checkpoint
    ens = restore(path, mesh=mesh, device=device)
    handoff = ens.host_state()['U']
    sols = ens.solve_or_resume(steps)
    if save is not None:
        save_ensemble_checkpoint(save, ens)
    out = _ensemble_out(ens, sols)
    out['handoff_U'] = handoff
    return out


def ensemble_error(mesh, params: dict, pairs) -> str:
    """The error an EnsembleSolver on this mesh raises for ``pairs`` (''
    when it builds)."""
    from ..ensemble import EnsembleSolver
    try:
        EnsembleSolver(Parameters(**params), np.asarray(pairs), mesh=mesh)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ''


def merge_rows(mesh, rows_by_rank: list, nr_items: int) -> list:
    """``experiment.merge_rows_across_processes`` of this rank's rows
    ``rows_by_rank[rank]``."""
    import torch.distributed as dist

    from ..experiment import merge_rows_across_processes
    return merge_rows_across_processes(rows_by_rank[dist.get_rank()],
                                       nr_items)


def imported(mesh) -> list:
    """The top-level packages this rank has imported (a rank of the
    port imports no jax)."""
    return sorted({m.split('.')[0] for m in sys.modules})


TASKS = {'solve': solve, 'fused_stats': fused_stats,
         'chemical_potential': chemical_potential, 'dcts': dcts,
         'threefry_jitter': threefry_jitter, 'imported': imported,
         'live_solve': live_solve, 'ensemble': ensemble,
         'restore_ensemble': restore_ensemble,
         'ensemble_error': ensemble_error, 'merge_rows': merge_rows}


def run_tasks(mesh, tasks) -> list:
    """Run each ``(name, kwargs)`` of ``tasks`` in order; their results."""
    return [TASKS[name](mesh, **kw) for name, kw in tasks]
