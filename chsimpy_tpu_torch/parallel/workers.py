"""What a world started by :func:`~.distributed.spawn_grid` or
:func:`~.distributed.spawn_world` runs.

A spawned rank imports these functions by name (never a test file's, so a
rank imports no jax).  :func:`run_tasks` runs a list of ``(name, kwargs)``
tasks in order on every rank and returns one result per task; fields come
in whole (numpy, the same on every rank) and go back whole, so a caller
can hold the world's results against a single-device or JAX run.
"""

from __future__ import annotations

import functools
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
          return_U=True, mesh_shape=None, audit_steps=0,
          profile_steps=0) -> dict:
    """A sharded solve of ``Parameters(**params)`` on this world's mesh
    shape (or ``mesh_shape``, another grid of the world's ranks) and
    backend: through ``Simulator.solve`` (``steps`` None),
    or ``Solver.prepare`` and ``solve_or_resume(steps)`` (a list: one
    entry per item, in turn, each entry's seconds kept); then, with
    ``rate_steps``, one timed window of that many more steps, and with
    ``audit_steps`` the collectives of that many more
    (``parallel.audit.count_chunk``), and with ``profile_steps`` a
    ``torch.profiler`` trace of that many more
    (``benchmarks.rank_profile.profile_solver`` on rank 0; None on the
    other ranks, which step untraced).  The params' device must be the
    world's.  Returns the solution's scalars, its
    timedata, mean(U) (and U with ``return_U``), this rank's kernel
    launches and the seconds of the solve."""
    p = Parameters(**params)
    if torch.device(p.device).type != mesh.device.type:
        raise ValueError(f"params ask for device {p.device!r}, the world "
                         f"runs on {mesh.device.type!r}")
    p.mesh_shape = tuple(mesh_shape or mesh.shape)
    p.dist_backend = mesh.backend
    p.no_gui = True
    K.reset_launches()
    if mesh.device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    entries = []
    if steps is None:
        sim = Simulator(p, U_init)
        solver = sim.solver
        sol = sim.solve()
    else:
        solver = Solver(p, U_init)
        solver.prepare()
        for k in (steps if isinstance(steps, (list, tuple)) else [steps]):
            t1 = time.perf_counter()
            sol = solver.solve_or_resume(k)
            _sync(mesh)
            entries.append(time.perf_counter() - t1)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    out = {'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0, 't0': sol.t0,
           'timedata': sol.timedata.data(),
           'U_mean': sol.U.double().mean().item(),
           'U_finite': bool(torch.isfinite(sol.U).all()),
           'U_shape': tuple(sol.U.shape),
           'launches': dict(K.launches), 'seconds': seconds,
           'entry_seconds': entries,
           'mesh': (solver.mesh or mesh).describe(),
           'pencil': solver.cfg.pencil,
           'block_shapes': {k: tuple(getattr(solver._state, k).shape)
                            for k in ('U', 'hat_U')}}
    if mesh.device.type == 'cuda':
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
    if return_U:
        out['U'] = _np(sol.U)
    if rate_steps:
        _sync(mesh)
        t0 = time.perf_counter()
        solver.solve_or_resume(rate_steps)
        _sync(mesh)
        out['steps_per_s'] = rate_steps / (time.perf_counter() - t0)
    if audit_steps:
        from .audit import count_chunk
        out['audit'] = count_chunk(solver, audit_steps)
    if profile_steps:
        # rank 0 traces; the others step untraced, in the same collectives
        from ..benchmarks.rank_profile import profile_solver
        out['profile'] = None
        if mesh.rank == mesh.base:
            out['profile'] = profile_solver(solver, profile_steps)
        else:
            solver.solve_or_resume(profile_steps)
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


def pencil_dcts(mesh, U, dtype: str) -> tuple:
    """The pencil forms of the matmul and split routes' 2-D DCTs of the
    whole U, gathered whole: (dct2_pencil, idct2_pencil,
    dct2_split_perm_pencil, idct2_split_perm_pencil at 2 levels)."""
    N = np.asarray(U).shape[0]
    dt = _DTYPES[dtype]
    C = dct_ops.dct_matrix(N, dt, mesh.device)
    tree = dct_ops.split_tree(N, 2, dt, mesh.device)
    cols = _block(mesh.field_view, U, dtype)
    rows = _block(mesh.spec_view, U, dtype)
    return tuple(_np(gather_field(x, view)) for x, view in (
        (dct_ops.dct2_pencil(cols, C, mesh), mesh.spec_view),
        (dct_ops.idct2_pencil(rows, C, mesh), mesh.field_view),
        (dct_ops.dct2_split_perm_pencil(cols, tree, mesh), mesh.spec_view),
        (dct_ops.idct2_split_perm_pencil(rows, tree, mesh),
         mesh.field_view)))


def transposes(mesh, N: int, R: int = 3, S: int = 4) -> dict:
    """The pencil transposes on seeded arrays of this rank's blocks: for
    a 2-D pencil (N, N), a member stack (R, N, N) and an int8 stack in
    the products' layout (S, N, R, N), whether the row block
    :func:`transpose_to_rows` gives is the array's row block, and whether
    :func:`transpose_to_cols` takes it back to the column block."""
    from . import collectives as coll
    D, r = mesh.size, mesh.rank - mesh.base
    c = N // D
    g = torch.Generator().manual_seed(7)
    cases = {'pencil': (torch.rand((N, N), generator=g, dtype=torch.float64),
                        0),
             'members': (torch.rand((R, N, N), generator=g), 1),
             'int8': (torch.randint(-64, 65, (S, N, R, N), generator=g,
                                    dtype=torch.int8), 1)}
    out = {}
    for name, (a, dim) in cases.items():
        a = a.to(mesh.device)
        colb = a[..., r * c:(r + 1) * c].contiguous()
        rowb = a.narrow(dim, r * c, c)
        rows = coll.transpose_to_rows(mesh, colb, row_dim=dim)
        back = coll.transpose_to_cols(mesh, rows, row_dim=dim)
        out[name] = (torch.equal(rows, rowb) and rows.is_contiguous(),
                     torch.equal(back, colb) and back.is_contiguous())
    return out


def slice_sharded(mesh, x, n_slices: int, members: bool = False,
                  layout: str = 'field') -> tuple:
    """K5 sharded on this rank's block of the whole float64 ``x`` ((N, N),
    or (R, N, N) with ``members``) in the pencil ``layout`` ('field':
    column blocks, 'spec': row blocks): (planes, scale) as numpy."""
    view = mesh.field_view if layout == 'field' else mesh.spec_view
    t = torch.as_tensor(np.asarray(x, dtype=np.float64)).to(mesh.device)
    b = shard_field(t, view)[0]
    f = K.slice_field_members_sharded if members else K.slice_field_sharded
    planes, scale = f(b, mesh, n_slices)
    return _np(planes), _np(scale)


def ozaki_grid(mesh, x, s1: int = 3, s2: int = 5) -> dict:
    """The grid ozaki transforms (``ops/ozaki.py`` ``dct2_ozaki_grid`` at
    the pair cutoffs (s1, s2), ``idct2_ozaki_grid``) of the whole float64
    ``x`` ((N, N), or (R, N, N) members) on this rank's block, gathered
    whole, and the mean and max|x - mean| the forward took, as numpy."""
    from ..ops import ozaki
    from . import collectives as coll
    from .sharding import ozaki_grid_stacks
    t = torch.as_tensor(np.asarray(x, dtype=np.float64)).to(mesh.device)
    N = t.shape[-1]
    Cs, CsT, sc = ozaki.dct_slices(N, mesh.device)
    stacks = ozaki_grid_stacks(Cs, CsT, mesh)
    b = shard_field(t, mesh)[0]
    fwd = ozaki.dct2_ozaki_grid(b, stacks, sc, mesh, s1=s1, s2=s2)
    inv = ozaki.idct2_ozaki_grid(b, stacks, sc, mesh)
    m, amax = ozaki._world_mean_amax(mesh, coll.gather_x(mesh, b), N)
    return {'dct2': _np(gather_field(fwd, mesh)),
            'idct2': _np(gather_field(inv, mesh)),
            'mean': _np(m), 'amax': _np(amax), 'block': tuple(b.shape)}


@functools.lru_cache(maxsize=2)
def _normal_field(seed: int, shape: tuple) -> np.ndarray:
    """Standard normal values from ``seed`` (made once a rank per seed
    and shape: the checks of one field share it)."""
    return np.random.default_rng(seed).standard_normal(shape)


def slice_sharded_check(mesh, N: int, n_slices: int, kind: str,
                        layout: str = 'field', R: int = 0,
                        seed: int = 0) -> dict:
    """K5 sharded against K5 on the whole field, on this world's device:
    the field (or R members' fields) made from ``seed`` on every rank —
    ``kind`` 'block' (normal values, the max in one block only) or 'ulp'
    (the max one ulp above 2^8, in one block only) — K5 sharded on this
    rank's block in the ``layout`` ('field', 'spec': the pencil's column
    and row blocks; 'grid': the grid's own blocks), ``slice_field`` (or
    ``slice_field_members``) on the whole field restricted to the block,
    and the plain version at the world's max.  Returns the largest plane
    differences, the scales and the launches counted."""
    view = {'field': mesh.field_view, 'spec': mesh.spec_view,
            'grid': mesh}[layout]
    x = _normal_field(seed, (R, N, N) if R else (N, N)).copy()
    # the max in block 1 only, its exponent above every other block's
    if layout == 'grid':
        my = mesh.shape[1]
        at = (N // (3 * mesh.shape[0]), N // my + N // (3 * my))
    else:
        b1 = N // mesh.size + N // (3 * mesh.size)
        at = (N // 3, b1) if layout == 'field' else (b1, N // 3)
    big = np.nextafter(2.0 ** 8, np.inf) if kind == 'ulp' else 20.5
    if R:
        x[R - 1][at] = -big
    else:
        x[at] = -big
    t = torch.as_tensor(x).to(mesh.device)
    b = shard_field(t, view)[0]
    K.reset_launches()
    if R:
        got, scale = K.slice_field_members_sharded(b, mesh, n_slices)
        whole, wscale = K.slice_field_members(t, n_slices)
        amax = torch.abs(t).amax(dim=(1, 2))
        plain, pscale = K.slice_field_members_ref(b, n_slices, amax)
    else:
        got, scale = K.slice_field_sharded(b, mesh, n_slices)
        whole, wscale = K.slice_field(t, n_slices)
        plain, pscale = K.slice_field_ref(b, n_slices, torch.abs(t).amax())
    counted = dict(K.launches)
    rows, cols = block_slices(view, N)
    want = whole[..., rows, cols]
    _sync(mesh)
    return {'N': N, 'kind': kind, 'layout': layout, 'R': R,
            'n_slices': n_slices, 'block': tuple(b.shape[-2:]),
            'max_diff_whole': int((got.int() - want.int()).abs().max()),
            'max_diff_plain': int((got.int() - plain.int()).abs().max()),
            'scale': _np(scale).tolist(), 'whole_scale': _np(wscale).tolist(),
            'plain_scale': _np(pscale).tolist(), 'launches': counted}


def audit(mesh, **kw) -> dict:
    """``parallel.audit.audit_chunk`` on this world's mesh."""
    from .audit import audit_chunk
    return audit_chunk(mesh, **kw)


def scaling(mesh, **kw) -> dict:
    """``benchmarks.scaling.scaling`` on this world (rank 0's result on
    every rank)."""
    from ..benchmarks.scaling import scaling as run
    return run(device=mesh.device.type, **kw)


def audit_ensemble(mesh, **kw) -> dict:
    """``parallel.audit.audit_ensemble`` on this world's mesh."""
    from .audit import audit_ensemble as run
    return run(mesh, **kw)


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


def experiment(mesh, argv: list, cwd: str) -> str:
    """``experiment.main(argv)`` on this world (the process group the
    experiment joins), run in ``cwd``/rank<r> (made here), whose path it
    returns.  The experiment ends the process group: a world's last
    task."""
    import os

    from ..experiment import main
    work = os.path.join(cwd, f'rank{mesh.rank}')
    os.makedirs(work, exist_ok=True)
    here = os.getcwd()
    os.chdir(work)
    try:
        main(list(argv))
    finally:
        os.chdir(here)
    return work


def imported(mesh) -> list:
    """The top-level packages this rank has imported (a rank of the
    port imports no jax)."""
    return sorted({m.split('.')[0] for m in sys.modules})


TASKS = {'solve': solve, 'fused_stats': fused_stats,
         'chemical_potential': chemical_potential, 'dcts': dcts,
         'threefry_jitter': threefry_jitter, 'imported': imported,
         'live_solve': live_solve, 'ensemble': ensemble,
         'restore_ensemble': restore_ensemble,
         'ensemble_error': ensemble_error, 'merge_rows': merge_rows,
         'transposes': transposes, 'pencil_dcts': pencil_dcts,
         'slice_sharded': slice_sharded,
         'slice_sharded_check': slice_sharded_check, 'audit': audit,
         'ozaki_grid': ozaki_grid, 'audit_ensemble': audit_ensemble,
         'scaling': scaling, 'experiment': experiment}


def run_tasks(mesh, tasks, timed: bool = False):
    """Run each ``(name, kwargs)`` of ``tasks`` in order; their results
    (``timed``: and each task's seconds on this rank)."""
    out, seconds = [], []
    for name, kw in tasks:
        t0 = time.perf_counter()
        out.append(TASKS[name](mesh, **kw))
        seconds.append(time.perf_counter() - t0)
    return (out, seconds) if timed else out
