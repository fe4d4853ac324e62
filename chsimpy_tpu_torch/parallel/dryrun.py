"""A dry run of the distributed solve on a world of ranks.

The port's counterpart of ``dryrun_multichip`` (``__graft_entry__.py:42-
233``), which certifies the JAX package's mesh axes on a device count:
:func:`dryrun_multichip` starts one world of ``n_ranks`` ranks
(:func:`~.distributed.spawn_world`; on the card, ranks that share it take
gloo) and holds what the ranks compute against one device's runs, made in
this process after the world ends:

* **stage 1**: the ensemble on an ('ens', 'x', 'y') mesh (ens = 2 for an
  even count of at least 4, the grid ``best_grid_shape`` of the rest),
  N=64 float64, 3 steps, R = max(2, ens) members: E within 1e-12, E2
  within 1e-10 (relative) and U within 1e-12 of the unsharded ensemble;
* **the flagship routes**, N=64, lcg, delt 3e-7, ntmax 600, across the
  energy stop (step 534 in float64) on the grid ``best_grid_shape`` of
  every rank: split and ozaki float64 on the pencil layout and matmul
  float64 on the grid, each at the single run's stop step with E within
  1e-10; split float32 on the pencil layout inside the float32 stop band
  (the larger of 3 steps and 0.5%); a case whose grid does not divide N
  is skipped, as in the JAX package;
* **ens-only** float64: one member a rank, each member's stop the
  unsharded ensemble's, E within 1e-12, at least 2 members stopped.

``python -m chsimpy_tpu_torch.parallel.dryrun 8 --device cpu`` runs it on
gloo ranks of the host; on the card (the default device) with ranks that
share it pass ``--dist-backend gloo``.  Each stage prints a line; a
failure raises ``AssertionError``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

N = 64
KAPPA = 2.98911291966116e-4
STAGE1_STEPS = 3
FLAGSHIP_NTMAX = 600
# (label, precision, route, E rtol, exact stop)
FLAGSHIP = (('pencil split f64', 'float64', 'split', 1e-10, True),
            ('pencil ozaki f64', 'float64', 'ozaki', 1e-10, True),
            ('grid matmul f64', 'float64', 'matmul', 1e-10, True),
            ('pencil split f32', 'float32', 'split', 2e-5, False))


def stage1_layout(n_ranks: int) -> tuple:
    """(ens, (mx, my), members) of stage 1 on ``n_ranks`` ranks."""
    from .mesh import best_grid_shape
    ens = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    return ens, best_grid_shape(n_ranks // ens), max(2, ens)


def _pairs(R: int, step: float):
    from .. import material
    A0, A1 = material.A0(923.15), material.A1(923.15)
    return np.array([[A0 * (1 + step * i), A1 * (1 - step * i)]
                     for i in range(R)])


def stage1_params(device: str):
    from ..params import Parameters
    return Parameters(N=N, precision='float64', no_gui=True, full_sim=True,
                      generator='lcg', kappa_tilde=KAPPA, chunk_size=4,
                      ntmax=STAGE1_STEPS, device=device)


def flagship_params(precision: str, transform: str, device: str):
    from ..params import Parameters
    return Parameters(N=N, precision=precision, no_gui=True,
                      full_sim=False, generator='lcg', kappa_tilde=KAPPA,
                      delt=3e-7, ntmax=FLAGSHIP_NTMAX,
                      transform_backend=transform, device=device)


def _traces(sols) -> list:
    return [{'computed_steps': s.computed_steps,
             'stop_reason': s.stop_reason,
             'E': np.asarray(s.timedata.E), 'E2': np.asarray(s.timedata.E2),
             'U': s.U.detach().cpu().numpy()} for s in sols]


def dryrun_rank(mesh, device: str) -> dict:
    """What one rank of the dry run's world computes, on the world's
    ('ens',)-only mesh of every rank (``mesh``) and on the meshes of the
    stages, built on the same process group.  Rank 0 returns the
    results; every other rank None."""
    import torch.distributed as dist

    from ..core.solver import Solver
    from ..ensemble import EnsembleSolver
    from .mesh import EnsembleMesh, best_grid_shape

    n = dist.get_world_size()
    backend = str(dist.get_backend())
    ens, grid, R = stage1_layout(n)
    m1 = EnsembleMesh(ens, grid, mesh.device)
    e = EnsembleSolver(stage1_params(device), _pairs(R, 0.001), mesh=m1)
    e.prepare()
    out = {'stage1': _traces(e.solve_or_resume(STAGE1_STEPS)),
           'stage1_mesh': (ens,) + tuple(grid), 'flagship': {}}
    grid = best_grid_shape(n)
    out['grid'] = grid
    for label, precision, transform, _, _ in FLAGSHIP:
        if N % math.prod(grid):
            continue
        p = flagship_params(precision, transform, device)
        p.mesh_shape, p.dist_backend = grid, backend
        s = Solver(p)
        s.prepare()
        out['flagship'][label] = _traces([s.solve_or_resume(p.ntmax)])[0]
        out['flagship'][label]['pencil'] = s.cfg.pencil
    e = EnsembleSolver(flagship_params('float64', 'auto', device),
                       _pairs(n, 0.0005), mesh=mesh)
    e.prepare()
    out['ens_only'] = _traces(e.solve_or_resume(FLAGSHIP_NTMAX))
    return out if dist.get_rank() == 0 else None


def _references(n_ranks: int, device: str) -> dict:
    """One device's runs of every stage's configuration."""
    from ..core.solver import Solver
    from ..ensemble import EnsembleSolver
    ens, grid, R = stage1_layout(n_ranks)
    e = EnsembleSolver(stage1_params(device), _pairs(R, 0.001))
    e.prepare()
    out = {'stage1': _traces(e.solve_or_resume(STAGE1_STEPS)),
           'flagship': {}}
    for label, precision, transform, _, _ in FLAGSHIP:
        s = Solver(flagship_params(precision, transform, device))
        s.prepare()
        out['flagship'][label] = _traces([s.solve_or_resume(
            FLAGSHIP_NTMAX)])[0]
    e = EnsembleSolver(flagship_params('float64', 'auto', device),
                       _pairs(n_ranks, 0.0005))
    e.prepare()
    out['ens_only'] = _traces(e.solve_or_resume(FLAGSHIP_NTMAX))
    return out


def check(got: dict, ref: dict) -> list:
    """Hold the world's results to one device's (raises
    ``AssertionError``); one line a stage and route."""
    lines = []
    for g, r in zip(got['stage1'], ref['stage1'], strict=True):
        assert g['computed_steps'] == r['computed_steps'] == STAGE1_STEPS
        assert np.isfinite(g['E']).all()
        np.testing.assert_allclose(g['E'], r['E'], rtol=1e-12)
        np.testing.assert_allclose(g['E2'], r['E2'], rtol=1e-10)
        np.testing.assert_allclose(g['U'], r['U'], rtol=0, atol=1e-12)
    lines.append(f"dryrun stage 1 ok: ens x grid {STAGE1_STEPS}-step "
                 f"equivalence (mesh ('ens', 'x', 'y') = "
                 f"{got['stage1_mesh']}, {len(got['stage1'])} members)")
    grid = got['grid']
    for label, _, transform, rtol, exact in FLAGSHIP:
        if label not in got['flagship']:
            lines.append(f"{label}: SKIP (grid {grid} does not divide "
                         f"N={N})")
            continue
        sh, r = got['flagship'][label], ref['flagship'][label]
        assert sh['pencil'] == (transform != 'matmul'), label
        assert r['stop_reason'] == 'energy', (
            f"{label}: the single run never crossed the energy stop "
            f"({r['computed_steps']} steps, {r['stop_reason']})")
        assert sh['stop_reason'] == r['stop_reason'], label
        if exact:
            assert sh['computed_steps'] == r['computed_steps'], (
                f"{label}: stop {sh['computed_steps']} against the single "
                f"run's {r['computed_steps']}")
            np.testing.assert_allclose(sh['E'], r['E'], rtol=rtol)
            lines.append(f"{label}: PASS (mesh {grid}, energy stop at step "
                         f"{sh['computed_steps']} == one device)")
        else:
            band = max(3, int(0.005 * r['computed_steps']))
            diff = abs(sh['computed_steps'] - r['computed_steps'])
            assert diff <= band, (
                f"{label}: stop {sh['computed_steps']} outside the float32 "
                f"band of the single run's {r['computed_steps']} (+-{band})")
            n = min(sh['computed_steps'], r['computed_steps'])
            np.testing.assert_allclose(sh['E'][:n], r['E'][:n], rtol=rtol)
            lines.append(f"{label}: PASS (mesh {grid}, energy stop at step "
                         f"{sh['computed_steps']} vs one device's "
                         f"{r['computed_steps']}, inside the float32 band "
                         f"+-{band})")
    stopped = sum(1 for r in ref['ens_only'] if r['stop_reason'] == 'energy')
    assert stopped >= 2, f"ens-only: only {stopped} members stopped"
    for g, r in zip(got['ens_only'], ref['ens_only'], strict=True):
        assert g['computed_steps'] == r['computed_steps'], (
            f"ens-only: member stop {g['computed_steps']} against "
            f"{r['computed_steps']}")
        assert g['stop_reason'] == r['stop_reason']
        np.testing.assert_allclose(g['E'], r['E'], rtol=1e-12)
    stops = [g['computed_steps'] for g in got['ens_only']]
    lines.append(f"ens-only f64: PASS (ens={len(stops)}, per-member energy "
                 f"stops {stops} == one device)")
    return lines


def dryrun_multichip(n_ranks: int, device: str = 'cuda', backend=None,
                     timeout: float = 900.0, threads=None) -> list:
    """The dry run on a new world of ``n_ranks`` ranks on the card (or
    gloo ranks on the host with ``device='cpu'``), then one device's
    references here (after the world: beside it they slow its ranks
    more than they take).  Returns the stage lines (each printed);
    raises ``AssertionError`` on a failure."""
    from ..device import resolve_device
    from .distributed import spawn_world
    resolve_device(device)
    got = spawn_world(dryrun_rank, (n_ranks, 1, 1), backend=backend,
                      device=device, args=(device,), timeout=timeout,
                      threads=threads)[0]
    lines = check(got, _references(n_ranks, device))
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.parallel.dryrun',
        description=__doc__.splitlines()[0])
    ap.add_argument('n_ranks', type=int)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dist-backend', default=None,
                    choices=['nccl', 'gloo'])
    ap.add_argument('--timeout', type=float, default=900.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_ranks, a.device, a.dist_backend, a.timeout)
    print('dryrun ok', flush=True)


if __name__ == '__main__':
    main()
