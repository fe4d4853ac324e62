"""Scaling-efficiency benchmark.

Port of ``chsimpy_tpu/benchmarks/scaling.py``: steps/s of the solver on
one device against a world of ``torch.distributed`` ranks, and the
scaling efficiency ``rate_mesh / (rate_1dev * ranks)``.  Two modes:

* ``--axis grid``: strong scaling of one field, tiled over the
  ``best_grid_shape`` of the world (the grid DCTs' strip gathers, or the
  pencil layout's transposes on the split and ozaki routes, are the
  communication measured);
* ``--axis ens``: weak scaling of the UQ ensemble, ``-R`` members split
  over an ('ens',)-only mesh of every rank (independent members: the
  efficiency should be ~100%).

Under ``torchrun`` pass ``--distributed`` (``parallel/distributed.py``
``initialize``: one rank per card with nccl, the default on the card)::

    torchrun --standalone --nproc-per-node 4 -m \\
        chsimpy_tpu_torch.benchmarks.scaling --distributed --axis grid \\
        -N 1024 -n 64

Rank 0 measures the one-device rate while the other ranks wait at a
barrier; then every rank runs the mesh rate, and rank 0 alone prints one
JSON line with the JAX package's keys.  Without ``--distributed`` the
world is this one process.  Ranks that share one card (``--dist-backend
gloo``: NCCL takes one card a rank) time-slice it and stage every
collective through host memory: their rates check that the harness runs
and are no scaling figure; so are gloo ranks on the CPU (``--device
cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

KAPPA = 2.98911291966116e-4


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def solve_rate(params, nsteps: int, mesh_shape=None) -> float:
    """Steps/s of a solve of ``nsteps`` (after a warm-up entry of up to
    32 steps and a new ``prepare``), on one device or on ``mesh_shape``
    (every rank of the world calls it)."""
    from ..core.solver import Solver
    p = params.deepcopy()
    p.mesh_shape = mesh_shape
    solver = Solver(p)
    solver.prepare()
    solver.solve_or_resume(min(nsteps, 32))
    solver.prepare()
    _sync(p.device)
    t0 = time.perf_counter()
    sol = solver.solve_or_resume(nsteps)
    _sync(p.device)
    return (sol.computed_steps - 1) / (time.perf_counter() - t0)


def ensemble_rate(params, nsteps: int, R: int, mesh=None) -> float:
    """Member-steps/s of an ensemble of ``R`` members (the JAX
    benchmark's A0 factors), on one device or on ``mesh``."""
    from .. import material
    from ..ensemble import EnsembleSolver
    A0 = material.A0(params.temp)
    A1 = material.A1(params.temp)
    pairs = np.array([[A0 * (1 + 1e-4 * i), A1] for i in range(R)])
    ens = EnsembleSolver(params, pairs, mesh=mesh)
    ens.prepare()
    ens.solve_or_resume(min(nsteps, 32))
    ens.prepare()
    _sync(params.device)
    t0 = time.perf_counter()
    sols = ens.solve_or_resume(nsteps)
    _sync(params.device)
    steps = sum(s.computed_steps - 1 for s in sols)
    return steps / (time.perf_counter() - t0)


def scaling(axis: str = 'grid', N: int = 2048, nsteps: int = 128,
            R=None, precision: str = 'float32',
            device: str = 'cuda') -> dict:
    """The benchmark on the initialized process group (or this one
    process): every rank calls it and gets rank 0's result (the JAX
    keys); rank 0 measures the one-device rate alone first."""
    import torch.distributed as dist

    from ..params import Parameters
    from ..parallel.mesh import EnsembleMesh, best_grid_shape

    world = dist.is_initialized()
    ndev = dist.get_world_size() if world else 1
    rank = dist.get_rank() if world else 0
    p = Parameters(N=N, ntmax=nsteps, no_gui=True, full_sim=True,
                   generator='lcg', precision=precision, kappa_tilde=KAPPA,
                   device=device)
    if world:
        p.dist_backend = str(dist.get_backend())
    dev = torch.device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    base = None
    if axis == 'grid':
        if rank == 0:
            base = solve_rate(p, nsteps)
        if world:
            dist.barrier()
        mesh_shape = best_grid_shape(ndev)
        sharded = solve_rate(p, nsteps, mesh_shape=mesh_shape)
        out = {'axis': 'grid', 'N': N, 'devices': ndev,
               'mesh': list(mesh_shape), 'steps_per_s_1dev': base,
               'steps_per_s_mesh': sharded}
    elif axis == 'ens':
        R = R or ndev
        if rank == 0:
            base = ensemble_rate(p, nsteps, R)
        if world:
            dist.barrier()
        mesh = EnsembleMesh(ndev, (1, 1), dev) if world else None
        sharded = ensemble_rate(p, nsteps, R, mesh=mesh)
        out = {'axis': 'ens', 'N': N, 'devices': ndev, 'members': R,
               'member_steps_per_s_1dev': base,
               'member_steps_per_s_mesh': sharded}
    else:
        raise ValueError(f"unknown axis {axis!r}; choose grid or ens")
    if rank == 0:
        out['speedup'] = sharded / base
        out['scaling_efficiency'] = sharded / (base * ndev)
    if world:
        got = [out]
        dist.broadcast_object_list(got, src=0)
        out = got[0]
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.scaling',
        description=__doc__.splitlines()[0])
    parser.add_argument('--axis', choices=['grid', 'ens'], default='grid')
    parser.add_argument('-N', type=int, default=2048)
    parser.add_argument('-n', '--nsteps', type=int, default=128)
    parser.add_argument('-R', '--runs', type=int, default=None,
                        help='ensemble members (default: the rank count)')
    parser.add_argument('--precision', default='float32')
    parser.add_argument('--distributed', action='store_true',
                        help='join the torchrun world first')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--dist-backend', default=None,
                        choices=['nccl', 'gloo'],
                        help='nccl: one card a rank (the default on the '
                             'card); gloo: the CPU, or ranks sharing cards')
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..device import resolve_device
    from ..parallel import distributed
    resolve_device(args.device)
    if args.distributed:
        print(distributed.initialize(args.dist_backend, args.device),
              file=sys.stderr)
    try:
        out = scaling(args.axis, args.N, args.nsteps, args.runs,
                      args.precision, args.device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps(out), flush=True)
    finally:
        if args.distributed:
            distributed.shutdown()


if __name__ == '__main__':
    main()
