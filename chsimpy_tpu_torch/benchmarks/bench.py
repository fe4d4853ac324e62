#!/usr/bin/env python
"""Benchmark CLI of the port: ``python -m chsimpy_tpu_torch.benchmarks.bench``.

Port of ``chsimpy_tpu/benchmarks/bench.py``.  A warm-up phase runs the
configuration once (on the card it builds the kernels and warms the
allocator), then R timed repetitions of a full ``solve()``, each after
``prepare()``, so every rep integrates the same trajectory.  Each rep
reports wall seconds (host clock, ending after the card has finished) and
steps/s; the artifact ``<file-id>.bench.json`` (schema
``chsimpy-tpu-bench-v1``, the JAX package's keys) carries the host and
device, the run's configuration, the samples and the best/median/mean
rates.  ``--profile-dir`` writes a ``torch.profiler`` trace of the first
timed rep there.  The run's device is the CLI's ``--device`` (the card by
default).  Under ``--mesh`` start it with torchrun as the solver's CLI;
rank 0 prints and writes.  It writes no ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from .. import sysinfo
from ..cli import CLIParser
from ..parallel import distributed
from ..simulator import Simulator


def parse_bench_args(argv=None):
    """The bench flags on top of the port's simulation flags.  Returns
    ``(options dict, Parameters)``."""
    cli = CLIParser('chsimpy-tpu-torch (benchmark)')
    group = cli.parser.add_argument_group('Benchmark')
    group.add_argument('-R', '--runs', default=3, type=int,
                       help='Number of timed repetitions')
    group.add_argument('-w', '--warmups', default=1, type=int,
                       help='Number of warmup repetitions (kernel build, '
                            'allocator)')
    group.add_argument('-W', '--warmup-ntmax', type=int,
                       help='Simulation steps per warmup repetition '
                            '(default: ntmax)')
    group.add_argument('--profile-dir',
                       help='Write a torch.profiler trace of the first '
                            'timed rep into this directory')
    params = cli.get_parameters(argv)
    args = cli.args
    params.no_gui = True
    if args.runs < 1:
        cli.parser.error('--runs must be at least 1')
    if args.warmup_ntmax is not None and args.warmup_ntmax > params.ntmax:
        cli.parser.error('--warmup-ntmax must not exceed ntmax')
    if params.png or params.png_anim:
        cli.parser.error('benchmarks run headless: drop --png/--png-anim')
    opts = {
        'runs': args.runs,
        'warmups': args.warmups,
        'warmup_ntmax': (args.warmup_ntmax if args.warmup_ntmax is not None
                         else params.ntmax),
        'profile_dir': args.profile_dir,
    }
    return opts, params


@contextlib.contextmanager
def _maybe_profile(profile_dir, device):
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, 'trace.json'))


def _finish(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize()


def measure_reps(simulator: Simulator, ntmax: int, reps: int,
                 profile_dir=None) -> list:
    """Time ``reps`` full solves of ``ntmax`` steps each; state is
    re-prepared before each rep.  Returns one sample dict per rep."""
    device = simulator.solver.device
    samples = []
    for rep in range(reps):
        simulator.params.ntmax = ntmax
        simulator.solver.prepare()
        with _maybe_profile(profile_dir if rep == 0 else None, device):
            _finish(device)
            t0 = time.perf_counter()
            simulator.solve()
            _finish(device)
            seconds = time.perf_counter() - t0
        steps = simulator.solver.solution.computed_steps - 1
        samples.append({
            'rep': rep,
            'seconds': round(seconds, 6),
            'steps': int(steps),
            'steps_per_s': round(steps / max(seconds, 1e-12), 3),
        })
    return samples


def _rates(samples):
    return np.array([s['steps_per_s'] for s in samples], dtype=np.float64)


def main(argv=None):
    opts, params = parse_bench_args(argv)
    lead = os.environ.get('RANK', '0') == '0'
    if params.mesh_shape is not None:
        distributed.initialize(params.dist_backend, params.device)
    try:
        _bench(opts, params, lead)
    finally:
        if params.mesh_shape is not None:
            distributed.shutdown()


def _bench(opts, params, lead):
    wall_start = time.perf_counter()
    simulator = Simulator(params)
    file_id = sysinfo.get_or_create_file_id(params.file_id)

    warmup_samples = []
    if opts['warmups'] > 0:
        warmup_samples = measure_reps(simulator, opts['warmup_ntmax'],
                                      opts['warmups'])
        if lead:
            print(f"[warmup] {opts['warmups']} rep(s) x "
                  f"{opts['warmup_ntmax']} steps: "
                  + ", ".join(f"{s['seconds']:.3f}s"
                              for s in warmup_samples))

    timed_samples = measure_reps(simulator, params.ntmax, opts['runs'],
                                 profile_dir=opts['profile_dir'])
    rates = _rates(timed_samples)
    if not lead:
        return
    for s in timed_samples:
        print(f"[rep {s['rep']}] {s['steps']} steps in {s['seconds']:.3f}s "
              f"-> {s['steps_per_s']:.2f} steps/s")
    print(f"[summary] N={params.N} {params.precision}: "
          f"best {rates.max():.2f} steps/s, "
          f"median {np.median(rates):.2f} steps/s "
          f"({time.perf_counter() - wall_start:.1f}s total)")

    artifact = {
        'schema': 'chsimpy-tpu-bench-v1',
        'file_id': file_id,
        'options': opts,
        'config': {
            'N': params.N, 'ntmax': params.ntmax,
            'precision': params.precision,
            'generator': params.generator, 'seed': params.seed,
            'adaptive_time': params.adaptive_time,
            'kernel_backend': params.kernel_backend,
            'transform_backend': simulator.solver.cfg.transform_backend,
            'matmul_precision': params.matmul_precision,
            'chunk_size': params.chunk_size,
            'mesh_shape': params.mesh_shape,
            'jitter': params.jitter,
            'jitter_mode': simulator.solver.cfg.jitter_mode,
            'device': str(simulator.solver.device),
        },
        'host': sysinfo.get_system_info(),
        'devices': sysinfo.get_device_info(simulator.solver.device),
        'warmup': warmup_samples,
        'reps': timed_samples,
        'steps_per_s': {
            'best': float(rates.max()),
            'median': float(np.median(rates)),
            'mean': float(rates.mean()),
        },
    }
    out = f"{file_id}.bench.json"
    with open(out, 'w') as f:
        json.dump(artifact, f, indent=1)
    print(f"[artifact] {out}")


if __name__ == '__main__':
    main()
