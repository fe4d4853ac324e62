#!/usr/bin/env python
"""Where does K5's one-launch path stop paying?  Both paths of the slice
kernel timed on the card, in turns, over stacks of R float64 fields.

    python -m chsimpy_tpu_torch.benchmarks.slice_paths
    python -m chsimpy_tpu_torch.benchmarks.slice_paths --shapes 16x512,1x2048

K5_members (``ops/kernels.py`` ``slice_field_members``) takes one
cooperative launch (``slice_one_launch_kernel``) where the stack's bytes,
R * N^2 * 8, fit in ``SLICE_ONE_LAUNCH_BYTES``, and its max and slice
passes otherwise.  This tool times both paths on every shape, whatever
the wrapper would choose: device time of one call in a window of
back-to-back calls (two, one, one, two), with the planes and scales held
equal to the bit.  One JSON line per (shape, slices), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops import kernels as K
from ..sysinfo import card_line

SHAPES = ('1x512,16x512,8x1024,4x1024,1x2048,5x1024,20x512,6x1024,'
          '24x512,1x2560,2x2048,1x4096,4x4096')
CALLS = 20           # back-to-back calls in a timed window
REPS = 5             # windows, the median taken


def device_ms(fn, calls=CALLS, reps=REPS) -> float:
    """Device ms of one call: ``calls`` calls between two CUDA events
    (median of ``reps`` windows), behind a sleep kernel that holds the
    card while the host queues the window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)          # ~2 ms at 1.98 GHz
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def stack(R: int, N: int, seed: int = 0) -> torch.Tensor:
    """R float64 fields like the ozaki route's operands: values of order
    one, a member 1000 times smaller."""
    rng = np.random.default_rng(seed)
    x = 0.875 + 0.05 * rng.standard_normal((R, N, N))
    if R > 1:
        x[1] *= 1e-3
    return torch.tensor(x, dtype=torch.float64, device='cuda')


def compare(R: int, N: int, n_slices: int) -> dict:
    x = stack(R, N)

    def one():
        return K._slice_one_launch(x, R, n_slices)

    def two():
        return K._slice_members_two_launches(x, n_slices)

    (p1, s1), (p2, s2) = one(), two()
    same = torch.equal(p1, p2) and torch.equal(s1.view(torch.int64),
                                               s2.view(torch.int64))
    t1, t2 = [], []
    for turn in (two, one, one, two):
        (t1 if turn is one else t2).append(device_ms(turn))
    mib = R * N * N * 8 / 2 ** 20
    return {'R': R, 'N': N, 'n_slices': n_slices, 'MiB': mib,
            'one_launch_ms': t1, 'two_launches_ms': t2,
            'ratio': statistics.median(t1) / statistics.median(t2),
            'same_bits': same,
            'wrapper_takes_one_launch': K.slice_one_launch(R, N * N)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.slice_paths',
        description=__doc__.splitlines()[0])
    ap.add_argument('--shapes', default=SHAPES,
                    help='RxN,... stacks of R NxN fields')
    ap.add_argument('--slices', default='4,6')
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('slice_paths times the card: no CUDA device')
    ok = True
    for shape in a.shapes.split(','):
        R, N = (int(v) for v in shape.split('x'))
        for n in (int(v) for v in a.slices.split(',')):
            row = compare(R, N, n)
            ok = ok and row['same_bits']
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(card_line(), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    raise SystemExit(main())
