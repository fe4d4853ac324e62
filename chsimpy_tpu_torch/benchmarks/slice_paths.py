#!/usr/bin/env python
"""Where does K5's one-launch path stop paying, and where does K5
sharded's time go?  The slice kernel's paths timed on the card, in
turns, over stacks of R float64 fields and over a rank's blocks.

    python -m chsimpy_tpu_torch.benchmarks.slice_paths
    python -m chsimpy_tpu_torch.benchmarks.slice_paths --shapes 16x512,1x2048
    python -m chsimpy_tpu_torch.benchmarks.slice_paths --sharded

K5_members (``ops/kernels.py`` ``slice_field_members``) takes one
cooperative launch (``slice_one_launch_kernel``) where the stack's bytes,
R * N^2 * 8, fit in ``SLICE_ONE_LAUNCH_BYTES``, and its max and slice
passes otherwise.  This tool times both paths on every shape, whatever
the wrapper would choose: device time of one call in a window of
back-to-back calls (two, one, one, two), with the planes and scales held
equal to the bit.  One JSON line per (shape, slices), then the card's
name and power limit.

``--sharded``: K5 sharded (``slice_field_sharded``) on the blocks the
sharded ozaki routes slice, its world max left out (one rank): the call
(the max pass, then the slice pass forming the scale; the grid forward's
column strip at a given max: the slice pass alone), each launch alone,
the max pass on ``SLICE_SHARDED_MAX_BLOCKS`` blocks and, in turns, on a
whole field's ``SLICE_MAX_BLOCKS``, the bound, torch's float64 -> float32
copy of the block as a yardstick of the card's rate, and the planes and
scales held equal to the plain version's to the bit."""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..ops import kernels as K
from ..sysinfo import card_line
from .roofline import slice_bound

SHAPES = ('1x512,16x512,8x1024,4x1024,1x2048,5x1024,20x512,6x1024,'
          '24x512,1x2560,2x2048,1x4096,4x4096')
# --sharded: (name, R, rows, cols, slices, the max given): a rank's pencil
# column block at N=4096, a 2x2 grid's block at N=4094, R=4 members'
# pencil blocks at N=512, the grid forward's column strip at N=4094
SHARDED = (('pencil block', 1, 4096, 1024, 4, False),
           ('grid block', 1, 2047, 2047, 6, False),
           ('member blocks', 4, 512, 128, 4, False),
           ('grid strip', 1, 4094, 2047, 6, True))
CALLS = 20           # back-to-back calls in a timed window
REPS = 5             # windows, the median taken


def device_ms(fn, calls=CALLS, reps=REPS) -> float:
    """Device ms of one call: ``calls`` calls between two CUDA events
    (median of ``reps`` windows), behind a sleep kernel that holds the
    card while the host queues the window (twice the host's time to queue
    it, 2 ms at least)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2e-3, 2 * enqueue * calls) * 2e9)   # SM clock <= 2 GHz
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def stack(R: int, N: int, cols: int = 0, seed: int = 0) -> torch.Tensor:
    """R float64 (N, N) fields, or (N, cols) blocks, like the ozaki
    route's operands: values of order one, a member 1000 times
    smaller."""
    rng = np.random.default_rng(seed)
    x = 0.875 + 0.05 * rng.standard_normal((R, N, cols or N))
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


def max_pass(x, R: int, blocks: int):
    """K5 sharded's max pass (``ch_slice_max``) on at most ``blocks``
    blocks a field: the bits of each of x's R maxima.  The wrapper's
    ``_slice_max_launch`` takes SLICE_SHARDED_MAX_BLOCKS."""
    partials = torch.empty((R * blocks,), dtype=torch.int64, device=x.device)
    bits = torch.empty((R,), dtype=torch.int64, device=x.device)
    K._call('ch_slice_max', x.dtype, x.data_ptr(), x.numel() // R, R,
            partials.data_ptr(), blocks, K._ticket(x.device, R).data_ptr(),
            bits.data_ptr(), K._stream())
    return bits


def compare_sharded(name, R, rows, cols, n_slices, given) -> dict:
    """K5 sharded on R (rows, cols) blocks, one rank."""
    x = stack(R, rows, cols)
    if R == 1:
        x = x[0]
    world = torch.abs(x).amax(dim=(-2, -1)).reshape(-1)

    if given:
        def call():
            return K._slice_sharded_planes_launch(x, world, R, n_slices)
    else:
        def call():
            b = K._slice_max_launch(x, R).view(torch.float64)
            return K._slice_sharded_planes_launch(x, b, R, n_slices)
    planes, scale = call()
    want, wscale = (K.slice_field_members_ref(x, n_slices, world) if R > 1
                    else K.slice_field_ref(x, n_slices, world.reshape(())))
    same = (torch.equal(planes, want)
            and torch.equal(scale.reshape(-1).view(torch.int64),
                            wscale.reshape(-1).view(torch.int64)))
    ms = device_ms(call)
    launches = {'slice pass (sharded mode)': device_ms(
        lambda: K._slice_sharded_planes_launch(x, world, R, n_slices))}
    row = {'block': name, 'R': R, 'rows': rows, 'cols': cols,
           'n_slices': n_slices, 'max_given': given, 'ms': ms,
           'launch_ms': launches}
    if not given:
        # the max pass's grid: the wrapper's against a whole field's, in
        # turns (the max is exact: the same bits on either grid)
        few, many = K.SLICE_SHARDED_MAX_BLOCKS, K.SLICE_MAX_BLOCKS
        same = same and torch.equal(max_pass(x, R, few),
                                    max_pass(x, R, many))
        t_few, t_many = [], []
        for blocks in (many, few, few, many):
            (t_few if blocks == few else t_many).append(
                device_ms(lambda: max_pass(x, R, blocks)))
        launches['max pass (max-only mode)'] = statistics.median(t_few)
        row['max_pass_ms_turns'] = {str(few): t_few, str(many): t_many}
    row.update(slice_bound(x.numel(), n_slices))
    row['bound_share'] = row['bound_ms'] / ms
    row['slice_pass_TBps'] = (x.numel() * (8 + n_slices) / 1e9
                              / launches['slice pass (sharded mode)'])
    # float64 -> float32: 8 bytes read, 4 written an element
    row['torch_copy_ms'] = device_ms(lambda: x.to(torch.float32))
    row['torch_copy_TBps'] = x.numel() * 12 / 1e9 / row['torch_copy_ms']
    row['same_bits'] = same
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.slice_paths',
        description=__doc__.splitlines()[0])
    ap.add_argument('--shapes', default=SHAPES,
                    help='RxN,... stacks of R NxN fields')
    ap.add_argument('--slices', default='4,6')
    ap.add_argument('--sharded', action='store_true',
                    help="K5 sharded on a rank's blocks")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('slice_paths times the card: no CUDA device')
    ok = True
    if a.sharded:
        for case in SHARDED:
            row = compare_sharded(*case)
            ok = ok and row['same_bits']
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
        print(card_line(), flush=True)
        return 0 if ok else 1
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
