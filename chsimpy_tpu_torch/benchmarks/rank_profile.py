"""Where one rank's world step goes: a ``torch.profiler`` trace.

A sharded solver that has run its first steps takes ``steps`` more under
the PyTorch profiler (kineto: CPU and, on the card, CUDA activities, the
hand-written kernels traced by CUPTI like PyTorch's own).  The session
is opened through ``torch.autograd.profiler.profile``, the one
``torch.profiler.profile`` wraps: the wrapper's first session imports
``torch._inductor`` (seconds of host time where the compiler stack is
installed), which a trace does not need.  The trace is read into:

* the device's operations by their total device time (``top_device``),
  the device's busy time (the union of its operations' intervals) and
  its idle share of the traced window;
* the host's gaps: every interval in which the device runs nothing,
  given to what the host was doing then, the innermost host operation
  open over it (a gloo collective, a copy that stages a collective
  through host memory, a wait for the card, a kernel launch ...), or
  ``(python)`` where no operation is open (``host_gaps``, ms by name);
* the host's operations by their own (self) time, the time in which
  each is the innermost one open (``top_host``).

The port's spans (``tracing.py``: ``ch.step``, ``ch.dct2``, ``ch.sync``
...) are host operations of the trace, so the gaps and the self time
fall to them where no torch operation is open inside.

The kernels' names are the CUDA functions' (``mu_kernel``,
``slice_kernel`` ...; ``ops/kernels.py`` says which wrapper launches
each).  On the CPU there is no device activity: every interval is a gap.
The profiler costs host time of its own: the traced steps run slower
than untraced ones, so a step's length here is not its rate.

``python -m chsimpy_tpu_torch.benchmarks.rank_profile -N 1002 --mesh 2x2
--transform ozaki`` traces rank 0 of a new world on the card (``--device
cpu``: gloo ranks on the host) and prints the summary as JSON.
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
import time
from collections import defaultdict

import torch

# the CLI's run: step iterations before the trace, and traced
WARM_STEPS = 2
PROFILE_STEPS = 4


def _merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(busy, lo, hi) -> list:
    """The intervals of [lo, hi] outside the disjoint sorted ``busy``."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def spans(kineto_results) -> list:
    """(name, start us, end us, on the device) of every event the
    profiler recorded, read from its raw results (the profiler's own
    per-event objects are built in Python and cost seconds a trace)."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
             e.device_type() != cpu)
            for e in kineto_results.events() if not e.is_hidden_event()]


def summarize(events, top: int = 12) -> dict:
    """The summary of ``events`` (:func:`spans`; times in ms)."""
    host = [e for e in events if not e[3]]
    device = [e for e in events if e[3]]
    lo = min(e[1] for e in events)
    hi = max(e[2] for e in events)
    busy = _merged((e[1], e[2]) for e in device)
    busy_us = sum(e - s for s, e in busy)
    dev_time = defaultdict(float)
    dev_calls = defaultdict(int)
    for name, s, e, _ in device:
        dev_time[name] += e - s
        dev_calls[name] += 1
    # every instant of the window to the innermost host operation open
    # then (the open operation that started last), by one sweep over the
    # operations' starts and ends and the gaps' bounds: the operations'
    # own (self) time, and the part of it in the device's gaps
    gaps = _gaps(busy, lo, hi)
    marks = sorted([(e[1], 1, i) for i, e in enumerate(host)]
                   + [(e[2], 0, i) for i, e in enumerate(host)]
                   + [(t, 0, -1) for g in gaps for t in g])
    self_host = defaultdict(float)
    gap_by = defaultdict(float)
    heap, ended, g = [], set(), 0
    for (t, kind, i), (t1, _, _) in zip(marks, marks[1:]):
        if kind == 1:
            heapq.heappush(heap, (-host[i][1], i))
        elif i >= 0:
            ended.add(i)
        while heap and heap[0][1] in ended:
            heapq.heappop(heap)
        if t1 <= t:
            continue
        name = host[heap[0][1]][0] if heap else '(python)'
        if heap:
            self_host[name] += t1 - t
        while g < len(gaps) and gaps[g][1] <= t:
            g += 1
        if g < len(gaps) and gaps[g][0] <= t:
            gap_by[name] += t1 - t
    window = hi - lo

    def ranked(d, n=top):
        return [[k, v / 1e3] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:n]]

    return {'window_ms': window / 1e3, 'device_events': len(device),
            'device_busy_ms': busy_us / 1e3,
            'device_idle_share': 1.0 - busy_us / window if window else None,
            'top_device': [[k, v, dev_calls[k]] for k, v in
                           ranked(dev_time)],
            'host_gaps': ranked(gap_by),
            'host_gap_ms': (window - busy_us) / 1e3,
            'top_host': ranked(self_host)}


def profile_solver(solver, steps: int = 4) -> dict:
    """:func:`summarize` of ``steps`` more step iterations of the
    prepared (sharded) ``solver`` (every rank of its world calls it),
    with the traced steps' wall ms a step."""
    cuda = solver.device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    with torch.autograd.profiler.profile(
            use_kineto=True, use_device='cuda' if cuda else None) as prof:
        t0 = time.perf_counter()
        solver.solve_or_resume(steps)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize(spans(prof.kineto_results))
    out.update(steps=steps, wall_ms_per_step=wall / steps * 1e3,
               transform=solver.cfg.transform_backend,
               pencil=bool(solver.cfg.pencil), N=solver.cfg.N,
               dtype=solver.cfg.dtype,
               mesh=None if solver.mesh is None else list(solver.mesh.shape))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.rank_profile',
        description=__doc__.splitlines()[0])
    ap.add_argument('-N', type=int, default=1002)
    ap.add_argument('--mesh', default='2x2')
    ap.add_argument('--transform', default='ozaki')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dist-backend', default=None,
                    choices=['nccl', 'gloo'])
    a = ap.parse_args(argv)
    from ..parallel.distributed import spawn_grid
    from ..parallel.workers import run_tasks
    shape = tuple(int(v) for v in a.mesh.lower().split('x'))
    params = {'N': a.N, 'precision': 'float64', 'full_sim': True,
              'transform_backend': a.transform, 'device': a.device,
              'kappa_tilde': 2.98911291966116e-4}
    res = spawn_grid(run_tasks, shape, backend=a.dist_backend,
                     device=a.device, threads=1, args=([('solve', dict(
                         params=params, steps=WARM_STEPS, return_U=False,
                         profile_steps=PROFILE_STEPS))],))
    json.dump(res[0][0]['profile'], sys.stdout, indent=1)
    print()


if __name__ == '__main__':
    main()
