"""One run of one cell: the window, then the check, then the result line.

:func:`run_cell` is the whole run but for the look for a card, which
``run.py`` makes: the tests drive it on the CPU at small sizes.
"""

from __future__ import annotations

import gc
import math
import sys

import torch

from .check import CHECKS, verdict
from .runners import RUNNERS
from .spec import Bench
from .trace import TraceContext

# top-level module names no run may load: JAX and the JAX package (whole
# names: the port's chsimpy_tpu_torch is another)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'chsimpy_tpu')


def forbidden_modules() -> list:
    top = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def _control_args(cell):
    """The runner's arguments that put the cell's control in the
    program's place: the program's own lower-precision path
    (``params``), or the reference in a lower precision (``reference``)."""
    ctl = cell['check']['control']
    if 'params' in ctl:
        return {'overrides': ctl['params']}
    from .reference.adapter import ReferenceSolver

    class Control(ReferenceSolver):
        def __init__(self, params, U_init):
            super().__init__(params, U_init, precision=ctl['reference'])
    return {'solver_cls': Control}


def device_info(device, memory_peak_bytes) -> dict:
    if device.type == 'cuda':
        return {'platform': 'gpu',
                'kind': torch.cuda.get_device_name(device),
                'count': 1, 'memory_peak_bytes': memory_peak_bytes}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': memory_peak_bytes}


def run_cell(name, seed, seconds, trace=False, device='cuda', t_proc0=0.0,
             root=None, control=False, detail=None, setup_parts=False):
    """Run the cell ``name``; returns (result dict, check dict {number:
    (value, limit)}), and with ``setup_parts`` the seconds of each part of
    the set-up the runner marked.  ``control``: the check's control in
    the program's place (the check's own calibration; the benchmark's
    runs never set it).  ``detail``: a dict the check fills with each compared
    column's gap."""
    bench = Bench(root) if root is not None else Bench()
    cell = bench.cell(name)
    device = torch.device(device)
    kind = cell['config']['runner']
    extra = _control_args(cell) if control else {}
    out = RUNNERS[kind](cell, seed, seconds, device, t_proc0, trace=trace,
                        **extra)
    # the program's state (but for the answers the check reads) is freed
    # before the reference runs
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    numbers = CHECKS[kind](cell, out['evidence'], seed, device, detail)
    limits = cell['check']['limits']
    correct = verdict(numbers, limits)
    check = {k: (float(v), limits.get(k)) for k, v in numbers.items()}

    # attempted: the window's answers (its calls, or the members of the
    # batches it finished); failed: the numbers over their limits
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': sum(not v <= limits.get(k, -math.inf)
                            for k, v in numbers.items())}
    if trace:
        events, steps = out['trace']
        ctx = TraceContext(events, steps, out['shape'], bench.kernels(),
                           bench.classes(), out['counters'])
        metrics = {}
        for mname, (read, unit) in bench.readers(name).items():
            value = read(ctx)
            if value is not None:
                metrics[mname] = {'value': value, 'unit': unit}
        dev = device_info(device, out['memory_peak_bytes'])
        dev.update(busy_s=ctx.busy_s, window_s=ctx.span_s)
        result.update(metrics=metrics, device=dev,
                      breakdown=ctx.breakdown())
    else:
        metrics = bench.end_to_end(name, out['measured'])
        result.update(metrics={k: {'value': v, 'unit': u}
                               for k, (v, u) in metrics.items()},
                      device=device_info(device, out['memory_peak_bytes']))
    result['check'] = {k: {'value': v, 'limit': lim}
                       for k, (v, lim) in check.items()}
    if setup_parts:
        return result, check, out['setup_parts']
    return result, check
