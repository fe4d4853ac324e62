"""The device trace of a traced span and what the readers read from it.

The span is recorded by the PyTorch profiler (kineto: CPU and CUDA
activities; CUPTI traces the hand-written kernels as PyTorch's own).  The
session is opened through ``torch.autograd.profiler.profile``, which does
not import the compiler stack.  Only a summary is kept; no trace file is
written.

The arithmetic is a frozen copy of the port's
``benchmarks/rank_profile.py``: the device's busy time is the union of its
operations' intervals; every interval in which the device runs nothing is
given to the innermost host operation open over it, or ``(python)`` where
none is open.  Each device operation is put in a class: a hand-written
kernel named under ``kernels/`` takes the class its file gives
(``kernels`` or ``transform``), an operation matching a pattern under
``classes/`` takes that class, and every other one is ``eager``.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict

import torch

from .roofline import kernel_bound_s

_BASE = re.compile(r'\s*(?:\w+::|::)*(\w+)')


def _signature(name: str) -> str:
    """The name without ``void`` and anonymous namespaces."""
    name = name.replace('(anonymous namespace)::', '')
    return name[5:] if name.startswith('void ') else name


def base_name(name: str) -> str:
    """A device operation's function name without its return type,
    namespace, template and argument list (a copy or a fill: its kind)."""
    if name.startswith(('Memcpy', 'Memset')):
        return name.split(' (')[0]
    m = _BASE.match(_signature(name))
    return m.group(1) if m else name


def short_name(name: str, kernels) -> str:
    """The name the breakdown gives an operation: a named kernel's
    function name, else its signature up to the argument list."""
    base = base_name(name)
    if base in kernels or name.startswith(('Memcpy', 'Memset')):
        return base
    return _signature(name).split('(')[0][:120]


def merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy, lo, hi) -> list:
    """The intervals of [lo, hi] outside the disjoint sorted ``busy``."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def host_gaps(host, gap_list) -> dict:
    """{host operation: us of the device's gaps spent innermost in it}:
    one sweep over the operations' starts and ends and the gaps' bounds."""
    marks = sorted([(e[1], 1, i) for i, e in enumerate(host)]
                   + [(e[2], 0, i) for i, e in enumerate(host)]
                   + [(t, 0, -1) for g in gap_list for t in g])
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
        while g < len(gap_list) and gap_list[g][1] <= t:
            g += 1
        if g < len(gap_list) and gap_list[g][0] <= t:
            gap_by[name] += t1 - t
    return gap_by


class Span:
    """A traced span: opened with :meth:`start`, closed with :meth:`stop`
    (which waits for the device first)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self.events = None

    def start(self):
        cuda = self.device.type == 'cuda'
        if cuda:
            torch.cuda.synchronize()
        self._prof = torch.autograd.profiler.profile(
            use_kineto=True, use_device='cuda' if cuda else None)
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)
        cpu = torch.autograd.DeviceType.CPU
        self.events = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                        e.device_type() != cpu)
                       for e in self._prof.kineto_results.events()
                       if not e.is_hidden_event()]
        self._prof = None


class TraceContext:
    """What a per-layer reader reads: the traced span's classified
    device operations and its step counts, and the window's counters.

    ``steps``: step iterations in the span; ``shape``: (R, N, itemsize)
    of the fields; ``counters``: the window's counts (runner-defined
    keys)."""

    def __init__(self, events, steps, shape, kernels, classes, counters):
        self.steps = steps
        self.counters = counters
        host = [e for e in events if not e[3]]
        device = [e for e in events if e[3]]
        self.device_ops = len(device)
        if device:
            lo = min(e[1] for e in events)
            hi = max(e[2] for e in events)
        else:
            lo = hi = 0.0
        self.span_s = (hi - lo) / 1e6
        busy = merged((e[1], e[2]) for e in device)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.class_s = defaultdict(float)
        self.op_s = defaultdict(float)
        self.bound_s = 0.0
        self.bounded_s = 0.0
        for name, s, e, _ in device:
            dur = (e - s) / 1e6
            base = base_name(name)
            self.op_s[short_name(name, kernels)] += dur
            cls = self._class(name, base, kernels, classes)
            self.class_s[cls] += dur
            if cls == 'kernels':
                self.bound_s += kernel_bound_s(kernels[base], *shape)
                self.bounded_s += dur
        gap_list = gaps(busy, lo, hi)
        self.idle_by_host = {k: v / 1e6 for k, v in
                             host_gaps(host, gap_list).items()}

    @staticmethod
    def _class(name, base, kernels, classes):
        if base in kernels:
            return kernels[base]['class']
        for cls, patterns in classes.items():
            if any(p.search(name) for p in patterns):
                return cls
        return 'eager'

    def ms_per_step(self, cls: str):
        if not self.steps or not self.device_ops:
            return None
        return self.class_s.get(cls, 0.0) * 1e3 / self.steps

    def ops_per_step(self):
        if not self.steps or not self.device_ops:
            return None
        return self.device_ops / self.steps

    def roofline_pct(self):
        if not self.bounded_s:
            return None
        return 100.0 * self.bound_s / self.bounded_s

    def idle_pct(self):
        if not self.span_s or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.span_s)

    def breakdown(self, top: int = 10) -> dict:
        def ranked(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': ranked(self.op_s),
                'idle_gaps': ranked(self.idle_by_host)}
