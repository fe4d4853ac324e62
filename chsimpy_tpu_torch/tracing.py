"""Named spans at the port's layer boundaries, on while a torch profiler
session is open.

``with span('ch.step'):`` (or ``@spanned('ch.step')`` on a function) costs
one flag test while no session is open: ``span`` hands back one shared
no-op context manager and records nothing.  While a session is open
(``torch.autograd.profiler.profile``, or ``torch.profiler.profile``, which
wraps it) a span enters a FUNCTION-scope record function
(``torch._C._profiler._RecordFunctionFast``): a host event of the
session's trace under the span's name, which the trace's readers give
the device's idle gaps to as to any other host operation.  It is no user
annotation (torch's user-scope record function), which kineto mirrors
onto the device's timeline as a device-side event and which costs host
time with no session open.  A span that closes inside the session
also adds its count, its duration and its self time (the duration less
its child spans', nesting per thread) to its name's totals, which
:func:`summary` returns until :func:`reset`; a span still open when the
session closes adds nothing.

The spans (``PERF.md`` §3 names what reads each): ``ch.chunk`` (one chunk
of steps, graph replays included), in it ``ch.replay`` (one replay of a
CUDA graph of ``STOP_POLL`` steps, ``core/stepper.py`` ``ChunkGraph``),
``ch.capture`` (a graph's construction: its eager first step and the
capture of its steps, whose spans it holds), ``ch.poll`` (the stop flag's
host sync every ``STOP_POLL`` steps), ``ch.sync`` (the per-chunk host
sync), ``ch.step`` (a step launched from the host, or captured), in it
``ch.mu`` (K1), ``ch.update`` (K2 / K12) and ``ch.stats`` (K3, K4, the
float64 finish), and ``ch.dct2`` / ``ch.idct2`` (the transforms, the
entry transform included).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

from torch.autograd import profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:             # the spans raise when a session opens
    _RecordFunctionFast = None

_OFF = contextlib.nullcontext()
_totals: dict = {}              # name -> [count, total ns, self ns]
_lock = threading.Lock()
_open = threading.local()       # .stack: this thread's open spans


class _Span:
    __slots__ = ('name', 'start', 'inner', '_event')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _RecordFunctionFast is None:
            raise RuntimeError("the port's spans need torch._C._profiler."
                               "_RecordFunctionFast, which this torch lacks")
        stack = getattr(_open, 'stack', None)
        if stack is None:
            stack = _open.stack = []
        self._event = _RecordFunctionFast(self.name)
        self._event.__enter__()
        self.inner = 0
        self.start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        took = time.time_ns() - self.start
        stack = _open.stack
        stack.pop()
        self._event.__exit__(*exc)
        if _profiler._is_profiler_enabled:
            if stack:
                stack[-1].inner += took
            with _lock:
                t = _totals.setdefault(self.name, [0, 0, 0])
                t[0] += 1
                t[1] += took
                t[2] += took - self.inner
        return False


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    session is open; otherwise the one shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def summary() -> dict:
    """{name: {'count', 'total_ms', 'self_ms'}} of the spans closed since
    :func:`reset`."""
    with _lock:
        return {name: {'count': n, 'total_ms': total / 1e6,
                       'self_ms': own / 1e6}
                for name, (n, total, own) in _totals.items()}


def reset() -> None:
    """Drop the totals kept so far."""
    with _lock:
        _totals.clear()
