"""The port's spans (``chsimpy_tpu_torch/tracing.py``): free with no
profiler session open, kineto host events (no user annotations) with it,
one a layer boundary, counted as the steps, polls and syncs run, and
without effect on the results."""

import sys
import threading
import types

import numpy as np
import pytest
import torch

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import material, tracing
from chsimpy_tpu_torch.core.stepper import STOP_POLL
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4
SPANS = {'ch.chunk', 'ch.poll', 'ch.sync', 'ch.step', 'ch.mu',
         'ch.update', 'ch.stats', 'ch.dct2', 'ch.idct2'}


def _params(**kw):
    p = ctt.Parameters(N=64, device='cpu', no_gui=True, kappa_tilde=KAPPA,
                       full_sim=True, generator='lcg', chunk_size=150)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _ensemble(p):
    A0, A1 = material.A0(923.15), material.A1(923.15)
    pairs = np.array([[A0, A1], [A0 * 1.004, A1 * 0.997]])
    return EnsembleSolver(p, pairs, kappas=[KAPPA, KAPPA])


def _run(kind, nsteps, p=None):
    """A prepared solver of ``kind`` run ``nsteps`` from its start; its
    rows (a list of arrays) and fields."""
    p = p or _params()
    if kind == 'ensemble':
        e = _ensemble(p)
        e.prepare()
        sols = e.solve_or_resume(nsteps)
    else:
        s = ctt.Solver(p)
        s.prepare()
        sols = [s.solve_or_resume(nsteps)]
    return [s.timedata.data() for s in sols], [s.U.clone() for s in sols]


@pytest.fixture
def session():
    """A kineto session, the span totals kept only from its start."""
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        tracing.reset()
        yield prof
    tracing.reset()


def test_no_session_no_profiler_call_and_no_record(monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, '_RecordFunctionFast',
                        lambda name: calls.append(name))
    monkeypatch.setattr(tracing._Span, '__enter__',
                        lambda self: calls.append(self.name))
    tracing.reset()
    assert tracing.span('ch.a') is tracing.span('ch.b')
    with tracing.span('ch.a'):
        pass
    _run('ensemble', 3)
    _run('single', 3)
    assert calls == []
    assert tracing.summary() == {}


def test_a_torch_without_the_record_function_fails_only_when_traced(
        monkeypatch):
    monkeypatch.setattr(tracing, '_RecordFunctionFast', None)
    rows, _ = _run('single', 3)
    assert len(rows[0]) > 0
    with torch.autograd.profiler.profile(use_kineto=True):
        with pytest.raises(RuntimeError, match='_RecordFunctionFast'):
            with tracing.span('ch.a'):
                pass
    assert tracing.summary() == {}


def test_spans_are_kineto_host_events_on_the_trace_clock():
    """Each span is a host event of the session, no user annotation, and
    its totals are the trace's: as many events, and their durations'
    sum within 100 us an event."""
    tracing.reset()
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        e = _ensemble(_params())
        e.prepare()
        e.solve_or_resume(70)
    got = tracing.summary()
    tracing.reset()
    assert set(got) == SPANS
    events = {}
    for ev in prof.kineto_results.events():
        if ev.name().startswith('ch.'):
            assert ev.device_type() == torch.autograd.DeviceType.CPU
            assert not ev.is_user_annotation()
            events.setdefault(ev.name(), []).append(
                ev.end_ns() - ev.start_ns())
    assert set(events) == SPANS
    for name in SPANS:
        theirs = events[name]
        assert got[name]['count'] == len(theirs), name
        assert abs(got[name]['total_ms'] * 1e6 - sum(theirs)) \
            < 100_000 * len(theirs), name


def _launch_counting(monkeypatch, name):
    """Count the CPU calls of the kernel wrapper ``name`` in
    ``K.launches``, as the card counts its launches."""
    plain = getattr(K, name)

    def counted(*args, **kwargs):
        K.launches[name] += 1
        return plain(*args, **kwargs)
    monkeypatch.setattr(K, name, counted)


@pytest.mark.parametrize('kind', ['ensemble', 'single'])
def test_span_counts_are_the_steps_polls_and_syncs(kind, session,
                                                   monkeypatch):
    k1 = ('chemical_potential_members' if kind == 'ensemble'
          else 'chemical_potential')
    _launch_counting(monkeypatch, k1)
    k = 300                     # chunks of 150: two polls each
    before = K.launches[k1]
    _run(kind, k + 1)
    got = tracing.summary()
    chunks = [150, 150]
    assert got['ch.step']['count'] == k == K.launches[k1] - before
    assert got['ch.poll']['count'] == sum((c - 1) // STOP_POLL
                                          for c in chunks) == 4
    assert got['ch.sync']['count'] == got['ch.chunk']['count'] == 2
    for name in ('ch.mu', 'ch.update', 'ch.idct2'):
        assert got[name]['count'] == k
    # the entry transform, then one a step; the statistics: prepare's
    # and one a step
    assert got['ch.dct2']['count'] == got['ch.stats']['count'] == k + 1


def test_self_time_is_the_duration_less_the_children(session,
                                                     monkeypatch):
    # a 0-100 span holding 10-30 (itself holding 12-20) and 40-50, and a
    # second root 200-260, on a clock that reads these times in turn
    clock = iter([0, 10, 12, 20, 30, 40, 50, 100, 200, 260])
    monkeypatch.setattr(tracing, 'time',
                        types.SimpleNamespace(time_ns=lambda: next(clock)))
    with tracing.span('a'):
        with tracing.span('b'):
            with tracing.span('c'):
                pass
        with tracing.span('b'):
            pass
    with tracing.span('a'):
        pass
    got = tracing.summary()
    want = {'a': {'count': 2, 'total_ms': 160e-6, 'self_ms': 130e-6},
            'b': {'count': 2, 'total_ms': 30e-6, 'self_ms': 22e-6},
            'c': {'count': 1, 'total_ms': 8e-6, 'self_ms': 8e-6}}
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] == pytest.approx(w), name


def test_live_nesting_records_parents(session):
    with tracing.span('ch.outer'):
        with tracing.span('ch.inner'):
            torch.ones(64).sum()
        tracing.spanned('ch.inner')(torch.ones)(8)
    got = tracing.summary()
    outer, inner = got['ch.outer'], got['ch.inner']
    assert outer['count'] == 1 and inner['count'] == 2
    assert inner['self_ms'] == inner['total_ms'] > 0
    assert outer['self_ms'] == pytest.approx(
        outer['total_ms'] - inner['total_ms'], rel=1e-12)
    assert outer['self_ms'] > 0


def test_a_span_open_when_the_session_closes_keeps_no_record():
    tracing.reset()
    prof = torch.autograd.profiler.profile(use_kineto=True)
    prof.__enter__()
    open_span = tracing.span('ch.open')
    open_span.__enter__()
    with tracing.span('ch.closed'):
        pass
    prof.__exit__(None, None, None)
    open_span.__exit__(None, None, None)
    assert list(tracing.summary()) == ['ch.closed']
    tracing.reset()
    assert tracing.summary() == {}


@pytest.mark.parametrize('kind', ['ensemble', 'single'])
def test_spans_on_give_the_same_bits(kind):
    rows_off, U_off = _run(kind, 80)
    with torch.autograd.profiler.profile(use_kineto=True):
        rows_on, U_on = _run(kind, 80)
    assert tracing.summary()['ch.step']['count'] == 79
    tracing.reset()
    for a, b in zip(rows_off, rows_on):
        assert np.array_equal(a, b)
    for a, b in zip(U_off, U_on):
        assert torch.equal(a, b)


def test_threads_keep_their_own_nesting(session):
    n_threads, n_iters = 12, 200

    def work():
        for _ in range(n_iters):
            with tracing.span('ch.outer'):
                with tracing.span('ch.inner'):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = tracing.summary()
    outer, inner = got['ch.outer'], got['ch.inner']
    # an inner span nested in another thread's inner span would take
    # from its self time
    assert outer['count'] == inner['count'] == n_threads * n_iters
    assert inner['self_ms'] == inner['total_ms']
    assert outer['self_ms'] == pytest.approx(
        outer['total_ms'] - inner['total_ms'], rel=1e-12)


def test_the_graph_step_share_reads_the_replays(monkeypatch):
    """The benchmark's ``graph_step_share.uq`` over a made-up summary:
    each ``ch.replay`` STOP_POLL steps over the traced span's step
    iterations; nothing where no replay was recorded or no step ran."""
    from chbench.spec import Bench
    read, unit = Bench().readers('uq512_f64.p_auto')['graph_step_share.uq']
    assert unit == '%'
    ctx = types.SimpleNamespace(steps=1025)
    spans = {'ch.step': {'count': 65, 'total_ms': 9.0, 'self_ms': 3.0},
             'ch.replay': {'count': 16, 'total_ms': 2.0, 'self_ms': 2.0}}
    monkeypatch.setattr(tracing, 'summary', lambda: spans)
    assert read(ctx) == pytest.approx(100.0 * 16 * STOP_POLL / 1025)
    assert read(types.SimpleNamespace(steps=0)) is None
    del spans['ch.replay']
    assert read(ctx) is None
