"""The readers of the port's spans: a traced run of the small ensemble
cell reports the five span metrics, and the chunk loop's host time holds
the other four."""

import itertools
import types

import pytest

from chbench.harness import run_cell
from chsimpy_tpu_torch import tracing
from chsimpy_tpu_torch.ops import kernels as K

SPAN_METRICS = ('host_ms_per_step.uq', 'sync_wait_ms_per_step.uq',
                'stepper_self_ms_per_step.uq', 'dct_host_ms_per_step.uq',
                'kernels_host_ms_per_step.uq')


def test_a_traced_ensemble_run_reads_the_span_metrics(tiny_root,
                                                      monkeypatch):
    # the card counts K1_members' launches, which give the traced span's
    # step iterations; its plain version on the CPU counts nothing, so
    # count its calls here as the card counts launches
    k1 = 'chemical_potential_members'
    plain = getattr(K, k1)

    def counted(*args, **kwargs):
        K.launches[k1] += 1
        return plain(*args, **kwargs)
    monkeypatch.setattr(K, k1, counted)
    # the spans' clock moves 1 us a reading: a span with none inside
    # lasts 1 us, as the traced span's one entry transform does
    tick = itertools.count(0, 1000)
    monkeypatch.setattr(tracing, 'time',
                        types.SimpleNamespace(time_ns=lambda: next(tick)))
    tracing.reset()
    result, check = run_cell('uq_tiny.p_auto', 2 ** 31 + 11, 3.0,
                             trace=True, device='cpu', root=tiny_root)
    got = tracing.summary()
    tracing.reset()
    assert result['correct'], check
    m = {k: v['value'] for k, v in result['metrics'].items()}
    for name in SPAN_METRICS:
        assert m[name] > 0, name
    steps = got['ch.step']['count']
    assert steps > 0
    # the traced span's one entry transform lies outside its chunk
    entry = 1e-3 / steps
    parts = sum(m[n] for n in SPAN_METRICS[1:])
    assert m['host_ms_per_step.uq'] >= (parts - entry) * (1 - 1e-9)
    assert m['host_ms_per_step.uq'] == pytest.approx(
        (got['ch.chunk']['total_ms'] + got['ch.sync']['total_ms']) / steps)
