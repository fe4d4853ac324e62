"""The check against a broken timed path: each run goes through the
harness as the benchmark's runs do (but for the look for a card), with a
fault planted in the port underneath, and ``correct`` has to come out
false.  The faults a cell of this benchmark can have: a step that returns
its state unchanged; half of each field left out of the statistics, the
mean taken over the rest; a value altered where it is produced (one cell
of the field the inverse transform returns).  No cell spans chips, so
there is no exchange between chips to leave out."""

import pytest
import torch

from chbench.harness import run_cell
from chsimpy_tpu_torch.core import stepper
from chsimpy_tpu_torch.ops import kernels as K

CELLS = ('fast_tiny.n64', 'uq_tiny.p_auto')
# windows that hold a few calls, and a whole batch of the ensemble
SECONDS = {'fast_tiny.n64': 0.5, 'uq_tiny.p_auto': 3.0}


def _frozen(monkeypatch):
    monkeypatch.setattr(stepper, '_step', lambda cfg, consts, s, *a, **k: s)
    monkeypatch.setattr(stepper, '_members_step',
                        lambda cfg, consts, s, *a, **k: s)


def _half(monkeypatch):
    def halves(fn):
        # the sums of the top half taken twice: the bottom half left out,
        # the mean over the rest
        def top(X):
            n = X.shape[-2] // 2
            return torch.cat([X[..., :n, :], X[..., :n, :]], dim=-2)

        def run(U, E, *a, **k):
            return fn(top(U), None if E is None else top(E), *a, **k)
        return run
    monkeypatch.setattr(K, 'stats_sums', halves(K.stats_sums))
    monkeypatch.setattr(K, 'stats_sums_members',
                        halves(K.stats_sums_members))


def _altered(monkeypatch):
    idct = stepper.idct2_route

    def bumped(*a, **k):
        U = idct(*a, **k).clone()
        U[..., 0, 0] += 1e-3
        return U
    monkeypatch.setattr(stepper, 'idct2_route', bumped)


@pytest.mark.parametrize('fault', [_frozen, _half, _altered])
@pytest.mark.parametrize('cell', CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch, tiny_root):
    fault(monkeypatch)
    result, check = run_cell(cell, 20260, SECONDS[cell], device='cpu',
                             root=tiny_root)
    assert result['correct'] is False, check
    assert result['failed'] >= 1


@pytest.mark.parametrize('cell', CELLS)
def test_the_sound_step_is_correct(cell, tiny_root):
    result, check = run_cell(cell, 20260, SECONDS[cell], device='cpu',
                             root=tiny_root)
    assert result['correct'], check
