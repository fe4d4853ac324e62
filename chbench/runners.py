"""The timed paths: how a configuration's ``runner`` runs the port.

``single``: one ``Solver`` (``chsimpy_tpu_torch.core.solver``), as the
CLI runs it: ``prepare()``, a warm-up call of ``solve_or_resume`` in the
set-up, then ``solve_or_resume(chunk_size)`` one call after another until
the window has lasted ``seconds``.  ``steps_per_s`` is every step the
window's calls completed over the window's whole time.

``ensemble``: the UQ experiment's batch loop (``experiment.py``
``_run_batches``): an ``EnsembleSolver`` a batch of the design's members
(:class:`~.inputs.MemberStream`, the design cycled in the seed's order),
``prepare()``, ``solve_or_resume(ntmax)`` to the batch's last stop, its
solutions; the set-up warms up each batch width the design takes on a
throwaway solver (its first batch of that width, a few steps).  The
window closes at the first chunk sync after ``seconds`` (the batch in
flight is left there).  ``member_steps_per_s`` counts the steps
that advanced a member not yet stopped, from the members' counters at
each sync, over the window's whole time.

The window runs with Python's cycle collector paused (as ``timeit``
does), so that a collection does not land in one run and not another.
Each runner returns the measured end-to-end metrics, the traced span
(``--trace 1``: one whole chunk a third of the way into the window, in
the ensemble the first chunk of the first batch of the widest width
there, the window otherwise unchanged) and the evidence the check
compares.
"""

from __future__ import annotations

import gc
import time

import torch

from . import inputs
from .trace import Span


class WindowClosed(Exception):
    """Raised from the ensemble's chunk hook once the window is over."""


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class _Marks:
    """Where the set-up's time goes: the seconds of each part, from the
    last mark to this one (``setup_parts``, printed on standard error by
    ``run.py``)."""

    def __init__(self, t_proc0):
        self.last = time.perf_counter()
        self.parts = {'before the runner': self.last - t_proc0}

    def __call__(self, name):
        t = time.perf_counter()
        self.parts[name] = t - self.last
        self.last = t


def _params(cell, device, overrides=None):
    from chsimpy_tpu_torch.params import Parameters
    p = dict(cell['config']['params'])
    p.update(cell['traffic'].get('params', {}))
    p.update(overrides or {})
    return Parameters(**p, device=device.type)


def single(cell, seed, seconds, device, t_proc0, trace=False,
           overrides=None, solver_cls=None):
    """The ``single`` runner (see the module docstring).  ``solver_cls``
    replaces the port's Solver (the check's control)."""
    if solver_cls is None:
        from chsimpy_tpu_torch.core.solver import Solver as solver_cls
    marks = _Marks(t_proc0)
    p = _params(cell, device, overrides)
    U0 = inputs.initial_field(p.N, p.XXX, seed, device)
    U0_host = U0.cpu().numpy()
    marks('first CUDA call')
    solver = solver_cls(p, U_init=U0_host)
    solver.prepare()
    marks('prepare')
    warm = int(cell['traffic']['warmup_steps'])
    solver.solve_or_resume(warm)
    _sync(device)
    marks('warm-up')
    sol = solver.solution
    start = {'steps': warm, 'U': sol.U}
    setup_s = time.perf_counter() - t_proc0

    chunk = int(p.chunk_size)
    entries = []            # (counter at the call's entry, U there)
    span, traced = None, None
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        c_first = sol.computed_steps
        while True:
            entries.append((sol.computed_steps, sol.U))
            if trace and traced is None \
                    and time.perf_counter() - t0 >= seconds / 3:
                span = Span(device)
                span.start()
                c_span = sol.computed_steps
            solver.solve_or_resume(chunk)
            _sync(device)
            sol = solver.solution
            if span is not None and traced is None:
                span.stop()
                traced = (span.events, sol.computed_steps - c_span)
            t = time.perf_counter()
            if t - t0 >= seconds and (not trace or traced is not None):
                break
    finally:
        gc.enable()
    window_s = t - t0
    steps = sol.computed_steps - c_first
    entries.append((sol.computed_steps, sol.U))
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == 'cuda' else 0)
    return {
        'measured': {'steps_per_s': (steps / window_s, 'steps/s'),
                     'setup_s': (setup_s, 's')},
        'setup_parts': marks.parts,
        'memory_peak_bytes': mem,
        'attempted': len(entries) - 1,
        'trace': traced, 'counters': {},
        'shape': (1, p.N, 4 if p.precision == 'float32' else 8),
        'evidence': {'U0': U0, 'start': start, 'entries': entries,
                     'rows': sol.timedata.data().copy(),
                     'params': p},
    }


def ensemble(cell, seed, seconds, device, t_proc0, trace=False,
             overrides=None):
    """The ``ensemble`` runner (see the module docstring)."""
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.ops import kernels as K
    marks = _Marks(t_proc0)
    p = _params(cell, device, overrides)
    U0 = inputs.initial_field(p.N, p.XXX, seed, device)
    U0_host = U0.cpu().numpy()
    marks('first CUDA call')
    stream = inputs.MemberStream(cell['config'], cell['traffic'], seed)
    pick = inputs.sample_stream(seed)
    per_batch = int(cell['check']['members_per_batch'])
    marks('members (kappa solves)')
    # every batch width the design takes: its shapes, once
    for R in stream.widths():
        A, kap = stream.first_of_width(R)
        ens = EnsembleSolver(p.deepcopy(), A, U_init=U0_host, kappas=kap)
        ens.prepare()
        ens.solve_or_resume(int(cell['traffic']['warmup_steps']))
        _sync(device)
        del ens
    marks('warm-up')
    setup_s = time.perf_counter() - t_proc0

    k1 = 'chemical_potential_members'
    # the traced chunk is always one of the widest batch's: the device's
    # work a step iteration depends on the width
    widest = max(stream.widths())
    state = {'useful': 0, 'computed': 0, 'batch_useful': 0,
             'batch_iters': 0, 'closed': False, 'end': None, 'span': None,
             'traced': None, 'done': 0, 'attempted': 0}
    checked = []
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()

    def on_chunk(ens_, states):
        computed = states.computed_steps.cpu().numpy()
        t = time.perf_counter()
        if state['span'] is not None:
            state['span'].stop()
            state['traced'] = (state['span'].events,
                               K.launches[k1] - state['k1_span'])
            state['span'] = None
        state['batch_useful'] = int(computed.sum()) - len(computed)
        state['batch_iters'] = K.launches[k1] - state['k1_batch']
        state['end'] = t
        if t - t0 >= seconds and (not trace or state['traced']):
            state['closed'] = True
            raise WindowClosed

    try:
        while not state['closed']:
            A, kap = stream.batch()
            R = len(A)
            ens = EnsembleSolver(p.deepcopy(), A, U_init=U0_host, kappas=kap)
            ens.prepare()
            state.update(batch_useful=0, batch_iters=0,
                         k1_batch=K.launches[k1])
            if trace and state['traced'] is None and R == widest \
                    and time.perf_counter() - t0 >= seconds / 3:
                state['span'] = Span(device)
                state['span'].start()
                state['k1_span'] = K.launches[k1]
                state['traced_R'] = R
            try:
                sols = ens.solve_or_resume(p.ntmax, on_chunk=on_chunk)
            except WindowClosed:
                sols = None
            state['useful'] += state['batch_useful']
            state['computed'] += R * state['batch_iters']
            if sols is None:
                # the batch in flight: its answers are due only if every
                # member has stopped (read after the window has closed)
                sols = ens.solutions()
                if any(s.stop_reason == 'None' for s in sols):
                    sols = None
            if sols is not None:
                state['done'] += 1
                state['attempted'] += R
                for r in sorted(pick.choice(R, size=min(per_batch, R),
                                            replace=False)):
                    s = sols[r]
                    checked.append({
                        'A': A[r], 'kappa': kap[r],
                        'rows': s.timedata.data().copy(),
                        'computed_steps': s.computed_steps, 'tau0': s.tau0,
                        'stop_reason': s.stop_reason, 'U': s.U.clone()})
            del ens, sols
    finally:
        gc.enable()
    window_s = state['end'] - t0
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == 'cuda' else 0)
    return {
        'measured': {'member_steps_per_s': (state['useful'] / window_s,
                                            'steps/s'),
                     'setup_s': (setup_s, 's')},
        'setup_parts': marks.parts,
        'memory_peak_bytes': mem,
        'attempted': state['attempted'],
        'trace': state['traced'],
        'counters': {'useful_member_steps': state['useful'],
                     'computed_member_steps': state['computed']},
        'shape': (state.get('traced_R', 0), p.N,
                  4 if p.precision == 'float32' else 8),
        'evidence': {'U0': U0, 'checked': checked, 'params': p},
    }


RUNNERS = {'single': single, 'ensemble': ensemble}
