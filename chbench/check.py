"""Whether the timed path's answers are right: the comparison with the
plain reference (:mod:`chbench.reference.ch`), made after the window.

Each number compared is a gap between the program's answer and the
reference's on the same inputs, at the timed sizes, and has a limit of
its own in the cell's file (``check.limits``); ``correct`` holds when
every number is at most its limit (a NaN never is).

Rows compare E, E2, PS and Ra (the K1-K4 path and the transforms behind
them), each as |program − reference| / |reference|, the largest over the
rows compared.  A field compares max |U_program − U_reference|.

``single`` cells (a trajectory, ``full_sim``):

* ``start_rows_gap``, ``start_U_gap``: the set-up's warm-up steps from the
  seed's field, every row and the field after them;
* ``chunk_U_gap``, ``chunk_rows_gap``: one of the window's
  ``solve_or_resume`` calls drawn from the seed, followed from the
  program's field at its entry (the reference recomputes the spectral
  image there, as the program does) to its end: the field there, and
  every row of the call, each column's gap over its scale in the call
  (:func:`call_gap`).

``ensemble`` cells (members to their energy stops): members drawn from
the seed in every batch the window finished (``members_per_batch``, at
most ``max_members`` in all), each run by the reference from the seed's
field with its own A-factors and kappa_tilde:

* ``stop_gap``: the largest |tau0 − tau0_reference| in steps (a member
  that never stops on one side: infinite);
* ``rows_gap``: every row to the earlier of the two stops (the stop's
  step is ``stop_gap``'s);
* ``U_gap``: the field at the stop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .inputs import a_fit, sample_stream
from .reference.ch import Physics, Reference

# columns of a timedata row: it, E, E2, SA, domtime, Ra, L2, PS, delt;
# compared: E, E2, PS, Ra
COMPARED = (1, 2, 7, 5)


def column_gaps(prog: np.ndarray, ref: np.ndarray,
                prefix: bool = False) -> np.ndarray:
    """The largest relative gap of each compared column over rows that
    carry the same step numbers (different step numbers: infinite);
    ``prefix``: over the rows both have."""
    if prefix:
        n = min(prog.shape[0], ref.shape[0])
        prog, ref = prog[:n], ref[:n]
    if prog.shape[0] != ref.shape[0] or prog.shape[0] == 0 \
            or not np.array_equal(prog[:, 0], ref[:, 0]):
        return np.full(len(COMPARED), math.inf)
    p, r = prog[:, COMPARED], ref[:, COMPARED]
    with np.errstate(divide='ignore', invalid='ignore'):
        gap = np.abs(p - r) / np.abs(r)
    return np.where(np.isnan(gap).any(axis=0), math.nan, gap.max(axis=0))


def rows_gap(prog: np.ndarray, ref: np.ndarray, detail=None,
             key='rows', prefix=False) -> float:
    """The largest of :func:`column_gaps` (NaN where any is NaN);
    ``detail`` gets each column's under ``key``."""
    cols = column_gaps(prog, ref, prefix)
    if detail is not None:
        old = detail.get(key, np.zeros(len(COMPARED)))
        detail[key] = [worst(a, b) for a, b in zip(old, cols)]
    return worst(*cols)


def call_gap(prog: np.ndarray, ref: np.ndarray, first: np.ndarray,
             detail=None, key='rows') -> float:
    """The largest over the compared columns of max |prog − ref| over the
    column's scale in the call: E's largest |ref| (its size holds still
    over a run), and for E2, PS and Ra how far the reference column has
    moved from the run's first row ``first``, max |ref − first| (these
    grow with the field's deviations from its mean, so that a gap over
    their values would read a hundred times larger in the first call than
    in a later one).  Rows with other step numbers: infinite; NaN where
    any is NaN."""
    if prog.shape[0] != ref.shape[0] or prog.shape[0] == 0 \
            or not np.array_equal(prog[:, 0], ref[:, 0]):
        cols = np.full(len(COMPARED), math.inf)
    else:
        p, r = prog[:, COMPARED], ref[:, COMPARED]
        scale = np.abs(r - first[list(COMPARED)]).max(axis=0)
        scale[0] = np.abs(r[:, 0]).max()
        with np.errstate(divide='ignore', invalid='ignore'):
            cols = np.abs(p - r).max(axis=0) / scale
    if detail is not None:
        detail[key] = list(cols)
    return worst(*cols)


def worst(*gaps) -> float:
    """The largest gap, NaN where any is NaN."""
    return math.nan if any(math.isnan(g) for g in gaps) else max(gaps)


def field_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.to(torch.float64).to(ref.device) - ref).abs().max())


def _phys(params) -> Physics:
    import dataclasses
    return Physics.from_params(dataclasses.asdict(params))


def check_single(cell, ev, seed, device, detail=None) -> dict:
    p = ev['params']
    A0, A1 = a_fit(p.temp)
    ref = Reference(_phys(p), [A0], [A1], [p.kappa_tilde], device=device,
                    full_sim=p.full_sim)
    rows = ev['rows']
    out = {}
    # the start: the set-up's warm-up from the seed's field
    W = ev['start']['steps']
    r0 = ref.run(ev['U0'], W - 1)
    out['start_rows_gap'] = rows_gap(rows[rows[:, 0] < W],
                                     r0['rows'][0, :r0['n_rows'][0]],
                                     detail, 'start_rows')
    out['start_U_gap'] = field_gap(ev['start']['U'], r0['U'][0])
    first = r0['rows'][0, 0]
    del r0
    # a window call drawn from the seed, followed from the program's
    # field at its entry to its end
    entries = ev['entries']
    k = int(sample_stream(seed).integers(0, len(entries) - 1))
    (c0, U_in), (c1, U_out) = entries[k], entries[k + 1]
    if detail is not None:
        detail['chunk'] = (k, c0, c1 - c0)
    if c1 == c0:
        out['chunk_U_gap'] = out['chunk_rows_gap'] = math.inf
        return out
    r1 = ref.run(U_in, c1 - c0, start_step=c0, rows0=False,
                 E2_first=rows[0, 2])
    out['chunk_U_gap'] = field_gap(U_out, r1['U'][0])
    in_call = (rows[:, 0] >= c0) & (rows[:, 0] < c1)
    out['chunk_rows_gap'] = call_gap(rows[in_call],
                                     r1['rows'][0, :r1['n_rows'][0]],
                                     first, detail, 'chunk_rows')
    return out


def check_ensemble(cell, ev, seed, device, detail=None) -> dict:
    members = ev['checked'][:int(cell['check']['max_members'])]
    if not members:
        return {'stop_gap': math.inf, 'rows_gap': math.inf,
                'U_gap': math.inf}
    p = ev['params']
    A = np.array([m['A'] for m in members])
    ref = Reference(_phys(p), A[:, 0], A[:, 1],
                    [m['kappa'] for m in members], device=device)
    last = max(m['computed_steps'] for m in members)
    r = ref.run(ev['U0'], 2 * last + 256)
    stop, rows, U = 0.0, 0.0, 0.0
    for i, m in enumerate(members):
        if not r['stopped'][i] or m['stop_reason'] != 'energy':
            stop = math.inf
        else:
            stop = worst(stop, abs(m['tau0'] - r['tau0'][i]))
        rows = worst(rows, rows_gap(m['rows'],
                                    r['rows'][i, :r['n_rows'][i]], detail,
                                    prefix=True))
        U = worst(U, field_gap(m['U'], r['U'][i]))
    return {'stop_gap': stop, 'rows_gap': rows, 'U_gap': U}


CHECKS = {'single': check_single, 'ensemble': check_ensemble}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at most its limit; a number without a limit, or a
    NaN, fails."""
    return all(k in limits and numbers[k] <= limits[k] for k in numbers)
