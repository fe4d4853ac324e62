"""The port's solve (chsimpy_tpu_torch) against the JAX package and the
reference goldens, on the CPU (the plain PyTorch versions of the kernels).

Inputs come from the same seeded generators in both packages.  Tolerances
are those of tests/test_golden.py for the goldens; float32 against JAX is
held to the float32 class (E 1e-5 relative, U 1e-5 absolute)."""

import json
import os

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core import stepper as jst

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.core import stepper as tst

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'golden')


def load(name):
    with open(os.path.join(GOLDEN_DIR, name + '.json')) as f:
        return json.load(f)


def port_params(**kw):
    p = ctt.Parameters(no_gui=True, update_every=None, device='cpu')
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def U_np(sol):
    return sol.U.cpu().numpy() if isinstance(sol.U, torch.Tensor) \
        else np.asarray(sol.U)


@pytest.mark.parametrize('name,rtol_E,rtol_delt,rtol_E2', [
    ('n64_lcg_200', 1e-11, 1e-12, 1e-6),
    ('n128_uniform_300', 1e-11, 1e-12, 1e-6),
    ('n64_timemax', 1e-11, 1e-12, 1e-6),
])
def test_golden_trace(name, rtol_E, rtol_delt, rtol_E2):
    g = load(name)
    sim = ctt.Simulator(port_params(**g['config']))
    sol = sim.solve()
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps']
    assert sol.stop_reason == g['stop_reason']
    assert sol.tau0 == g['tau0']
    np.testing.assert_allclose(sol.t0, g['t0'], rtol=rtol_delt)
    np.testing.assert_array_equal(td[:, 0], np.asarray(g['it']))
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=rtol_E)
    np.testing.assert_allclose(td[:, 8], np.asarray(g['delt']),
                               rtol=rtol_delt)
    np.testing.assert_allclose(td[:, 2], np.asarray(g['E2']), rtol=rtol_E2)
    U = U_np(sol)
    np.testing.assert_allclose(np.sum(U), g['U_sum'], rtol=1e-12)
    np.testing.assert_allclose(U[:2, :2], np.asarray(g['U_corner']),
                               rtol=1e-5)
    if 'time_delta_sum' in g:
        np.testing.assert_allclose(sim.solver.time_delta_sum,
                                   g['time_delta_sum'], rtol=1e-14)
        np.testing.assert_allclose(sim.solver.time_passed,
                                   g['time_passed'], rtol=1e-14)


@pytest.mark.slow
def test_golden_default_n512_anchors():
    """The canonical default run through the port: stop at step 1674,
    tau0/t0 and the E anchors."""
    g = load('default_n512_anchors')
    sol = ctt.Simulator(port_params()).solve()
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps'] == 1674
    assert sol.stop_reason == g['stop_reason'] == 'energy'
    assert sol.tau0 == g['tau0']
    np.testing.assert_allclose(sol.t0, g['t0'], rtol=1e-12)
    np.testing.assert_allclose(td[0, 1], g['E_first'], rtol=1e-12)
    np.testing.assert_allclose(td[-1, 1], g['E_last'], rtol=1e-10)
    np.testing.assert_allclose(td[::100, 1], np.asarray(g['E_every_100']),
                               rtol=1e-10)
    assert int(td[:, 2].argmax()) == g['argmax_E2']


def test_float32_matches_jax():
    kw = dict(N=32, ntmax=25, full_sim=True, precision='float32',
              generator='lcg', kappa_tilde=KAPPA)
    tsol = ctt.Simulator(port_params(**kw)).solve()
    jsol = ct.Simulator(jax_params(**kw)).solve()
    tt, tj = tsol.timedata.data(), jsol.timedata.data()
    assert tt.shape == tj.shape
    assert tsol.U.dtype == torch.float32
    np.testing.assert_allclose(tt[:, 1], tj[:, 1], rtol=1e-5)
    np.testing.assert_allclose(U_np(tsol), U_np(jsol), rtol=0, atol=1e-5)


def test_chunk_size_leaves_the_trace_bit_identical():
    kw = dict(N=32, ntmax=40, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA)
    a = ctt.Simulator(port_params(chunk_size=7, **kw)).solve()
    b = ctt.Simulator(port_params(chunk_size=1024, **kw)).solve()
    assert np.array_equal(a.timedata.data(), b.timedata.data())
    assert torch.equal(a.U, b.U)


# N=64 with delt = 1e-6 reaches the energy stop at step 220 (seconds on
# the CPU); the default N=64/128 runs do not stop within 4000 steps
STOP_CFG = dict(N=64, delt=1e-6, generator='uniform', kappa_tilde=KAPPA,
                ntmax=260)


@pytest.mark.parametrize('full_sim', [False, True])
def test_energy_stop_bookkeeping_matches_jax(full_sim):
    """Stop step, tau0, t0, stop reason and the trace against JAX, with the
    stop in the middle of a device chunk."""
    kw = dict(STOP_CFG, full_sim=full_sim, chunk_size=64)
    tsol = ctt.Simulator(port_params(**kw)).solve()
    jsol = ct.Simulator(jax_params(**kw)).solve()
    assert tsol.computed_steps == jsol.computed_steps
    assert tsol.computed_steps == (260 if full_sim else 220)
    assert tsol.stop_reason == jsol.stop_reason
    assert tsol.tau0 == jsol.tau0 == 220.0
    np.testing.assert_allclose(tsol.t0, jsol.t0, rtol=1e-12)
    np.testing.assert_allclose(tsol.timedata.E, jsol.timedata.E,
                               rtol=1e-11)
    # two float64 matmul orders drift apart by ~3e-12 in U around the stop
    # at this large time step
    np.testing.assert_allclose(U_np(tsol), U_np(jsol), rtol=0, atol=1e-10)


def test_state_is_frozen_after_the_trigger():
    """The steps that follow the stop inside a chunk change nothing: a run
    whose chunk runs 36 steps past the stop ends in the same state, to the
    bit, as a run whose last step is the triggering one."""
    past = ctt.Simulator(port_params(**dict(STOP_CFG, chunk_size=256)))
    exact = ctt.Simulator(port_params(**dict(STOP_CFG, ntmax=220)))
    a, b = past.solve(), exact.solve()
    assert a.stop_reason == b.stop_reason == 'energy'
    assert a.computed_steps == b.computed_steps == 220
    assert np.array_equal(a.timedata.data(), b.timedata.data())
    sa, sb = past.solver._state, exact.solver._state
    for f in ('U', 'hat_U', 'time_delta_sum', 'computed_steps', 'tau0',
              't0', 'E2_prev', 'stop_reason', 'skip_check'):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert past.solver.time_delta_sum == exact.solver.time_delta_sum


def test_one_step_from_a_carried_jax_state():
    """A JAX state and constants carried into the port: one port step
    matches one JAX step within 1e-13."""
    jp = jax_params(N=48, generator='lcg', kappa_tilde=KAPPA)
    js = ct.Solver(jp)
    js.prepare()
    state = js._state.replace(hat_U=js._dct2(js._state.U, js._consts))
    jnext = jst._step(js.cfg, js._consts, state, None)

    tp = convert.params_from_jax(jp.scalar_dict(), device='cpu')
    tsolver = ctt.Solver(tp)
    consts = convert.consts_from_jax(
        {k: np.asarray(js._consts[k]) for k in
         ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1',
          'kappa_tilde')})
    tstate = convert.state_from_jax(
        {k: np.asarray(getattr(state, k)) for k in
         ('U', 'hat_U', 'delt', 'time_delta_sum', 'computed_steps',
          'skip_check', 'stop_reason', 'tau0', 't0', 'E2_first', 'E2_prev',
          'rows', 'rowbuf')})
    tnext = tst._step(tsolver.cfg, consts, tstate)
    np.testing.assert_allclose(tnext.U.numpy(), np.asarray(jnext.U),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tnext.hat_U.numpy(), np.asarray(jnext.hat_U),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tnext.rowbuf[0].numpy(),
                               np.asarray(jnext.rowbuf[0]), rtol=1e-13)
    for f in ('computed_steps', 'rows', 'stop_reason'):
        assert int(getattr(tnext, f)) == int(getattr(jnext, f)), f
    assert float(tnext.time_delta_sum) == float(jnext.time_delta_sum)


def test_resume_and_prepare_quirk_match_jax():
    """Iteration counts of a fresh solve and a resume, the spectral image
    rebuilt at every entry, and prepare() keeping time_delta_sum."""
    kw = dict(N=32, generator='lcg', kappa_tilde=KAPPA, full_sim=True)
    runs = []
    for pkg, params in ((ctt, port_params), (ct, jax_params)):
        s = pkg.Solver(params(**kw))
        s.prepare()
        s.solve_or_resume(30)
        s.solve_or_resume(20)
        tds = s.time_delta_sum
        s.prepare()
        assert s.time_delta_sum == tds
        sol = s.solve_or_resume(10)
        runs.append((sol.computed_steps, sol.timedata.data(),
                     s.time_delta_sum))
    (ts, tt, ttds), (js, jt, jtds) = runs
    assert ts == js == 10
    np.testing.assert_allclose(tt[:, 1], jt[:, 1], rtol=1e-12)
    assert ttds == jtds


def test_nan_guard_matches_jax():
    """A time step far too large drives the field out of (0, 1): both
    packages stop with 'nan' in the same chunk and keep the same rows."""
    kw = dict(N=16, ntmax=50, delt=1e-4, generator='lcg',
              kappa_tilde=KAPPA, chunk_size=8)
    out = []
    for pkg, params in ((ctt, port_params), (ct, jax_params)):
        sim = pkg.Simulator(params(**kw))
        with pytest.raises(FloatingPointError):
            sim.solve()
        sol = sim.solver.solution
        out.append((sol.stop_reason, sol.computed_steps, len(sol.timedata)))
    assert out[0] == out[1]
    assert out[0][0] == 'nan'
