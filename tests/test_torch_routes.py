"""The port's solve on the split and FFT routes and its DCT bake-off, on the
CPU, against the reference goldens and the JAX package.

Bounds: the goldens as tests/test_transform.py holds the JAX split route
(the same stop, E within 1e-10 relative at every step); float32 against
JAX in the float32 class (E 1e-5 relative, U 1e-5 absolute, as
tests/test_torch_solver.py); one float64 step from a carried JAX state
within 1e-13."""

import json
import os

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core import stepper as jst

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.benchmarks import dct_bench
from chsimpy_tpu_torch.cli import CLIParser
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.core.solver import resolve_transform
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'golden')


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


@pytest.mark.parametrize('route', ['split', 'fft'])
@pytest.mark.parametrize('name', ['n64_lcg_200', 'n128_uniform_300'])
def test_golden_trace_on_route(name, route):
    with open(os.path.join(GOLDEN_DIR, name + '.json')) as f:
        g = json.load(f)
    sim = ctt.Simulator(port_params(transform_backend=route, **g['config']))
    assert sim.solver.cfg.transform_backend == route
    sol = sim.solve()
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps']
    assert sol.stop_reason == g['stop_reason']
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=1e-10)
    np.testing.assert_allclose(np.sum(sol.U.numpy()), g['U_sum'],
                               rtol=1e-12)


@pytest.mark.parametrize('route,levels', [('split', 2), ('split', 3),
                                          ('fft', None)])
def test_float32_route_matches_jax(route, levels):
    """float32 N=64 against JAX on the same route; JAX pinned to the
    natural layout (an explicit split would turn its fold_field on) and to
    the same depth."""
    kw = dict(N=64, ntmax=40, full_sim=True, precision='float32',
              generator='lcg', kappa_tilde=KAPPA, transform_backend=route,
              split_levels=levels)
    tsol = ctt.Simulator(port_params(**kw)).solve()
    jsim = ct.Simulator(jax_params(fold_field=False, **kw))
    assert not jsim.solver.cfg.fold_field
    jsol = jsim.solve()
    tt, tj = tsol.timedata.data(), jsol.timedata.data()
    assert tt.shape == tj.shape
    assert tsol.U.dtype == torch.float32
    np.testing.assert_allclose(tt[:, 1], tj[:, 1], rtol=1e-5)
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('route', ['split', 'fft'])
def test_one_step_from_a_carried_jax_state(route):
    """JAX consts (the split tree included) and state carried into the
    port: one port step matches one JAX step within 1e-13."""
    jp = jax_params(N=48, generator='lcg', kappa_tilde=KAPPA,
                    transform_backend=route, fold_field=False)
    js = ct.Solver(jp)
    js.prepare()
    state = js._state.replace(hat_U=js._dct2(js._state.U, js._consts))
    jnext = jst._step(js.cfg, js._consts, state, None)

    tp = convert.params_from_jax(jp.scalar_dict(), device='cpu')
    tsolver = ctt.Solver(tp)
    consts = convert.consts_from_jax(
        {k: (np.asarray(js._consts[k]) if k != 'tree' else
             _numpy_tree(js._consts[k])) for k in
         ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1', 'kappa_tilde',
          'tree')})
    if route == 'split':
        assert isinstance(consts['tree'], tuple) and len(consts['tree']) == 2
    tstate = convert.state_from_jax(
        {k: np.asarray(getattr(state, k)) for k in
         ('U', 'hat_U', 'delt', 'time_delta_sum', 'computed_steps',
          'skip_check', 'stop_reason', 'tau0', 't0', 'E2_first', 'E2_prev',
          'rows', 'rowbuf')})
    tnext = tst._step(tsolver.cfg, consts, tstate)
    for f in ('U', 'hat_U'):
        np.testing.assert_allclose(getattr(tnext, f).numpy(),
                                   np.asarray(getattr(jnext, f)), rtol=0,
                                   atol=1e-13, err_msg=f)
    np.testing.assert_allclose(tnext.rowbuf[0].numpy(),
                               np.asarray(jnext.rowbuf[0]), rtol=1e-13)


def _numpy_tree(t):
    if isinstance(t, tuple):
        return tuple(_numpy_tree(s) for s in t)
    return np.asarray(t)


def test_split_consts_match_jax():
    """make_consts on the split route: the same tree, and leig, eaxis and
    the coefficient grids in the same permuted basis, to the bit."""
    jsolver = ct.Solver(jax_params(N=64, kappa_tilde=KAPPA,
                                   transform_backend='split',
                                   fold_field=False, split_levels=3))
    tsolver = ctt.Solver(port_params(N=64, kappa_tilde=KAPPA,
                                     transform_backend='split',
                                     split_levels=3))
    jc, tc = jsolver._consts, tsolver._consts
    assert tsolver.cfg.split_levels_resolved == 3
    for k in ('C', 'leig', 'eaxis', 'CHeig', 'Seig'):
        assert np.array_equal(tc[k].numpy(), np.asarray(jc[k])), k
    want = convert.split_tree_from_jax(_numpy_tree(jc['tree']))

    def flat(t):
        return [b for s in t for b in flat(s)] if isinstance(t, tuple) \
            else [t]
    assert len(flat(tc['tree'])) == 4
    for a, b in zip(flat(tc['tree']), flat(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('N,want', [(4096, 4), (4104, 3), (2048, 3),
                                    (2052, 2), (1024, 2), (64, 2)])
def test_split_levels_resolve_as_in_jax(N, want):
    kw = dict(N=N, dtype='float32', RT=1.0, BRT=1.0, B=1.0, Amr=1.0, L=1.0,
              delx=1.0, delx2=1.0, M_tilde=1.0, threshold=0.5,
              transform_backend='split')
    assert tst.StepConfig(**kw).split_levels_resolved == want
    assert jst.StepConfig(**kw).split_levels_resolved == want
    assert tst.StepConfig(split_levels=1, **kw).split_levels_resolved == 1


def test_route_resolution_and_refusals(capsys):
    p = port_params(N=2048, precision='float32')
    assert resolve_transform(p) == 'matmul'        # auto stays matmul
    p.transform_backend = 'fft'
    p.precision = 'float64'
    assert resolve_transform(p) == 'fft'           # float64 FFT runs here
    for route in ('split', 'fft'):
        with pytest.raises(ValueError, match='even N'):
            ctt.Solver(port_params(N=63, kappa_tilde=KAPPA,
                                   transform_backend=route))
    with pytest.raises(ValueError, match='divisible by 2'):
        ctt.Solver(port_params(N=36, kappa_tilde=KAPPA,
                               transform_backend='split', split_levels=3))
    with pytest.raises(ValueError, match='divisible by 2'):
        ctt.Solver(port_params(N=32, kappa_tilde=KAPPA,
                               transform_backend='split', split_levels=0))
    # the knobs parse with the JAX CLI's values (item 14, done)
    for argv, field, value in (
            (['--fold-field'], 'fold_field', True),
            (['--no-fold-field'], 'fold_field', False),
            (['--inv-band', '8'], 'inv_band', 8),
            (['--otf-coeffs', '1'], 'otf_coeffs', 1),
            (['--matmul-precision', 'high'], 'matmul_precision', 'high'),
            (['--fwd-matmul-precision', 'default'], 'fwd_matmul_precision',
             'default')):
        p = CLIParser().get_parameters(['--no-gui', *argv])
        assert getattr(p, field) == value, argv
    assert 'item 14' not in capsys.readouterr().err
    p = CLIParser().get_parameters(['-N', '64', '--no-gui', '--device',
                                    'cpu', '--transform', 'split',
                                    '--split-levels', '3'])
    assert (p.transform_backend, p.split_levels) == ('split', 3)


@pytest.mark.parametrize('argv', [['--transform', 'split'],
                                  ['--transform', 'fft'],
                                  ['--transform', 'split', '--split-levels',
                                   '3']])
def test_cli_runs_the_routes_on_the_cpu(capsys, argv):
    from chsimpy_tpu_torch.__main__ import main
    main(['-N', '64', '-n', '20', '--no-gui', '-K', '3e-4', '--device',
          'cpu', *argv])
    out = capsys.readouterr().out
    assert 'computed_steps = 20' in out and 'stop reason = None' in out


F32_ROUTES = {'matmul-fp32', 'matmul-tf32', 'split1-fp32', 'split1-tf32',
              'split2-fp32', 'split2-tf32', 'split3-fp32', 'split3-tf32',
              'split1perm-fp32', 'split2perm-fp32', 'split3perm-fp32',
              'split4perm-fp32', 'split5perm-fp32', 'split2permfold-fp32',
              'split3permfold-fp32', 'split4permfold-fp32',
              'split5permfold-fp32', 'split2permT-fp32', 'fft', 'gemm'}
F64_ROUTES = {'matmul-fp64', 'split1-fp64', 'split2-fp64', 'split3-fp64',
              'split1perm-fp64', 'split2perm-fp64', 'split3perm-fp64',
              'split4perm-fp64', 'split5perm-fp64', 'split2permfold-fp64',
              'split3permfold-fp64', 'split4permfold-fp64',
              'split5permfold-fp64', 'split2permT-fp64', 'fft',
              'ozaki-int8', 'ozaki-int8-fold', 'ozaki-rfold1',
              'ozaki-rfold2', 'ozaki-rfold3'}


def test_bakeoff_runs_every_route_on_the_cpu(tmp_path, monkeypatch):
    """Every route gives a time and a round-trip error after 2 chained
    round trips of a [0, 1) field at N=64: float32 within 1e-5 (a few
    ulps per transform), float64 within 1e-10 (the untrimmed ozaki
    routes' ~2e-11 is the largest); the JSON is written."""
    monkeypatch.setattr(dct_bench, 'INNER', 2)
    out = tmp_path / 'bench.json'
    K.reset_launches()
    dct_bench.main(['--sizes', '64', '--dtypes', 'float32,float64',
                    '--device', 'cpu', '--reps', '1', '--out', str(out)])
    d = json.loads(out.read_text())
    assert d['card'] == 'cpu' and d['inner'] == 2
    rows = d['results']
    assert {r['route'] for r in rows if r['dtype'] == 'float32'} == \
        F32_ROUTES
    assert {r['route'] for r in rows if r['dtype'] == 'float64'} == \
        F64_ROUTES
    for r in rows:
        assert 'error' not in r, r
        assert r['ms_median'] > 0 and r['ms_best'] <= r['ms_median']
        bound = 1e-5 if r['dtype'] == 'float32' else 1e-10
        assert r['roundtrip_err'] <= bound, r
    # the CPU path launches nothing, and the TF32 switch is restored
    assert K.launches['matmul'] == 0
    assert not torch.backends.cuda.matmul.allow_tf32


def test_bakeoff_route_filter_and_inner():
    fns = dct_bench._roundtrip_fns(16, 'float32', inner=3)
    x = torch.rand((16, 16))
    y = fns['split2perm-fp32'](x)
    assert y.shape == x.shape and float((y - x).abs().max()) < 1e-5
    rows = dct_bench.main(['--sizes', '16', '--dtypes', 'float64',
                           '--device', 'cpu', '--reps', '1', '--routes',
                           'fft,ozaki-rfold1'])
    assert [r['route'] for r in rows] == ['fft', 'ozaki-rfold1']
    # the solver's float32 products are full float32 whatever the bench did
    assert not torch.backends.cuda.matmul.allow_tf32
