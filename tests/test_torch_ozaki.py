"""The port's float64 ozaki route (chsimpy_tpu_torch/ops/ozaki.py and the
plain version of the slicing kernel K5) against the JAX package
(chsimpy_tpu/ops/ozaki.py), on the CPU.

Inputs are made by numpy from a seed and handed to both packages; JAX's
Pallas slice kernel runs in interpret mode.  Integer results (slices, int32
group sums, renormalized stacks) and the float64 Horner sums must agree to
the bit.  A transform may differ by the field's mean, which the packages sum
in different orders: bound 2e-15 * max|ref|.  Round trips and solver runs
keep the bounds of tests/test_ozaki.py; the goldens those of
tests/test_torch_solver.py.

One difference is expected and pinned: XLA's float64 exp2 on the CPU is
not exact at integers (exp2(4) = 16 - 1 ulp), so JAX's slice scale can sit
a few ulps off the power of two; the port's scale is the exact power of
two of the same exponent, and the slices are the same.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core import solver as jsolver
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.ops import dct as jdct
from chsimpy_tpu.ops import ozaki as jo
from chsimpy_tpu.ops import pallas_kernels as pk

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.cli import CLIParser
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ops import dct as tdct
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.ops import ozaki as to

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
KAPPA_OZ = 2.98911291966116e-4      # tests/test_ozaki.py's runs
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'golden')


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _fields(N, seed, exact_mean=False):
    """The three field classes: solver class, standard normal, zeros.

    ``exact_mean`` rounds the normal field to multiples of 2^-30, so that
    its sum, and with it the mean, is exact in any summation order.  On a
    zero-mean field the route's few slices hold the fluctuation at its
    full scale, and a one-ulp change of the mean moves slice rounding
    boundaries well above 2e-15 max|ref|."""
    rng = np.random.default_rng(seed)
    normal = rng.standard_normal((N, N))
    if exact_mean:
        normal = np.round(normal * 2.0 ** 30) / 2.0 ** 30
    return {'solver': 0.875 + 0.01 * (rng.random((N, N)) - 0.5),
            'normal': normal, 'zeros': np.zeros((N, N))}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_scale(port_scale, jax_scale):
    """The port's scale is the exact power of two of JAX's exponent."""
    e = int(np.rint(np.log2(float(jax_scale))))
    assert float(port_scale) == 2.0 ** e
    assert abs(float(jax_scale) / 2.0 ** e - 1) <= 1e-14


# ----------------------------------------------------------------------
# host slice stacks
# ----------------------------------------------------------------------

@pytest.mark.parametrize('N', [64, 128])
def test_host_slice_stacks_equal_jax(N):
    Cs, CsT, sc = jo.dct_slices(N)
    tCs, tCsT, tsc = to.dct_slices(N)
    assert sc == tsc == to.dct_scale(N)
    assert np.array_equal(np.asarray(Cs), _np(tCs))
    assert np.array_equal(np.asarray(CsT), _np(tCsT))
    assert tCs.dtype == torch.int8
    fs, tfs = jo.dct_fold_slices(N), to.dct_fold_slices(N)
    assert fs['scale'] == tfs['scale'] == to.dct_fold_scale(N)
    for k in ('CeS', 'CoS', 'CeTS', 'CoTS'):
        assert np.array_equal(np.asarray(fs[k]), _np(tfs[k])), k
    for L in (1, 2, 3):
        rf, sc = jo.dct_rfold_slices(N, L)
        trf, tsc = to.dct_rfold_slices(N, L)
        assert sc == tsc == to.dct_rfold_scale(N, L)
        assert len(rf) == len(trf) == L + 1
        for (b, bt), (tb, tbt) in zip(rf, trf):
            assert np.array_equal(np.asarray(b), _np(tb))
            assert np.array_equal(np.asarray(bt), _np(tbt))
        assert np.array_equal(jdct._split_permutation_np(N, L),
                              tdct._split_permutation_np(N, L))
        G = np.random.default_rng(L).random((N, N))
        assert np.array_equal(jdct.split_permute_grid(G, N, L),
                              tdct.split_permute_grid(G, N, L))
        assert np.array_equal(jdct.split_permute_axis(G[0], N, L),
                              tdct.split_permute_axis(G[0], N, L))


# ----------------------------------------------------------------------
# K5's plain version and the int32 machinery, to the bit
# ----------------------------------------------------------------------

@pytest.mark.parametrize('n_slices', [4, 6, 8])
@pytest.mark.parametrize('kind', ['solver', 'normal', 'zeros'])
def test_slice_field_matches_jax(kind, n_slices):
    fields = dict(_fields(64, 11))
    fields['zeros'] = np.zeros((16, 16))
    x = fields[kind]
    got, scale = K.slice_field(torch.tensor(x), n_slices)
    assert got.dtype == torch.int8
    assert got.shape == (n_slices,) + x.shape
    assert K.launches['slice_field'] == 0        # the CPU path counts nothing
    for fn in (jo.slice_field, jo.slice_field_pallas):
        want, jscale = fn(jnp.asarray(x), n_slices)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        _assert_scale(scale, jscale)
    if kind == 'zeros':
        assert not got.any() and float(scale) == 2.0 ** -90


def test_slice_field_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        K.slice_field(torch.zeros((8, 8), dtype=torch.float32))
    with pytest.raises(ValueError):
        K.slice_field(torch.zeros((8, 8), dtype=torch.float64), 9)


@pytest.mark.parametrize('side', ['left', 'right'])
def test_pair_groups_bit_identical(side):
    """Asymmetric slice counts (10 against 8), the stage-2 shape, against
    both of JAX's products (the port has the one)."""
    rng = np.random.default_rng(14)
    a = rng.integers(-64, 65, (10, 32, 32)).astype(np.int8)
    b = rng.integers(-64, 65, (8, 32, 32)).astype(np.int8)
    jdot = jo._dot_left if side == 'left' else jo._dot_right
    for max_pair in (jo.STAGE2_PAIR, 3):
        ga = jo._pair_groups(jnp.asarray(a), jnp.asarray(b), jdot,
                             max_pair=max_pair)
        gb = to._pair_groups(torch.tensor(a), torch.tensor(b),
                             max_pair=max_pair)
        assert len(ga) == len(gb) == max_pair + 1
        for x, y in zip(ga, gb):
            assert y.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(x), _np(y))


def test_int8_matmul_exact_on_odd_shapes():
    rng = np.random.default_rng(5)
    for m, k, n in ((5, 7, 3), (16, 32, 24), (33, 65, 9)):
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (k, n)).astype(np.int8)
        got = to.int8_matmul(torch.tensor(a), torch.tensor(b).T.contiguous().T)
        np.testing.assert_array_equal(
            _np(got), a.astype(np.int64) @ b.astype(np.int64))


def test_renorm_and_horner_bit_identical():
    rng = np.random.default_rng(3)
    groups = [rng.integers(-2 * 10**8, 2 * 10**8, (4, 4)).astype(np.int32)
              for _ in range(8)]
    groups[0] = groups[0] // (1 << 14)
    jg = [jnp.asarray(g) for g in groups]
    tg = [torch.tensor(g) for g in groups]
    for n in (6, 8, 10, 12):
        want = np.asarray(jo._renorm_to_slices(jg, n_slices=n))
        got = to._renorm_to_slices(tg, n_slices=n)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), want)
    # the prefix property: fewer slots leave the kept ones unchanged
    small = [torch.tensor(rng.integers(-10000, 10000, (4, 4)),
                          dtype=torch.int32) for _ in range(6)]
    t10 = to._renorm_to_slices(small, n_slices=10)
    t8 = to._renorm_to_slices(small, n_slices=8)
    assert torch.equal(t10[:8], t8)
    np.testing.assert_array_equal(
        _np(t10), np.asarray(jo._renorm_to_slices(
            [jnp.asarray(_np(g)) for g in small], n_slices=10)))
    hj = np.asarray(jo._horner_f64(jg))
    ht = to._horner_f64(tg)
    assert ht.dtype == torch.float64
    assert np.array_equal(hj, _np(ht))


# ----------------------------------------------------------------------
# the transforms
# ----------------------------------------------------------------------

def _routes(N, route, L):
    """(forward, inverse) pairs of both packages for one route; each
    forward takes (field, s1, s2)."""
    if route == 'unfold':
        Cs, CsT, sc = jo.dct_slices(N)
        tCs, tCsT, tsc = to.dct_slices(N)
        return ((lambda x, s1, s2: jo.dct2_ozaki(x, Cs, CsT, sc, s1=s1,
                                                 s2=s2),
                 lambda y: jo.idct2_ozaki(y, Cs, CsT, sc)),
                (lambda x, s1, s2: to.dct2_ozaki(x, tCs, tCsT, tsc, s1=s1,
                                                 s2=s2),
                 lambda y: to.idct2_ozaki(y, tCs, tCsT, tsc)))
    if route == 'fold':
        fs = jo.dct_fold_slices(N)
        tfs = to.dct_fold_slices(N)
        return ((lambda x, s1, s2: jo.dct2_ozaki_fold(x, fs, s1=s1, s2=s2),
                 lambda y: jo.idct2_ozaki_fold(y, fs)),
                (lambda x, s1, s2: to.dct2_ozaki_fold(x, tfs, s1=s1, s2=s2),
                 lambda y: to.idct2_ozaki_fold(y, tfs)))
    rf, sc = jo.dct_rfold_slices(N, L)
    trf, _ = to.dct_rfold_slices(N, L)
    return ((lambda x, s1, s2: jo.dct2_ozaki_rfold(x, rf, sc, L, s1=s1,
                                                   s2=s2),
             lambda y: jo.idct2_ozaki_rfold(y, rf, sc, L)),
            (lambda x, s1, s2: to.dct2_ozaki_rfold(x, trf, sc, L, s1=s1,
                                                   s2=s2),
             lambda y: to.idct2_ozaki_rfold(y, trf, sc, L)))


@pytest.mark.parametrize('route,N,L', [
    ('unfold', 64, 0), ('unfold', 65, 0),
    ('fold', 32, 0), ('fold', 64, 0), ('fold', 256, 0),
    ('rfold', 64, 1), ('rfold', 64, 3), ('rfold', 128, 2),
    ('rfold', 256, 3)])
def test_transforms_match_jax(route, N, L):
    """Forward (untrimmed and with the (3, 5) trim) and inverse within
    2e-15 max|ref| of JAX; round trips held to JAX's own bounds
    (tests/test_ozaki.py)."""
    (jf, ji), (tf, ti) = _routes(N, route, L)
    for kind, x in _fields(N, N, exact_mean=True).items():
        if kind == 'zeros':
            continue
        for s1, s2 in ((5, 7), (3, 5)):
            want = np.asarray(jf(jnp.asarray(x), s1, s2))
            got = _np(tf(torch.tensor(x), s1, s2))
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-15 * np.abs(want).max())
        # the inverse of the same operand: the same slices and int32 sums;
        # JAX's scale may sit ulps off the power of two (module docstring)
        back_j = np.asarray(ji(jnp.asarray(want)))
        back_t = _np(ti(torch.tensor(want)))
        np.testing.assert_allclose(back_t, back_j, rtol=0,
                                   atol=2e-15 * np.abs(back_j).max())
        # the round trip (5, 7) each way, JAX's bounds
        y = tf(torch.tensor(x), 5, 7)
        err = np.abs(_np(ti(y)) - x).max()
        jerr = np.abs(np.asarray(ji(jf(jnp.asarray(x), 5, 7))) - x).max()
        # tests/test_ozaki.py's bounds: solver class 1e-12 (rfold) and
        # 5e-13 relative; 5e-11 on a unit-range field, taken relative here
        # (max|x| ~ 4.5 for the normal field)
        if kind == 'solver':
            bound = 1e-12 if route == 'rfold' else 5e-13 * np.abs(x).max()
        else:
            bound = 5e-11 * np.abs(x).max()
        assert err <= bound, (kind, err)
        # the forwards differ in the last bit, so the inverse's dropped
        # slice products differ too: the same error class, not the same
        # realization
        assert err <= 2 * jerr + 2e-15 * np.abs(x).max(), (kind, err, jerr)


def test_twenty_rfold_round_trips_hold():
    """tests/test_ozaki.py: 20 chained (5, 7) round trips stay within
    1e-11 (N=128, two levels, solver-class field)."""
    N, L = 128, 2
    x = _fields(N, 11)['solver']
    trf, sc = to.dct_rfold_slices(N, L)
    z = torch.tensor(x)
    for _ in range(20):
        z = to.idct2_ozaki_rfold(to.dct2_ozaki_rfold(z, trf, sc, L),
                                 trf, sc, L)
    np.testing.assert_allclose(_np(z), x, rtol=0, atol=1e-11)


# ----------------------------------------------------------------------
# the solver on the ozaki route
# ----------------------------------------------------------------------

def _port_params(**kw):
    p = ctt.Parameters(no_gui=True, update_every=None, device='cpu',
                       precision='float64')
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    p.precision = 'float64'
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def test_solver_cfg_resolution_matches_jax():
    for N, fold, L in ((64, True, 0), (65, False, 0), (1024, True, 2)):
        kw = dict(N=N, transform_backend='ozaki', kappa_tilde=KAPPA)
        jc = ct.core.solver.Solver(_jax_params(**kw)).cfg
        tc = ctt.Solver(_port_params(**kw)).cfg
        for f in ('transform_backend', 'ozaki_fold', 'ozaki_rfold_levels',
                  'ozaki_fwd_pairs', 'ozaki_inv_pairs'):
            assert getattr(tc, f) == getattr(jc, f), (N, f)
        assert (tc.ozaki_fold, tc.ozaki_rfold_levels) == (fold, L)
        assert tc.ozaki_fwd_pairs == tc.ozaki_inv_pairs == (3, 5)
    tc = ctt.Solver(_port_params(N=64, kappa_tilde=KAPPA)).cfg
    assert tc.transform_backend == 'matmul'      # 'auto' in the port


def test_full_sim_n64_matches_jax_ozaki():
    """tests/test_ozaki.py's 250-step run (N=64, lcg, full_sim, fold
    route with the (3, 5) forward trim), port against JAX ozaki.

    U is held to 1e-11, not 1e-12: the route amplifies a one-ulp change of
    its operand (here the mean, summed in another order) into ~1e-12 of U
    over 250 steps by moving slice rounding boundaries — measured 2.7e-12
    port against JAX, and 2.4e-12 between two JAX ozaki runs whose initial
    fields differ by one ulp (the matmul route: 1.8e-15).  E stays at the
    float64 floor."""
    kw = dict(N=64, ntmax=250, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA_OZ, transform_backend='ozaki')
    tsol = ctt.Simulator(_port_params(**kw)).solve()
    jsol = ct.Simulator(_jax_params(**kw)).solve()
    tt, tj = tsol.timedata.data(), np.asarray(jsol.timedata.data())
    assert tt.shape == tj.shape == (250, 9)
    np.testing.assert_allclose(tt[:, 1], tj[:, 1], rtol=1e-12)
    np.testing.assert_allclose(tt[:, 2], tj[:, 2], rtol=1e-10)
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=1e-11)


def test_rfold_n1024_four_steps_match_jax():
    """tests/test_ozaki.py's N=1024 4-step run: the port's rfold route
    (two levels) against the JAX matmul route, with the default trims and
    with the inverse untrimmed, at that test's bounds."""
    kw = dict(N=1024, ntmax=4, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA_OZ)
    ref = ct.Simulator(_jax_params(transform_backend='matmul', **kw)).solve()
    rU, rE = np.asarray(ref.U), np.asarray(ref.timedata.data())[:, 1]
    for inv_pairs, atol_U in ((None, 2e-8), ((5, 7), 2e-10)):
        sim = ctt.Simulator(_port_params(transform_backend='ozaki',
                                         ozaki_inv_pairs=inv_pairs, **kw))
        assert sim.solver.cfg.ozaki_rfold_levels == 2
        sol = sim.solve()
        np.testing.assert_allclose(sol.U.numpy(), rU, rtol=0, atol=atol_U)
        np.testing.assert_allclose(sol.timedata.data()[:, 1], rE,
                                   rtol=1e-13)


@pytest.mark.parametrize('name', ['n64_lcg_200', 'n128_uniform_300'])
def test_golden_trace_ozaki(name):
    """The goldens through the port's ozaki route, at the bounds of
    tests/test_torch_solver.py (E 1e-11, delt 1e-12, E2 1e-6)."""
    with open(os.path.join(GOLDEN_DIR, name + '.json')) as f:
        g = json.load(f)
    sim = ctt.Simulator(_port_params(transform_backend='ozaki',
                                     **g['config']))
    assert sim.solver.cfg.ozaki_fold
    sol = sim.solve()
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps']
    assert sol.stop_reason == g['stop_reason']
    assert sol.tau0 == g['tau0']
    np.testing.assert_allclose(sol.t0, g['t0'], rtol=1e-12)
    np.testing.assert_array_equal(td[:, 0], np.asarray(g['it']))
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=1e-11)
    np.testing.assert_allclose(td[:, 8], np.asarray(g['delt']), rtol=1e-12)
    np.testing.assert_allclose(td[:, 2], np.asarray(g['E2']), rtol=1e-6)
    U = sol.U.numpy()
    np.testing.assert_allclose(np.sum(U), g['U_sum'], rtol=1e-12)
    np.testing.assert_allclose(U[:2, :2], np.asarray(g['U_corner']),
                               rtol=1e-5)


@pytest.mark.parametrize('levels', [0, 2])
def test_one_step_from_a_carried_jax_ozaki_state(levels):
    """A JAX ozaki state and constants (level-1 fold, or the rfold route
    at two levels in the permuted basis) carried into the port: one port
    step matches JAX's next step."""
    jp = _jax_params(N=64, generator='lcg', kappa_tilde=KAPPA,
                     transform_backend='ozaki')
    js = ct.Solver(jp)
    if levels:
        js.cfg = dataclasses.replace(js.cfg, ozaki_rfold_levels=levels)
        js._consts = jst.make_consts(js.cfg, js.delt)
        js._dct2 = jst.make_entry_dct2(js.cfg)
    js.prepare()
    state = js._state.replace(hat_U=js._dct2(js._state.U, js._consts))
    jnext = jst._step(js.cfg, js._consts, state, None)

    tsolver = ctt.Solver(convert.params_from_jax(jp.scalar_dict(),
                                                 device='cpu'))
    tcfg = dataclasses.replace(tsolver.cfg, ozaki_rfold_levels=levels)
    jc = js._consts
    d = {k: np.asarray(jc[k]) for k in
         ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1', 'kappa_tilde',
          'Cs', 'CsT', 'CeS', 'CoS', 'CeTS', 'CoTS')}
    d['rf'] = [(np.asarray(b), np.asarray(bt)) for b, bt in jc['rf']]
    consts = convert.consts_from_jax(d)
    own = tst.make_consts(tcfg, js.delt)
    assert consts.keys() == own.keys()
    for k, v in own.items():
        if k == 'rf':
            assert len(v) == len(consts[k]) == (levels + 1 if levels else 0)
            for pair, cpair in zip(v, consts[k]):
                assert all(torch.equal(a, b) for a, b in zip(pair, cpair))
        elif isinstance(v, torch.Tensor):
            assert v.dtype == consts[k].dtype and torch.equal(v, consts[k]), k
        else:
            assert v == consts[k], k
    tstate = convert.state_from_jax(
        {k: np.asarray(getattr(state, k)) for k in
         ('U', 'hat_U', 'delt', 'time_delta_sum', 'computed_steps',
          'skip_check', 'stop_reason', 'tau0', 't0', 'E2_first', 'E2_prev',
          'rows', 'rowbuf')})
    tnext = tst._step(tcfg, consts, tstate)
    np.testing.assert_allclose(tnext.U.numpy(), np.asarray(jnext.U),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tnext.hat_U.numpy(), np.asarray(jnext.hat_U),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tnext.rowbuf[0].numpy(),
                               np.asarray(jnext.rowbuf[0]), rtol=1e-13)
    assert int(tnext.computed_steps) == int(jnext.computed_steps)


# ----------------------------------------------------------------------
# scope and command line
# ----------------------------------------------------------------------

def test_ozaki_scope_matches_jax():
    with pytest.raises(ValueError, match='float64'):
        ctt.Solver(_port_params(N=16, kappa_tilde=KAPPA, precision='float32',
                                transform_backend='ozaki'))
    with pytest.raises(ValueError, match='float64'):
        jsolver.resolve_transform(_jax_params(precision='float32',
                                              transform_backend='ozaki'))
    # under a mesh the pencil layout runs where the rank count divides N,
    # the grid layout where it does not (N=18 on 4 ranks): past the scope
    # the solver asks for its world
    for field, value, item in (('mesh_shape', (2, 2), 'torchrun'),):
        p = _port_params(N=18, kappa_tilde=KAPPA, transform_backend='ozaki')
        setattr(p, field, value)
        with pytest.raises(RuntimeError, match=item):
            ctt.Solver(p)
    # the checkpoint settings run on the ozaki route (item 8, done)
    p = _port_params(N=16, kappa_tilde=KAPPA, transform_backend='ozaki',
                     restore_file='x.npz', checkpoint_file='y.npz')
    ctt.Solver(p)
    # adaptive time stepping runs on the ozaki route (item 7)
    p = _port_params(N=16, kappa_tilde=KAPPA, transform_backend='ozaki',
                     adaptive_time=True)
    assert ctt.Solver(p).cfg.adaptive_time


def test_cli_parses_the_ozaki_flags(capsys):
    p = CLIParser().get_parameters(
        ['--no-gui', '--transform', 'ozaki', '--ozaki-fwd-pairs', '2,4',
         '--ozaki-inv-pairs', '5,7', '--device', 'cpu'])
    assert (p.transform_backend, p.ozaki_fwd_pairs, p.ozaki_inv_pairs) == \
        ('ozaki', (2, 4), (5, 7))
    for bad, msg in (('x', 'must look like'), ('3,9', 'must be in')):
        with pytest.raises(SystemExit):
            CLIParser().get_parameters(['--no-gui', '--ozaki-fwd-pairs',
                                        bad])
        assert msg in capsys.readouterr().err


def test_cli_runs_ozaki_on_the_cpu(capsys):
    from chsimpy_tpu_torch.__main__ import main
    main(['-N', '32', '-n', '5', '--no-gui', '-g', 'lcg', '-K', str(KAPPA),
          '--device', 'cpu', '--transform', 'ozaki'])
    out = capsys.readouterr().out
    assert 'computed_steps = 5' in out and 'stop reason = None' in out
    with pytest.raises(ValueError, match='float64'):
        main(['-N', '32', '-n', '5', '--no-gui', '-K', str(KAPPA),
              '--device', 'cpu', '--transform', 'ozaki', '--precision',
              'float32'])
