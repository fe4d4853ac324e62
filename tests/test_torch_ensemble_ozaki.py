"""The float64 ozaki route under the port's ensemble (K5_members,
chsimpy_tpu_torch/ops/ozaki.py with a member axis, EnsembleSolver,
checkpoints, benchmarks/ozaki_profile.py) against the JAX package on the
CPU, where the JAX ensemble ``vmap``s the same route.

Inputs are made by numpy from a seed and handed to both packages; JAX's
Pallas slice kernel runs in interpret mode.  Bounds:

* slices and the member-batched transforms against the port's single
  ones: the same bits (integer products are exact; each member's mean and
  scale are the single transform's);
* against ``jax.vmap`` of the JAX functions: the slices to the bit, the
  scales as tests/test_torch_ozaki.py holds them, the transforms within
  2e-15 max|ref| of each member (the packages sum the mean in other
  orders);
* EnsembleSolver against the JAX EnsembleSolver: the same stops, tau0
  and t0, the rows of tests/test_torch_ensemble.py's
  ``_assert_members_match`` and U to 1e-11 (tests/test_torch_ozaki.py's
  bound for the route);
* on the stiff stop case (delt = 1.4e-5) the two packages' ozaki traces
  drift apart: the transforms' ulps (above) grow there.  The port's
  single runs against the JAX package's pin that drift (STOP_DRIFT); the
  ensemble is held to the same bound, with E within 1e-11 and the same
  stops, tau0 and t0 (its members are the port's single runs to the bit,
  (d)).  The drift is the mean's summation order: with the port's mean
  replaced by ``jnp.mean`` of the same field, the single runs are the
  JAX runs (U to the bit, E2 within 1e-12).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chsimpy_tpu import checkpoint as jck
from chsimpy_tpu.benchmarks import ozaki_profile as jprof
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble
from chsimpy_tpu.ops import ozaki as jo
from chsimpy_tpu.ops import pallas_kernels as pk

import chsimpy_tpu as ct
import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import checkpoint as tck
from chsimpy_tpu_torch.benchmarks import ozaki_profile as tprof
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.ops import ozaki as to
from test_torch_ensemble import (STOP_FACTORS, _assert_members_match,
                                 a_pairs, jax_params, port_params)
from test_torch_ozaki import _assert_scale

torch.set_num_threads(2)

OZ = dict(transform_backend='ozaki', precision='float64')
STOP = dict(OZ, full_sim=False, delt=1.4e-5, ntmax=60)
# the port's single ozaki runs against the JAX package's at STOP, the
# largest over the STOP_FACTORS members: (relative E2 at any row, |U| at
# the stop); measured 9.0e-9 and 1.66e-7 (the third member)
STOP_DRIFT = (1e-8, 2e-7)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _members(N, seed, zero=False):
    """Members: a solver-class field, a normal field whose mean is exact
    in any order (multiples of 2^-30), that field times 2^-10 (~1000x
    smaller: its own scale), and with ``zero`` an all-zero member."""
    rng = np.random.default_rng(seed)
    normal = np.round(rng.standard_normal((N, N)) * 2.0 ** 30) / 2.0 ** 30
    members = [0.875 + 0.01 * (rng.random((N, N)) - 0.5), normal,
               normal * 2.0 ** -10]
    return np.stack(members + [np.zeros((N, N))] * zero)


# ----------------------------------------------------------------------
# (a) K5_members' plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize('n_slices', [4, 6, 8])
def test_slice_members_equal_single_and_vmapped_jax(n_slices):
    x = _members(48, n_slices, zero=True)
    tx = torch.tensor(x)
    planes, scales = K.slice_field_members_ref(tx, n_slices)
    assert planes.dtype == torch.int8 and scales.dtype == torch.float64
    assert planes.shape == (n_slices,) + x.shape and scales.shape == (4,)
    for r in range(4):
        s, sc = K.slice_field_ref(tx[r], n_slices)
        assert torch.equal(planes[:, r], s) and torch.equal(scales[r], sc)
    # members of unequal magnitude keep their own scales
    assert float(scales[1]) == 2.0 ** 10 * float(scales[2])
    assert not planes[:, 3].any() and float(scales[3]) == 2.0 ** -90
    for fn in (jo.slice_field, jo.slice_field_pallas):
        want, jscales = jax.vmap(lambda m: fn(m, n_slices))(jnp.asarray(x))
        # vmap puts the member axis first: (R, S, rows, cols)
        np.testing.assert_array_equal(_np(planes),
                                      np.moveaxis(np.asarray(want), 0, 1))
        for r in range(4):
            _assert_scale(scales[r], jscales[r])


def test_slice_members_wrapper_on_the_cpu_and_refusals():
    tx = torch.tensor(_members(16, 1))
    K.reset_launches()
    got = K.slice_field_members(tx, 6)
    want = K.slice_field_members_ref(tx, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert K.launches['slice_field_members'] == 0   # the CPU counts nothing
    with pytest.raises(TypeError):
        K.slice_field_members(tx.float())
    with pytest.raises(TypeError):
        K.slice_field_members(tx[0])
    with pytest.raises(ValueError):
        K.slice_field_members(tx, 9)


# ----------------------------------------------------------------------
# (b) the batched transforms
# ----------------------------------------------------------------------

def _route_fns(N, route):
    """(port forward, port inverse, JAX forward, JAX inverse) of one
    route; the forwards take (x, s1, s2)."""
    if route == 'unfold':
        Cs, CsT, sc = jo.dct_slices(N)
        tCs, tCsT, tsc = to.dct_slices(N)
        return (lambda x, a, b: to.dct2_ozaki(x, tCs, tCsT, tsc, s1=a, s2=b),
                lambda y: to.idct2_ozaki(y, tCs, tCsT, tsc),
                lambda x, a, b: jo.dct2_ozaki(x, Cs, CsT, sc, s1=a, s2=b),
                lambda y: jo.idct2_ozaki(y, Cs, CsT, sc))
    if route == 'fold':
        fs, tfs = jo.dct_fold_slices(N), to.dct_fold_slices(N)
        return (lambda x, a, b: to.dct2_ozaki_fold(x, tfs, s1=a, s2=b),
                lambda y: to.idct2_ozaki_fold(y, tfs),
                lambda x, a, b: jo.dct2_ozaki_fold(x, fs, s1=a, s2=b),
                lambda y: jo.idct2_ozaki_fold(y, fs))
    L = int(route[-1])
    rf, sc = jo.dct_rfold_slices(N, L)
    trf, _ = to.dct_rfold_slices(N, L)
    return (lambda x, a, b: to.dct2_ozaki_rfold(x, trf, sc, L, s1=a, s2=b),
            lambda y: to.idct2_ozaki_rfold(y, trf, sc, L, s1=3, s2=5),
            lambda x, a, b: jo.dct2_ozaki_rfold(x, rf, sc, L, s1=a, s2=b),
            lambda y: jo.idct2_ozaki_rfold(y, rf, sc, L, s1=3, s2=5))


@pytest.mark.parametrize('route,N', [('unfold', 127), ('fold', 128),
                                     ('rfold1', 128), ('rfold2', 128)])
def test_batched_transforms_equal_single_and_vmapped_jax(route, N):
    tf, ti, jf, ji = _route_fns(N, route)
    x = _members(N, N)
    tx = torch.tensor(x)
    for s1, s2 in ((5, 7), (3, 5)):
        Y = tf(tx, s1, s2)
        assert Y.shape == x.shape and Y.is_contiguous()
        for r in range(3):
            assert torch.equal(Y[r], tf(tx[r], s1, s2)), (s1, s2, r)
        want = np.asarray(jax.vmap(lambda m: jf(m, s1, s2))(jnp.asarray(x)))
        for r in range(3):
            np.testing.assert_allclose(_np(Y[r]), want[r], rtol=0,
                                       atol=2e-15 * np.abs(want[r]).max())
    # the inverse of the JAX forward's output: the same operand for both
    back = ti(torch.tensor(want))
    for r in range(3):
        assert torch.equal(back[r], ti(torch.tensor(want[r])))
    jback = np.asarray(jax.vmap(ji)(jnp.asarray(want)))
    for r in range(3):
        np.testing.assert_allclose(_np(back[r]), jback[r], rtol=0,
                                   atol=2e-15 * np.abs(jback[r]).max())


# ----------------------------------------------------------------------
# (c) EnsembleSolver on the ozaki route against the JAX ensemble
# ----------------------------------------------------------------------

def _both(kw, pairs, nsteps, **jkw):
    j = JaxEnsemble(jax_params(**kw, **jkw), pairs)
    j.prepare()
    jsols = j.solve_or_resume(nsteps)
    e = EnsembleSolver(port_params(**kw), pairs)
    e.prepare()
    return e, e.solve_or_resume(nsteps), j, jsols


@pytest.mark.parametrize('N', [32, 33])
def test_ozaki_ensemble_matches_jax_ensemble(N):
    e, sols, j, jsols = _both(dict(OZ, N=N), a_pairs(), 40)
    # the JAX ensemble's layout off the TPU: fold for even N, else unfolded
    for f in ('transform_backend', 'ozaki_fold', 'ozaki_rfold_levels',
              'ozaki_fwd_pairs', 'ozaki_inv_pairs'):
        assert getattr(e.cfg, f) == getattr(j.cfg, f), f
    assert e.cfg.ozaki_fold == (N % 2 == 0)
    assert (e.cfg.ozaki_fwd_pairs, e.cfg.ozaki_inv_pairs) == ((3, 5), None)
    _assert_members_match(sols, jsols, U_atol=1e-11)


def _route_distance(a, b):
    """(largest relative E2 distance over the rows, largest |U| one)."""
    ta, tb = a.timedata.data(), b.timedata.data()
    n = min(len(ta), len(tb))
    return (float(np.max(np.abs(ta[:n, 2] / tb[:n, 2] - 1))),
            float(np.abs(np.asarray(a.U) - np.asarray(b.U)).max()))


def _assert_stop_case_match(s, j):
    """A port run of the stop case against the JAX run: the same stop,
    reason, tau0; t0, E, and E2 and U within STOP_DRIFT."""
    assert (s.computed_steps, s.stop_reason, s.tau0) == \
        (j.computed_steps, j.stop_reason, j.tau0)
    assert s.stop_reason == 'energy' and len(s.timedata) == s.computed_steps
    np.testing.assert_allclose(s.t0, j.t0, rtol=1e-12)
    np.testing.assert_allclose(s.timedata.data()[:, 1],
                               j.timedata.data()[:, 1], rtol=1e-11)
    got = _route_distance(s, j)
    assert got[0] <= STOP_DRIFT[0] and got[1] <= STOP_DRIFT[1], got


@pytest.mark.parametrize('member', range(len(STOP_FACTORS)))
def test_single_ozaki_run_at_the_stop_case_matches_jax(member):
    """The drift the ensemble's stop case inherits, on single runs."""
    A0, A1 = a_pairs(STOP_FACTORS)[member]
    one = dict(STOP, A0_const=float(A0), A1_const=float(A1))
    s = ctt.Simulator(port_params(**one)).solve()
    j = ct.Simulator(jax_params(**one)).solve()
    assert s.computed_steps == [35, 33, 46][member]
    _assert_stop_case_match(s, j)


def _jax_mean(U):
    """``jnp.mean`` of the same field(s) on the JAX CPU backend, the mean
    the JAX ozaki transforms take, as a tensor: a test hook for the port's
    ``_mean`` (the route itself keeps ``torch.mean``)."""
    if U.dim() == 3:
        return torch.stack([_jax_mean(u) for u in U])
    m = jnp.mean(jax.device_put(U.numpy(), jax.devices('cpu')[0]))
    assert m.dtype == jnp.float64
    return torch.tensor(float(m), dtype=U.dtype)


@pytest.mark.parametrize('member', range(len(STOP_FACTORS)))
def test_stop_drift_is_the_means_summation_order(member, monkeypatch):
    """The STOP_DRIFT trace (ROADMAP.md queue C): with the port's mean
    replaced by the JAX package's, the port's single ozaki run of the stop
    case is the JAX run: the final U to the bit, E2 within 1e-12 at every
    row (measured <= 2.4e-14: only the statistics sum in another order,
    1 ulp at row 0 already).  Without the hook the traces part at row 1,
    the first step's transforms (E2 2.4e-13, 6.7e-14, 3.3e-13 there; the
    hook's 1.3e-15, 8.9e-16, 1.0e-15), and the stiff step grows that to
    STOP_DRIFT."""
    A0, A1 = a_pairs(STOP_FACTORS)[member]
    one = dict(STOP, A0_const=float(A0), A1_const=float(A1))
    j = ct.Simulator(jax_params(**one)).solve()
    s = ctt.Simulator(port_params(**one)).solve()
    monkeypatch.setattr(to, '_mean', _jax_mean)
    h = ctt.Simulator(port_params(**one)).solve()
    _assert_stop_case_match(h, j)
    assert np.array_equal(h.U.numpy(), np.asarray(j.U))
    hooked, plain = _route_distance(h, j), _route_distance(s, j)
    assert hooked[1] == 0.0
    assert hooked[0] <= 1e-12 < plain[0] and plain[1] > 0, (hooked, plain)
    # the first step: the hook's rows stay at the statistics' ulps
    rows = [np.abs(x.timedata.data()[1, 2] / j.timedata.data()[1, 2] - 1)
            for x in (h, s)]
    assert rows[0] <= 1e-14 < rows[1], rows


def test_ozaki_ensemble_per_member_stop_matches_jax():
    _, sols, _, jsols = _both(STOP, a_pairs(STOP_FACTORS), 60)
    assert [s.computed_steps for s in sols] == [35, 33, 46]
    for s, j in zip(sols, jsols):
        _assert_stop_case_match(s, j)


# ----------------------------------------------------------------------
# (d) members against the port's single runs, to the bit
# ----------------------------------------------------------------------

def _rfold(obj, make, L=2):
    """``obj`` (a Solver or an EnsembleSolver at N < 1024) moved onto the
    rfold route at depth L with the (3, 5) inverse, its consts rebuilt."""
    obj.cfg = dataclasses.replace(obj.cfg, ozaki_rfold_levels=L,
                                  ozaki_inv_pairs=(3, 5))
    obj._consts = make(obj.cfg)
    return obj


@pytest.mark.parametrize('case', ['fold', 'unfold', 'stop', 'rfold'])
def test_ozaki_members_equal_single_runs_to_the_bit(case):
    kw = {'fold': dict(OZ), 'unfold': dict(OZ, N=33), 'stop': STOP,
          'rfold': dict(OZ, N=64, ntmax=12)}[case]
    pairs = a_pairs(STOP_FACTORS) if case == 'stop' else a_pairs()
    nsteps = kw.get('ntmax', 40)
    e = EnsembleSolver(port_params(**kw), pairs)
    if case == 'rfold':
        _rfold(e, lambda c: tst.make_members_consts(
            c, e.params.delt, e.A0s, e.A1s, e.kappas))
    e.prepare()
    sols = e.solve_or_resume(nsteps)
    for (A0, A1), s in zip(pairs, sols):
        p = port_params(A0_const=float(A0), A1_const=float(A1), **kw)
        sim = ctt.Simulator(p)
        if case == 'rfold':
            _rfold(sim.solver, lambda c: tst.make_consts(c, sim.solver.delt))
        ref = sim.solve()
        assert s.computed_steps == ref.computed_steps
        assert np.array_equal(s.timedata.data(), ref.timedata.data())
        assert torch.equal(s.U, ref.U)


# ----------------------------------------------------------------------
# (e) ozaki ensemble checkpoints across the packages
# ----------------------------------------------------------------------

def test_ozaki_ensemble_checkpoints_cross_packages(tmp_path):
    """Saved at step 20 of the stop case by each package, restored by
    the other (and by the port itself): every member stops where the
    uninterrupted runs do; the port's own file gives its re-entered run's
    rows to the bit."""
    pairs = a_pairs(STOP_FACTORS)

    def port_ens():
        e = EnsembleSolver(port_params(**STOP), pairs)
        e.prepare()
        e.solve_or_resume(20)
        return e

    def jax_ens():
        j = JaxEnsemble(jax_params(**STOP), pairs)
        j.prepare()
        j.solve_or_resume(20)
        return j

    def stops(sols):
        return [(s.computed_steps, s.stop_reason, s.tau0) for s in sols]

    f = str(tmp_path / 'port.npz')
    e = port_ens()
    tck.save_ensemble_checkpoint(f, e)
    ref = e.solve_or_resume(40, preserve_stops=True)
    want = stops(ref)
    assert [w[0] for w in want] == [35, 33, 46]
    own = tck.restore_ensemble(f, device='cpu')
    assert own.cfg == e.cfg
    out = own.solve_or_resume(40, preserve_stops=True)
    assert stops(out) == want
    assert all(np.array_equal(a.timedata.data(), b.timedata.data())
               for a, b in zip(out, ref))
    assert stops(jck.restore_ensemble(f).solve_or_resume(
        40, preserve_stops=True)) == want
    g = str(tmp_path / 'jax.npz')
    jck.save_ensemble_checkpoint(g, jax_ens())
    back = tck.restore_ensemble(g, device='cpu')
    assert back.cfg.transform_backend == 'ozaki' and back.cfg.ozaki_fold
    assert stops(back.solve_or_resume(40, preserve_stops=True)) == want


# ----------------------------------------------------------------------
# (f) benchmarks/ozaki_profile.py
# ----------------------------------------------------------------------

def test_ozaki_profile_matches_the_jax_tool(tmp_path, capsys):
    out = str(tmp_path / 'prof.json')
    res = tprof.main(['-N', '64', '--inner', '2', '--reps', '1',
                      '--device', 'cpu', '--out', out])
    printed = capsys.readouterr().out
    with open(out) as f:
        saved = json.load(f)
    assert saved == res and saved['N'] == 64 and saved['card'] == 'cpu'
    names = list(jprof.build_pipelines(64))
    assert [r['pipeline'] for r in saved['results']] == names
    for row in saved['results']:
        assert set(row) == {'pipeline', 'ms_median', 'ms_best', 'ms_delta'}
        assert row['ms_median'] > 0 and row['ms_best'] > 0
        assert row['pipeline'] + ':' in printed
    # each prefix on the profiled field: the JAX pipeline's values within
    # the route's bound (P1's scale may sit ulps off in JAX, P4's mean is
    # summed in another order)
    x = tprof.profile_field(64)
    jconsts = jo.dct_slices(64)
    tconsts = to.dct_slices(64)
    jp = jprof.build_pipelines(64)
    for name, fn in tprof.build_pipelines().items():
        got = _np(fn(x, *tconsts))
        want = np.asarray(jp[name](jnp.asarray(x.numpy()), *jconsts))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-15 * np.abs(want).max())
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tprof.main(['-N', '8'])
