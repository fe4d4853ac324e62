"""The level-1 folded field of the split route (``fold_field``) in the
port, on the CPU: against the port's natural runs and the JAX package's
folded runs, and across the two packages' checkpoints.

Bounds: at equal split depth the folded run's U is the natural run's to
the bit (the fold is a permutation; K3's fold mode reads the natural
order, so E, E2 and Ra are the natural run's bits too; PS, a sum over
the stored layout, within 1e-15 relative); against the JAX package's
folded run within the JAX package's own folded-vs-natural bounds
(tests/test_transform.py: the trace rtol 1e-12, atol 1e-13), U within
1e-12."""

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import checkpoint as jck
from chsimpy_tpu.core.solver import Solver as JaxSolver
from chsimpy_tpu.ops import dct as jdct

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import checkpoint as tck
from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import dct as dct_ops
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
TRACE_RTOL, TRACE_ATOL = 1e-12, 1e-13


def port_params(**kw):
    p = ctt.Parameters(no_gui=True, update_every=None, device='cpu',
                       kappa_tilde=KAPPA, N=64, full_sim=True,
                       transform_backend='split', split_levels=2)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    p.kappa_tilde = KAPPA
    p.N = 64
    p.full_sim = True
    p.transform_backend = 'split'
    p.split_levels = 2
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _run(params, steps):
    s = ctt.Solver(params)
    s.prepare()
    sol = s.solve_or_resume(steps)
    return s, sol.U.clone(), sol.timedata.data().copy()


def test_fold1_is_an_involution_and_the_jax_fold():
    x = torch.arange(6 * 8, dtype=torch.float64).reshape(6, 8)
    assert torch.equal(dct_ops.fold1(dct_ops.fold1(x)), x)
    assert np.array_equal(dct_ops.fold1(x).numpy(),
                          jdct.fold1_np(x.numpy()))
    st = torch.stack([x, 2 * x])
    assert torch.equal(dct_ops.fold1(st)[1], dct_ops.fold1(2 * x))
    # a row of the folded field: its columns alone
    assert torch.equal(dct_ops.fold_cols(x[0]), dct_ops.fold1(x)[0])
    assert torch.equal(dct_ops.fold_cols(st[:, 0]), dct_ops.fold1(st)[:, 0])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('N', [64, 66])
def test_fold_mode_plain_sums_are_the_natural_ones(dtype, N):
    rng = np.random.default_rng(N)
    U = torch.tensor(0.875 + 0.01 * (rng.random((N, N)) - 0.5), dtype=dtype)
    E = torch.tensor(rng.standard_normal((N, N)), dtype=dtype)
    kw = dict(delx=0.004, RT=7.6, B=12.86, threshold=0.875)
    nat = K.stats_sums(U, E, -30.0, 20.0, **kw)
    fold = K.stats_sums(dct_ops.fold1(U), dct_ops.fold1(E), -30.0, 20.0,
                        fold=True, **kw)
    assert torch.equal(fold, nat)
    a = torch.tensor([-30.0, -31.0], dtype=torch.float64)
    b = torch.tensor([20.0, 21.0], dtype=torch.float64)
    Us, Es = torch.stack([U, U * 0.999]), torch.stack([E, -E])
    assert torch.equal(
        K.stats_sums_members(dct_ops.fold1(Us), dct_ops.fold1(Es), a, b,
                             fold=True, **kw),
        K.stats_sums_members(Us, Es, a, b, **kw))
    with pytest.raises(ValueError, match='even N'):
        K.stats_sums(U[:-1, :-1], None, -30.0, 20.0, fold=True, **kw)


_FOLD_CASES = {
    'plain': {},
    'stream': {'jitter': 0.01},                         # host stream
    'sobol': {'jitter': 0.01, 'generator': 'sobol',
              'jitter_backend': 'device'},
    'threefry': {'jitter': 0.01, 'jitter_backend': 'device'},
    'simplex': {'jitter': 0.01, 'generator': 'simplex'},   # static slab
    'adaptive': {'adaptive_time': True, 'delt_max': 2.4e-9},
    'otf': {'otf_coeffs': 1},
}


@pytest.mark.parametrize('precision,extra', [
    *((p, e) for p in ('float64', 'float32') for e in _FOLD_CASES.values()),
    # --inv-band is a float32 knob
    ('float32', {'otf_coeffs': 1, 'inv_band': 16, 'matmul_precision': 'high',
                 'fwd_matmul_precision': 'default'})],
    ids=[*(f'{p}-{k}' for p in ('float64', 'float32') for k in _FOLD_CASES),
         'float32-knobs'])
def test_folded_run_is_the_natural_run(precision, extra):
    steps = 520 if extra.get('adaptive_time') else 40
    runs = {}
    for fold in (False, True):
        s, U, rows = _run(port_params(fold_field=fold, precision=precision,
                                      **extra), steps)
        assert s.cfg.fold_field == fold
        runs[fold] = (U, rows, s)
    assert torch.equal(runs[True][0], runs[False][0])
    a, b = runs[True][1], runs[False][1]
    # E, E2, Ra and delt: K3's fold mode and the unfolded mid row give the
    # natural bits; PS sums the stored layout
    for col in (0, 1, 2, 3, 4, 5, 6, 8):
        assert np.array_equal(a[:, col], b[:, col]), col
    np.testing.assert_allclose(a[:, 7], b[:, 7], rtol=1e-15, atol=0)
    # the state holds the folded field; the solution the natural one
    s = runs[True][2]
    assert torch.equal(dct_ops.fold1(s._state.U), runs[True][0])


def test_folded_run_against_jax():
    kw = dict(ntmax=40, jitter=0.01, fold_field=True)
    js = JaxSolver(jax_params(**kw))
    assert js.cfg.fold_field
    js.prepare()
    jsol = js.solve_or_resume(40)
    s, U, rows = _run(port_params(**kw), 40)
    np.testing.assert_allclose(rows, jsol.timedata.data(), rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)
    np.testing.assert_allclose(U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=1e-12)
    # the JAX state is folded; carried across it comes out natural
    st = convert.state_from_jax({k: np.asarray(v) for k, v in
                                 js._state.__dict__.items()
                                 if not k.startswith('_')}, folded=True)
    np.testing.assert_allclose(st.U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=0)


def test_folded_checkpoints_cross_packages(tmp_path):
    kw = dict(ntmax=30, fold_field=True)
    # the port's folded run saved, restored in the JAX package (natural
    # field on disk), and continued in both
    s, _, _ = _run(port_params(**kw), 30)
    f1 = str(tmp_path / 'port.npz')
    tck.save_checkpoint(f1, s)
    z = np.load(f1)
    np.testing.assert_array_equal(z['U'], s.solution.U.numpy())
    j = jck.restore_solver(f1)
    assert j.cfg.fold_field
    j.solve_or_resume(20)
    s.solve_or_resume(20)
    np.testing.assert_allclose(s.solution.U.numpy(),
                               np.asarray(j.solution.U), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s.solution.timedata.data(),
                               j.solution.timedata.data(), rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)
    # the JAX package's folded run saved and restored in the port
    js = JaxSolver(jax_params(**kw))
    js.prepare()
    js.solve_or_resume(30)
    f2 = str(tmp_path / 'jax.npz')
    jck.save_checkpoint(f2, js)
    t = tck.restore_solver(f2, device='cpu')
    assert t.cfg.fold_field
    np.testing.assert_array_equal(t.solution.U.numpy(), np.load(f2)['U'])
    np.testing.assert_array_equal(dct_ops.fold1(t._state.U).numpy(),
                                  np.load(f2)['U'])
    js.solve_or_resume(20)
    t.solve_or_resume(20)
    np.testing.assert_allclose(t.solution.U.numpy(), np.asarray(js.solution.U),
                               rtol=0, atol=1e-12)
    # and the port's own file resumes the run to the bit
    s2 = tck.restore_solver(f1, device='cpu')
    s3, _, _ = _run(port_params(**kw), 30)
    assert torch.equal(s2.solve_or_resume(20).U, s3.solve_or_resume(20).U)


def test_folded_ensemble_is_the_natural_ensemble(tmp_path):
    pairs = np.array([[-30.0, 20.0], [-30.3, 20.1], [-29.8, 19.9]])
    kappas = KAPPA * np.array([1.0, 1.01, 0.99])
    out = {}
    for fold in (False, True):
        ens = EnsembleSolver(port_params(fold_field=fold, jitter=0.01),
                             pairs, kappas=kappas)
        assert ens.cfg.fold_field == fold
        ens.prepare()
        out[fold] = (ens, ens.solve_or_resume(30))
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a.U, b.U)
        assert np.array_equal(a.timedata.data()[:, :7],
                              b.timedata.data()[:, :7])
    # its checkpoint holds the natural fields and resumes to the bit
    f = str(tmp_path / 'ens.npz')
    tck.save_ensemble_checkpoint(f, out[True][0])
    np.testing.assert_array_equal(
        np.load(f)['U'], np.stack([s.U.numpy() for s in out[True][1]]))
    r = tck.restore_ensemble(f, device='cpu')
    assert r.cfg.fold_field
    ref = out[True][0]
    for a, b in zip(r.solve_or_resume(10, preserve_stops=True),
                    ref.solve_or_resume(10, preserve_stops=True)):
        assert torch.equal(a.U, b.U)


def test_fold_needs_member_local_fields():
    pairs = np.array([[-30.0, 20.0], [-30.3, 20.1]])
    with pytest.raises(ValueError, match='member-local'):
        EnsembleSolver(port_params(fold_field=True, mesh_shape=(1, 2)),
                       pairs, kappas=np.array([KAPPA, KAPPA]))
