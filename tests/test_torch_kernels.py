"""The port's kernel module (chsimpy_tpu_torch/ops/kernels.py) against the
JAX package: each plain PyTorch version against the Pallas kernel it stands
beside (interpret mode on the CPU) and against the JAX step's XLA forms.

Inputs are made by numpy from a seed and handed to both packages.  Bounds:
float64 1e-12 relative (the JAX suite's own bound for the fused stats);
float32 as stated per check (op order and the float32 band accumulation of
the Pallas kernels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.derived import Derived as JDerived
from chsimpy_tpu.ops import pallas_kernels as pk

from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
DTYPES = {'float32': (np.float32, torch.float32),
          'float64': (np.float64, torch.float64)}


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _cfgs(N, dtype):
    """Matching JAX and port StepConfigs (+ consts) for the default
    physics at size N."""
    p = ct.Parameters()
    p.N = N
    p.kappa_tilde = KAPPA
    d = JDerived.from_params(p)
    kw = dict(N=N, dtype=dtype, RT=d.RT, BRT=d.BRT, B=p.B, Amr=d.Amr,
              L=p.L, delx=d.delx, delx2=d.delx2, M_tilde=p.M_tilde,
              threshold=p.threshold, A0=d.A0, A1=d.A1,
              kappa_tilde=d.kappa_tilde)
    jcfg = jst.StepConfig(**kw)
    tcfg = tst.StepConfig(**kw)
    return jcfg, jst.make_consts(jcfg, p.delt), tcfg, \
        tst.make_consts(tcfg, p.delt)


def _field(N, npdt, seed):
    rng = np.random.default_rng(seed)
    return (0.875 + 0.01 * (rng.random((N, N)) - 0.5)).astype(npdt)


def _assert_rel(got, want, rel, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (what, err)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [64, 128])
def test_chemical_potential_ref(N, dtype):
    npdt, tdt = DTYPES[dtype]
    jcfg, jc, tcfg, tc = _cfgs(N, dtype)
    U = _field(N, npdt, 10 + N)
    ours = K.chemical_potential_ref(torch.from_numpy(U), tcfg.RT, tcfg.BRT,
                                    tc['A0'], tc['A1']).numpy()
    assert ours.dtype == npdt
    pallas = np.asarray(pk.chemical_potential(
        jnp.asarray(U), jcfg.RT, jcfg.BRT, jc['A0'], jc['A1']))
    xla = np.asarray(jst._nonlinear_term(jcfg, jc, jnp.asarray(U)))
    for ref in (pallas, xla):
        if dtype == 'float64':
            _assert_rel(ours, ref, 1e-12)
        else:
            # the chain cancels ~1e2 terms down to O(1): op-order
            # differences show at ~100 float32 eps absolute
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [64, 128])
def test_spectral_update_ref(N, dtype):
    npdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(N)
    h, e, s = (rng.random((N, N)).astype(npdt) for _ in range(3))
    c = (1 + rng.random((N, N))).astype(npdt)
    ours = K.spectral_update_ref(*map(torch.from_numpy, (h, e, s, c)))
    pallas = np.asarray(pk.spectral_update(*map(jnp.asarray, (h, e, s, c))))
    rtol = 1e-12 if dtype == 'float64' else 1e-6
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=rtol)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [64, 128])
def test_stats_sums_ref_matches_pallas_band_sums(N, dtype):
    npdt, _ = DTYPES[dtype]
    jcfg, jc, tcfg, tc = _cfgs(N, dtype)
    U = _field(N, npdt, 20 + N)
    E = np.array(jst._nonlinear_term(jcfg, jc, jnp.asarray(U)))
    kw = dict(delx=jcfg.delx, RT=jcfg.RT, B=jcfg.B,
              threshold=jcfg.threshold)
    ours = K.stats_sums_ref(torch.from_numpy(U), torch.from_numpy(E),
                            tc['A0'], tc['A1'], **kw).numpy()
    tile = np.asarray(pk.stats_band_sums(jnp.asarray(U), jnp.asarray(E),
                                         jc['A0'], jc['A1'], **kw))
    assert tile.shape == (8, 128)
    assert ours[3] == tile[0, 3]                      # threshold count
    # float32: the Pallas kernel sums each band in float32
    np.testing.assert_allclose(ours, tile[0, :5].astype(np.float64),
                               rtol=1e-12 if dtype == 'float64' else 1e-5)
    none = K.stats_sums_ref(torch.from_numpy(U), None, tc['A0'], tc['A1'],
                            **kw).numpy()
    assert none[4] == 0 and np.array_equal(none[:4], ours[:4])

    mean = torch.tensor(ours[2] / (N * N)).to(DTYPES[dtype][1])
    absdev = K.absdev_sum_ref(torch.from_numpy(U), mean).item()
    band = np.asarray(pk.absdev_band_sums(jnp.asarray(U),
                                          jnp.asarray(mean.numpy())))
    np.testing.assert_allclose(absdev, float(band[0, 0]),
                               rtol=1e-12 if dtype == 'float64' else 1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [64, 128])
def test_stats_match_jax_stats(N, dtype):
    """The port's finalized statistics (kernel sums -> E, E2, PS, L2, Ra,
    SA) against JAX ``_stats`` (float64: the reference-order XLA form;
    float32: the fast form) and the Pallas ``fused_stats``."""
    npdt, _ = DTYPES[dtype]
    jcfg, jc, tcfg, tc = _cfgs(N, dtype)
    U = _field(N, npdt, 30 + N)
    E = np.array(jst._nonlinear_term(jcfg, jc, jnp.asarray(U)))
    ours = [t.item() for t in tst._stats(tcfg, tc, torch.from_numpy(U),
                                         torch.from_numpy(E))]
    refs = {'xla': jst._stats(jcfg, jc, jnp.asarray(U), jnp.asarray(E)),
            'pallas': pk.fused_stats(
                jnp.asarray(U), jnp.asarray(E), jc['A0'], jc['A1'],
                jc['kappa_tilde'], delx=jcfg.delx, RT=jcfg.RT, B=jcfg.B,
                Amr=jcfg.Amr, L=jcfg.L, threshold=jcfg.threshold)}
    rtol = 1e-12 if dtype == 'float64' else 1e-5
    for src, ref in refs.items():
        for name, g, r in zip(('E', 'E2', 'PS', 'L2', 'Ra', 'SA'), ours,
                              ref):
            np.testing.assert_allclose(g, float(r), rtol=rtol,
                                       err_msg=f'{src} {name}')
    # prepare path: no EnergieEut, L2 = 0
    row0 = [t.item() for t in tst.prepare_row0(tcfg, tc,
                                               torch.from_numpy(U))]
    jrow0 = jst.prepare_row0(jcfg, jc, jnp.asarray(U))
    np.testing.assert_allclose(row0, [float(x) for x in jrow0], rtol=rtol)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    jcfg, jc, tcfg, tc = _cfgs(32, 'float64')
    U = torch.from_numpy(_field(32, np.float64, 1))
    K.reset_launches()
    mu = K.chemical_potential(U, tcfg.RT, tcfg.BRT, tc['A0'], tc['A1'])
    assert torch.equal(mu, K.chemical_potential_ref(
        U, tcfg.RT, tcfg.BRT, tc['A0'], tc['A1']))
    kw = dict(delx=tcfg.delx, RT=tcfg.RT, B=tcfg.B,
              threshold=tcfg.threshold)
    assert torch.equal(K.stats_sums(U, mu, tc['A0'], tc['A1'], **kw),
                       K.stats_sums_ref(U, mu, tc['A0'], tc['A1'], **kw))
    assert torch.equal(K.spectral_update(U, U, U, U + 1),
                       K.spectral_update_ref(U, U, U, U + 1))
    m = U.mean()
    assert torch.equal(K.absdev_sum(U, m), K.absdev_sum_ref(U, m))
    # the CPU path launches nothing
    assert set(K.launches.values()) == {0}


def test_wrappers_refuse_other_devices_and_mixed_inputs():
    U = torch.ones((8, 8), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        K.chemical_potential(U, 1.0, 1.0, 1.0, 1.0)
    V = torch.ones((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        K.spectral_update(V, V, V, V.float())
    with pytest.raises(ValueError, match='N >= 2'):
        K.stats_sums(torch.ones((1, 1), dtype=torch.float64), None, 0, 0,
                     delx=1.0, RT=1.0, B=1.0, threshold=0.5)
