"""The port's host layer and transform ops against the JAX package:
DCT products, coefficient grids, stencil, generators, derived constants,
the conversion module, the CLI, the explicit device and the import
boundary (the port imports no jax)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import rng as jrng
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.ops import coeffs as jcoeffs
from chsimpy_tpu.ops import dct as jdct

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert, rng
from chsimpy_tpu_torch.cli import CLIParser
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.derived import Derived
from chsimpy_tpu_torch.device import resolve_device
from chsimpy_tpu_torch.ops import coeffs, dct
from chsimpy_tpu_torch.ops.stencil import gradient2d

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('N', [64, 128])
def test_dct2_idct2_match_jax_and_scipy(N):
    rng_ = np.random.default_rng(N)
    U = rng_.random((N, N)) - 0.5
    C = dct.dct_matrix(N)
    assert np.array_equal(C.numpy(), np.asarray(jdct.dct_matrix(N)))
    ours = dct.dct2(torch.from_numpy(U), C).numpy()
    jC = jdct.dct_matrix(N)
    np.testing.assert_allclose(ours, np.asarray(jdct.dct2(jnp.asarray(U),
                                                          jC)),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(ours, sfft.dctn(U, norm='ortho'), rtol=0,
                               atol=1e-13)
    back = dct.idct2(torch.from_numpy(ours), C).numpy()
    np.testing.assert_allclose(back, sfft.idctn(ours, norm='ortho'),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(back, U, rtol=0, atol=1e-13)


def test_coefficient_grids_bit_identical_to_jax():
    N, kt, delt, delx2 = 96, KAPPA, 3e-8, (2.0 / 95) ** 2
    leig = coeffs.eigenvalues(N)
    jleig = jcoeffs.eigenvalues(N)
    assert np.array_equal(leig.numpy(), np.asarray(jleig))
    f64 = torch.float64
    ch, s = coeffs.get_coefficients(leig, torch.tensor(kt, dtype=f64),
                                    torch.tensor(delt, dtype=f64), delx2)
    jch, js = jcoeffs.get_coefficients(jleig, jnp.asarray(kt),
                                       jnp.asarray(delt), delx2)
    assert np.array_equal(ch.numpy(), np.asarray(jch))
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_gradient2d_matches_numpy():
    U = np.random.default_rng(5).random((40, 40))
    dux, duy = gradient2d(torch.from_numpy(U), 0.05)
    gx, gy = np.gradient(U, 0.05, axis=[0, 1], edge_order=1)
    assert np.array_equal(dux.numpy(), gx)
    assert np.array_equal(duy.numpy(), gy)


@pytest.mark.parametrize('kind', ['uniform', 'lcg'])
def test_generators_bit_exact_with_jax(kind):
    ours = rng.FieldGenerator(kind, 48, 2023).initial_field(0.875)
    ref = jrng.FieldGenerator(kind, 48, 2023).initial_field(0.875)
    assert np.array_equal(ours, ref)
    assert np.array_equal(rng.matlab_lcg_sample(7, 5, 3),
                          jrng.matlab_lcg_sample(7, 5, 3))


def test_generators_not_ported_name_their_roadmap_item():
    for kind in ('sobol', 'simplex'):
        with pytest.raises(NotImplementedError, match='item 7'):
            rng.FieldGenerator(kind, 8, 1)
    with pytest.raises(ValueError):
        rng.FieldGenerator('banana', 8, 1)


def test_derived_kappa_tilde_of_the_default_run():
    d = Derived.from_params(ctt.Parameters())
    assert d.kappa_tilde == KAPPA
    jd = ct.derived.Derived.from_params(ct.Parameters())
    assert dataclasses.astuple(d) == dataclasses.astuple(jd)


def _jax_cfg(N, dtype):
    p = ct.Parameters()
    p.N = N
    p.kappa_tilde = KAPPA
    d = ct.derived.Derived.from_params(p)
    kw = dict(N=N, dtype=dtype, RT=d.RT, BRT=d.BRT, B=p.B, Amr=d.Amr,
              L=p.L, delx=d.delx, delx2=d.delx2, M_tilde=p.M_tilde,
              threshold=p.threshold, A0=d.A0, A1=d.A1,
              kappa_tilde=d.kappa_tilde)
    return p, jst.StepConfig(**kw), tst.StepConfig(**kw)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_consts_carried_from_jax_equal_the_ports_own(dtype):
    p, jcfg, tcfg = _jax_cfg(64, dtype)
    jc = jst.make_consts(jcfg, p.delt)
    carried = convert.consts_from_jax(
        {k: np.asarray(v) for k, v in jc.items()
         if k in ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1',
                  'kappa_tilde')})
    own = tst.make_consts(tcfg, p.delt)
    assert carried.keys() == own.keys()
    for k, v in own.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == carried[k].dtype, k
            assert torch.equal(v, carried[k]), k
        else:
            assert v == carried[k], k


def test_params_carried_from_jax():
    jp = ct.Parameters()
    jp.N = 96
    jp.full_sim = True
    jp.precision = 'float32'
    p = convert.params_from_jax(jp.scalar_dict(), device='cpu')
    assert (p.N, p.full_sim, p.precision, p.device) == \
        (96, True, 'float32', 'cpu')
    d = jp.scalar_dict()
    d['mesh_shape'] = [2, 4]
    with pytest.raises(NotImplementedError, match='item 11'):
        convert.params_from_jax(d)
    d = jp.scalar_dict()
    d['transform_backend'] = 'ozaki'
    with pytest.raises(NotImplementedError, match='item 10'):
        convert.params_from_jax(d)
    with pytest.raises(ValueError, match='unknown'):
        convert.params_from_jax({'banana': 1})


def test_solver_refuses_settings_not_ported():
    cases = {'adaptive_time': (True, 'item 7'), 'jitter': (0.01, 'item 7'),
             'generator': ('sobol', 'item 7'),
             'checkpoint_file': ('x.npz', 'item 8'),
             'mesh_shape': ((2, 2), 'item 11'),
             'transform_backend': ('split', 'item 2'),
             'kernel_backend': ('pallas', 'queue B'),
             'matmul_precision': ('high', 'item 14')}
    for field, (value, item) in cases.items():
        p = ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA,
                           no_gui=True)
        setattr(p, field, value)
        with pytest.raises(NotImplementedError, match=item):
            ctt.Solver(p)
    with pytest.raises(NotImplementedError, match='item 13'):
        ctt.Simulator(ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ctt.Solver(ctt.Parameters(N=16, kappa_tilde=KAPPA))
    assert resolve_device('cpu') == torch.device('cpu')


def test_import_brings_in_no_jax():
    code = ("import sys\n"
            "import chsimpy_tpu_torch, chsimpy_tpu_torch.convert\n"
            "import chsimpy_tpu_torch.__main__\n"
            "import chsimpy_tpu_torch.ops.cuda_build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'chsimpy_tpu', 'triton', 'sympy')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_cli_parses_the_slice_and_refuses_the_rest(capsys):
    p = CLIParser().get_parameters(
        ['-N', '64', '-n', '10', '-z', '--precision', 'float32',
         '--no-gui', '-g', 'lcg', '-K', str(KAPPA), '--device', 'cpu'])
    assert (p.N, p.ntmax, p.full_sim, p.precision, p.generator,
            p.kappa_tilde, p.device) == (64, 10, True, 'float32', 'lcg',
                                         KAPPA, 'cpu')
    assert CLIParser().get_parameters(['--no-gui']).device == 'cuda'
    for argv, item in ((['--no-gui', '-a'], 'item 7'),
                       (['--no-gui', '--mesh', '2x2'], 'item 11'),
                       (['--no-gui', '--export-csv', 'U'], 'item 13'),
                       (['--no-gui', '-g', 'sobol'], 'item 7'),
                       (['--no-gui', '--transform', 'fft'], 'item 2'),
                       (['--no-gui', '--kernels', 'pallas'], 'queue B'),
                       (['--no-gui', '--restore', 'x'], 'item 8'),
                       ([], 'item 13')):
        with pytest.raises(SystemExit) as exc:
            CLIParser().get_parameters(argv)
        assert exc.value.code == 2, argv
        assert item in capsys.readouterr().err, argv


def test_cli_runs_on_the_cpu(capsys):
    from chsimpy_tpu_torch.__main__ import main
    main(['-N', '16', '-n', '5', '--no-gui', '-g', 'lcg', '-K', str(KAPPA),
          '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'computed_steps = 5' in out and 'stop reason = None' in out
