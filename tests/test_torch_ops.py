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
from chsimpy_tpu_torch.core import solver as tsolver
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
    """sobol and simplex, refused until item 7 was ported, now give the
    JAX package's fields and streams to the bit; an unknown kind is still
    refused."""
    for kind in ('sobol', 'simplex'):
        ours = rng.FieldGenerator(kind, 48, 2023)
        ref = jrng.FieldGenerator(kind, 48, 2023)
        assert np.array_equal(ours.initial_field(0.875),
                              ref.initial_field(0.875))
        assert np.array_equal(ours.next_sample(), ref.next_sample())
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
    assert convert.params_from_jax(d, device='cpu').mesh_shape == (2, 4)
    # split and ozaki take the pencil layout where the rank count divides
    # N; ozaki where it does not (N=100 on 8 ranks) the grid layout
    d['transform_backend'] = 'split'
    assert convert.params_from_jax(d, device='cpu').mesh_shape == (2, 4)
    d.update(transform_backend='ozaki', N=100, precision='float64')
    p = convert.params_from_jax(d, device='cpu')
    assert (p.transform_backend, p.mesh_shape, p.N) == ('ozaki', (2, 4), 100)
    assert not tsolver.resolve_pencil(p, 8)
    d = jp.scalar_dict()
    d.update(transform_backend='split', split_levels=3)
    p = convert.params_from_jax(d, device='cpu')
    assert (p.transform_backend, p.split_levels) == ('split', 3)
    # the float32 knobs carry across (item 14, done); the JAX package's
    # probe knob spectral_bf16 stays refused, naming itself
    d.update(fold_field=True, precision='float32', matmul_precision='high',
             fwd_matmul_precision='default', inv_band=256, otf_coeffs=1)
    p = convert.params_from_jax(d, device='cpu')
    assert (p.fold_field, p.matmul_precision, p.fwd_matmul_precision,
            p.inv_band, p.otf_coeffs) == (True, 'high', 'default', 256, 1)
    d['spectral_bf16'] = True
    with pytest.raises(NotImplementedError, match='spectral_bf16'):
        convert.params_from_jax(d)
    d = ct.Parameters().scalar_dict()
    d.update(transform_backend='ozaki', ozaki_fwd_pairs=[2, 4])
    p = convert.params_from_jax(d, device='cpu')
    assert (p.transform_backend, p.ozaki_fwd_pairs) == ('ozaki', (2, 4))
    with pytest.raises(ValueError, match='unknown'):
        convert.params_from_jax({'banana': 1})


def test_solver_refuses_settings_not_ported(tmp_path):
    # --kernels and spectral_bf16 stay refused with their reasons; the
    # knobs of item 14 (done) meet the JAX Solver's guards: the fold off
    # the split route and a float64 --inv-band raise ValueError
    cases = {'fold_field': (True, ValueError, 'split transform route'),
             'inv_band': (4, ValueError, 'float32 fast-mode'),
             'kernel_backend': ('pallas', NotImplementedError, 'queue B'),
             'spectral_bf16': (True, NotImplementedError, 'measured')}
    for field, (value, exc, item) in cases.items():
        p = ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA,
                           no_gui=True)
        setattr(p, field, value)
        with pytest.raises(exc, match=item):
            ctt.Solver(p)
    # and run where they apply (the precision names on any route)
    p = ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA, no_gui=True,
                       matmul_precision='high')
    assert ctt.Solver(p).cfg.matmul_precision == 'high'
    # item 7's settings run (ROADMAP.md queue A item 7, done), and item
    # 8's checkpoint settings (done): restore_file is the Simulator's
    for field, value in (('adaptive_time', True), ('jitter', 0.01),
                         ('generator', 'sobol'), ('generator', 'simplex'),
                         ('jitter_backend', 'device'),
                         ('restore_file', 'x.npz'), ('checkpoint_every', 10),
                         ('checkpoint_file', 'x.npz')):
        p = ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA,
                           no_gui=True)
        setattr(p, field, value)
        ctt.Solver(p)
    # the checkpoint under a grid mesh (item 11, done) constructs and runs
    # (a 1x1 mesh: this process as a world of one rank)
    import torch.distributed as dist
    from chsimpy_tpu_torch import checkpoint as tck
    ck = str(tmp_path / 'mesh.npz')
    dist.init_process_group('gloo', init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        # with and without the chunk boundary saves: the Simulator saves
        # at the end too
        for every in (8, None):
            p = ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA,
                               no_gui=True, mesh_shape=(1, 1), ntmax=12,
                               chunk_size=4, checkpoint_file=ck,
                               checkpoint_every=every)
            sim = ctt.Simulator(p)
            assert sim.solver.mesh is not None
            sol = sim.solve()
            r = tck.restore_solver(ck, device='cpu')
            assert r.mesh is not None
            assert r.solution.computed_steps == 12
            assert torch.equal(r.solution.U, sol.U)
    finally:
        dist.destroy_process_group()
    # the grid mesh runs the matmul route and, where the rank count does
    # not divide N, the ozaki route; the pencil layout split and ozaki
    # where it does: N=18 on 4 ranks takes the grid ozaki route, and asks
    # for its world
    p = ctt.Parameters(N=18, device='cpu', kappa_tilde=KAPPA, no_gui=True,
                       mesh_shape=(2, 2), transform_backend='ozaki')
    with pytest.raises(RuntimeError, match='torchrun'):
        ctt.Solver(p)
    # the default run's view (item 13) is ported: the Simulator takes it
    import matplotlib
    matplotlib.use('Agg')
    sim = ctt.Simulator(ctt.Parameters(N=16, device='cpu', kappa_tilde=KAPPA))
    assert sim.gui_requested() and sim.view is not None
    sim.view._plt.close(sim.view.fig)


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
            "import chsimpy_tpu_torch.benchmarks.dct_bench\n"
            "import chsimpy_tpu_torch.benchmarks.bench\n"
            "import chsimpy_tpu_torch.benchmarks.ozaki_profile\n"
            "import chsimpy_tpu_torch.experiment\n"
            "import chsimpy_tpu_torch.ops.sobol, chsimpy_tpu_torch.noise\n"
            "import chsimpy_tpu_torch.parallel.workers\n"
            "import chsimpy_tpu_torch.ensemble, chsimpy_tpu_torch.checkpoint\n"
            "import chsimpy_tpu_torch.validate, chsimpy_tpu_torch.io.yamlio\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'chsimpy_tpu', 'triton', 'sympy', 'pandas', "
            "'yaml')]\n"
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
    # item 7's flags parse
    p = CLIParser().get_parameters(['--no-gui', '-a', '-j', '0.01', '-g',
                                    'sobol', '--jitter-backend', 'device'])
    assert (p.adaptive_time, p.jitter, p.generator, p.jitter_backend) == \
        (True, 0.01, 'sobol', 'device')
    # item 8's and item 13's flags parse
    p = CLIParser().get_parameters(
        ['--png', '--update-every', '10', '--no-diagrams'])
    assert (p.no_gui, p.png, p.update_every, p.no_diagrams) == \
        (False, True, 10, True)
    assert CLIParser().get_parameters(['--no-gui', '--png']).png
    p = CLIParser().get_parameters(
        ['--no-gui', '--checkpoint-file', 'c.npz', '--checkpoint-every',
         '5', '--export-csv', 'U', '-C', '--yaml', '--restore', 'x',
         '--Uinit-file', 'u.csv'])
    assert (p.checkpoint_file, p.checkpoint_every, p.export_csv,
            p.compress_csv, p.yaml, p.restore_file, p.Uinit_file) == \
        ('c.npz', 5, 'U', True, True, 'x', 'u.csv')
    # the checkpoint flags under --mesh parse (item 11, done)
    p = CLIParser().get_parameters(
        ['--no-gui', '--mesh', '2x2', '--restore', 'x', '--checkpoint-file',
         'c.npz', '--checkpoint-every', '5'])
    assert (p.mesh_shape, p.restore_file, p.checkpoint_every) == \
        ((2, 2), 'x', 5)
    # and the ozaki route where the rank count does not divide N (the grid
    # ozaki route, item 11, done)
    p = CLIParser().get_parameters(
        ['--no-gui', '--mesh', '2x2', '--transform', 'ozaki', '-N', '66'])
    assert (p.mesh_shape, p.transform_backend, p.N) == ((2, 2), 'ozaki', 66)
    for argv, item in ((['--no-gui', '--checkpoint-every', '5'],
                        'no --checkpoint-file'),
                       (['--no-gui', '--export-csv', 'none'],
                        'valid entries'),
                       (['--no-gui', '-C'], 'no --export-csv'),
                       (['--no-gui', '--update-every', '1'], '>=2'),
                       (['--no-gui', '--png-anim'],
                        'requires --update-every'),
                       (['--no-gui', '--matmul-precision', 'fast'],
                        'invalid choice'),
                       (['--no-gui', '--otf-coeffs', '2'],
                        'invalid choice'),
                       (['--no-gui', '--kernels', 'pallas'], 'queue B')):
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
