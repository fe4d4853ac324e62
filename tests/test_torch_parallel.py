"""The grid-sharded solve of chsimpy_tpu_torch (``--mesh MxN``, the matmul
route over ``torch.distributed``) against the JAX package's ``--mesh MxN
--kernels pallas`` solve and the goldens, on the CPU.

Worlds of gloo ranks come from ``spawn_grid``, one per mesh shape for the
module (a 4-rank world takes a few seconds to start).  JAX runs on a mesh
of the virtual CPU devices with its Pallas kernels in interpret mode.
Bounds are those of tests/test_pallas_kernels.py (the JAX package's own
sharded-against-unsharded bounds: float64 U 1e-12 absolute, E 1e-12, E2
1e-10, SA exact; float32 U 1e-5, E 1e-6) and of tests/test_golden.py for
the golden.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chsimpy_tpu as ct
from chsimpy_tpu.ops import pallas_kernels as pk

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch.cli import CLIParser
from chsimpy_tpu_torch.parallel.distributed import (resolve_backend,
                                                    spawn_grid)
from chsimpy_tpu_torch.parallel.mesh import GridMesh, best_grid_shape
from chsimpy_tpu_torch.parallel.workers import run_tasks, solve

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAPPA = 0.00029891134208698706
# the configuration of tests/test_pallas_kernels.py's sharded runs
SHARDED = dict(N=64, ntmax=25, full_sim=True, generator='lcg',
               kappa_tilde=2.98911291966116e-4)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def load(name):
    with open(os.path.join(ROOT, 'tests', 'golden', name + '.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def world_2x2(tmp_path_factory):
    live = tmp_path_factory.mktemp('live')
    tasks = [('solve', dict(params=dict(SHARDED, precision=prec,
                                        device='cpu')))
             for prec in ('float64', 'float32')] + [('imported', {})]
    # the live loop: --png --update-every 10, its PNG named by a path
    tasks.append(('live_solve', dict(
        params=dict(SHARDED, precision='float64', device='cpu'),
        file_id=str(live / 'live'), update_every=10)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPLBACKEND', 'Agg')     # the ranks draw headless
        t0 = time.perf_counter()
        res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                         args=(tasks,), threads=1, timeout=300)
    return {'float64': [r[0] for r in res], 'float32': [r[1] for r in res],
            'imported': [r[2] for r in res], 'live': [r[3] for r in res],
            'live_files': sorted(os.listdir(live)),
            'seconds': time.perf_counter() - t0}


@pytest.fixture(scope='module')
def world_1x4():
    g = load('n128_uniform_300')
    tasks = [('solve', dict(params=dict(g['config'], kappa_tilde=KAPPA,
                                        device='cpu')))]
    return spawn_grid(run_tasks, (1, 4), backend='gloo', device='cpu',
                      args=(tasks,), threads=1, timeout=300)


def _jax_sharded(precision):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in SHARDED.items():
        setattr(p, k, v)
    p.precision = precision
    p.kernel_backend = 'pallas'
    p.mesh_shape = (2, 2)
    return ct.Simulator(p).solve()


@pytest.mark.parametrize('precision', ['float64', 'float32'])
def test_sharded_solve_matches_jax(world_2x2, precision):
    ref = _jax_sharded(precision)
    got = world_2x2[precision][0]
    td, td_ref = got['timedata'], ref.timedata.data()
    assert got['computed_steps'] == ref.computed_steps == 25
    assert got['U'].dtype == np.dtype(precision)
    if precision == 'float64':
        np.testing.assert_allclose(got['U'], np.asarray(ref.U), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(td[:, 1], td_ref[:, 1], rtol=1e-12)
        np.testing.assert_allclose(td[:, 2], td_ref[:, 2], rtol=1e-10)
        np.testing.assert_array_equal(td[:, 3], td_ref[:, 3])       # SA
    else:
        np.testing.assert_allclose(got['U'], np.asarray(ref.U), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(td[:, 1], td_ref[:, 1], rtol=1e-6)


@pytest.mark.parametrize('precision', ['float64', 'float32'])
def test_every_rank_holds_the_same_bits(world_2x2, precision):
    """E, E2, SA, domtime, Ra, L2, PS (the timedata row) and the gathered
    field are the same bits on every rank at every step: the stop
    predicate every rank evaluates reads them."""
    ranks = world_2x2[precision]
    for r in ranks[1:]:
        assert np.array_equal(r['timedata'], ranks[0]['timedata'])
        assert np.array_equal(r['U'], ranks[0]['U'])
        assert (r['computed_steps'], r['stop_reason'], r['tau0'],
                r['t0']) == (ranks[0]['computed_steps'],
                             ranks[0]['stop_reason'], ranks[0]['tau0'],
                             ranks[0]['t0'])


def test_a_rank_imports_no_jax(world_2x2):
    for mods in world_2x2['imported']:
        assert 'chsimpy_tpu_torch' in mods
        assert not {'jax', 'jaxlib', 'chsimpy_tpu'} & set(mods), mods


def test_live_loop_on_the_world(world_2x2):
    """--png --update-every 10 on the 2x2 mesh: every rank runs the same
    chunks (10, 10, 5) and returns the same rows, the world's Solver
    entered at those boundaries to the bit; rank 0 alone builds the view
    and writes the PNG; the world ends inside the fixture's timeout."""
    ranks = world_2x2['live']
    assert [r['view'] for r in ranks] == [True, False, False, False]
    assert world_2x2['live_files'] == ['live.png']
    for r in ranks:
        assert (r['computed_steps'], r['steps_total']) == (25, 25)
        assert np.array_equal(r['timedata'], ranks[0]['timedata'])
        assert np.array_equal(r['U'], ranks[0]['U'])
        assert np.array_equal(r['timedata'], r['ref_timedata'])
        assert np.array_equal(r['U'], r['ref_U'])
        # no energy fall: the last step is tau0, on every rank
        assert r['tau0'] == 24
    assert world_2x2['seconds'] < 300


def test_sharded_solve_matches_single_device(world_2x2):
    """The port's own single-device solve (float64: only the summation
    order of the statistics differs)."""
    single = ctt.Simulator(ctt.Parameters(no_gui=True, device='cpu',
                                          **SHARDED)).solve()
    got = world_2x2['float64'][0]
    np.testing.assert_allclose(got['U'], single.U.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got['timedata'][:, 1:],
                               single.timedata.data()[:, 1:], rtol=1e-12,
                               atol=1e-300)


def test_golden_n128_on_a_1x4_mesh(world_1x4):
    g = load('n128_uniform_300')
    got = world_1x4[0][0]
    td = got['timedata']
    assert got['computed_steps'] == g['computed_steps']
    assert got['stop_reason'] == g['stop_reason']
    assert got['tau0'] == g['tau0']
    np.testing.assert_allclose(got['t0'], g['t0'], rtol=1e-12)
    np.testing.assert_array_equal(td[:, 0], np.asarray(g['it']))
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=1e-11)
    np.testing.assert_allclose(td[:, 8], np.asarray(g['delt']), rtol=1e-12)
    np.testing.assert_allclose(td[:, 2], np.asarray(g['E2']), rtol=1e-6)
    np.testing.assert_allclose(np.sum(got['U']), g['U_sum'], rtol=1e-12)
    np.testing.assert_allclose(got['U'][:2, :2], np.asarray(g['U_corner']),
                               rtol=1e-5)
    for r in world_1x4[1:]:
        assert np.array_equal(r[0]['timedata'], td)


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------

def _params(**kw):
    return ctt.Parameters(no_gui=True, device='cpu', kappa_tilde=KAPPA,
                          **kw)


def test_mesh_needs_divisible_N():
    # 36 % 8 != 0: the blocks must be equal, as the JAX package's
    # device_put onto its mesh needs; 40 on 2x4 (no multiple of 8*mx, the
    # JAX guard of its Pallas kernels only) is taken, and asks for its
    # world
    with pytest.raises(ValueError, match='divisible'):
        ctt.Solver(_params(N=36, mesh_shape=(1, 8)))
    with pytest.raises(RuntimeError, match='torchrun'):
        ctt.Solver(_params(N=40, mesh_shape=(2, 4)))


@pytest.mark.parametrize('transform,exc,match', [
    ('split', ValueError, 'divisible by the device count 4'),
    ('ozaki', RuntimeError, 'torchrun'),
    ('fft', ValueError, 'does not shard under --mesh'),
])
def test_mesh_refuses_the_other_routes(transform, exc, match):
    # split and ozaki take the pencil layout where the rank count divides
    # N (tests/test_torch_pencil.py); N=66 on 4 ranks leaves what stays
    # refused: split (the JAX package's guard) and fft; ozaki takes the
    # grid layout there (tests/test_torch_grid.py) and asks for its world
    with pytest.raises(exc, match=match):
        ctt.Solver(_params(N=66, mesh_shape=(2, 2), precision='float64',
                           transform_backend=transform))


def test_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match='torchrun'):
        ctt.Solver(_params(N=64, mesh_shape=(2, 2)))
    store = os.path.join(tempfile.mkdtemp(), 'store')
    dist.init_process_group('gloo', init_method=f'file://{store}', rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match='torchrun'):
            ctt.Solver(_params(N=64, mesh_shape=(2, 2)))
        with pytest.raises(ValueError, match='CPU takes gloo'):
            ctt.Solver(_params(N=64, mesh_shape=(1, 1),
                               dist_backend='nccl'))
        # a 1x1 mesh of the one rank runs
        sol = ctt.Simulator(_params(N=16, ntmax=3, mesh_shape=(1, 1),
                                    generator='lcg')).solve()
        assert sol.computed_steps == 3 and sol.U.shape == (16, 16)
        # a world's params name its device; nothing moves to the CPU
        with pytest.raises(ValueError, match="world runs on 'cpu'"):
            solve(GridMesh((1, 1), 'cpu'), dict(N=16, ntmax=3))
    finally:
        dist.destroy_process_group()


def test_backend_resolution():
    assert resolve_backend(None, 'cpu') == 'gloo'
    assert resolve_backend(None, 'cuda') == 'nccl'
    assert resolve_backend('gloo', 'cuda') == 'gloo'
    with pytest.raises(ValueError, match='CPU takes gloo'):
        resolve_backend('nccl', 'cpu')
    assert best_grid_shape(4) == (2, 2) and best_grid_shape(8) == (2, 4)


def test_cli_parses_the_mesh(capsys):
    p = CLIParser().get_parameters(['--no-gui', '--mesh', '2X4',
                                    '--dist-backend', 'gloo'])
    assert (p.mesh_shape, p.dist_backend) == ((2, 4), 'gloo')
    assert CLIParser().get_parameters(['--no-gui']).mesh_shape is None
    # the grid ozaki route parses (item 11, done)
    p = CLIParser().get_parameters(['--no-gui', '--mesh', '2x2',
                                    '--transform', 'ozaki', '-N', '66'])
    assert (p.mesh_shape, p.transform_backend) == ((2, 2), 'ozaki')
    for argv, msg in ((['--mesh', 'banana'], 'must look like'),
                      (['--dist-backend', 'mpi'], 'invalid choice')):
        with pytest.raises(SystemExit):
            CLIParser().get_parameters(['--no-gui'] + argv)
        assert msg in capsys.readouterr().err


def test_cli_under_torchrun():
    """Four ranks through torchrun on the CPU; only rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', '4', '-m', 'chsimpy_tpu_torch', '--mesh',
           '2x2', '-N', '64', '-n', '50', '--no-gui', '-K', '3e-4',
           '--device', 'cpu']
    proc = subprocess.run(cmd, cwd=tempfile.mkdtemp(), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert out.count('computed_steps = 50,') == 1, out
    assert 'stop reason = None' in out
    assert 'mesh 2x2: 4 ranks, backend gloo' in out


@pytest.mark.parametrize('coords', [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_convert_gives_this_ranks_blocks(coords):
    """A JAX solver's sharded consts and state, read whole with
    np.asarray, become the blocks of the rank at ``coords``."""
    from types import SimpleNamespace
    from chsimpy_tpu_torch import convert
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in SHARDED.items():
        setattr(p, k, v)
    p.kernel_backend = 'pallas'
    p.mesh_shape = (2, 2)
    js = ct.Solver(p)
    js.prepare()
    mesh = SimpleNamespace(shape=(2, 2), coords=coords)
    i, j = coords
    rows, cols = slice(32 * i, 32 * (i + 1)), slice(32 * j, 32 * (j + 1))
    jc = {k: np.asarray(v) for k, v in js._consts.items()
          if k in ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1',
                   'kappa_tilde')}
    consts = convert.consts_from_jax(jc, mesh=mesh)
    for k in ('leig', 'CHeig', 'Seig'):
        assert np.array_equal(consts[k].numpy(), jc[k][rows, cols]), k
    assert np.array_equal(consts['C'].numpy(), jc['C'])
    jstate = {k: np.asarray(v) for k, v in vars(js._state).items()}
    state = convert.state_from_jax(jstate, mesh=mesh)
    assert np.array_equal(state.U.numpy(), jstate['U'][rows, cols])
    assert state.U.shape == state.hat_U.shape == (32, 32)
    assert np.array_equal(state.rowbuf.numpy(), jstate['rowbuf'])
