"""The port's distributed ensemble, its checkpoint under a mesh and the
multi-process UQ experiment (chsimpy_tpu_torch: ``parallel/mesh.py``
EnsembleMesh, ``ensemble.py`` with ``mesh``, ``checkpoint.py``,
``experiment.py --coordinator``) on the CPU, against the port's own
single-process runs and the JAX package's meshes.

Worlds of gloo ranks come from ``spawn_world`` / ``spawn_grid``, one per
module (a world costs a few seconds to start).  A rank imports only the
port: the tasks are ``parallel/workers.py``'s.  The JAX runs use the test
process's 8 virtual CPU devices (tests/conftest.py).

Bounds: an ens-only world runs each member's arithmetic of the
single-process batch, so its members are that batch's to the bit; with
grid-sharded member fields the statistics add the ranks' partials in rank
order (another float64 summation order), so the rows are held to 1e-10
relative (E2) and the fields to 1e-12 of JAX's run, the same bits on every
rank.  The JAX ensemble on its meshes is held to test_torch_ensemble.py's
1e-12 (two float64 matmul orders)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import material as jmaterial
from chsimpy_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble
from chsimpy_tpu.parallel.mesh import make_ensemble_mesh

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import checkpoint as tck
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.parallel.distributed import spawn_grid, spawn_world
from chsimpy_tpu_torch.parallel.workers import run_tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAPPA = 2.98911291966116e-4
# scripts/run_distributed_2proc.py:30 and its build_params / build_pairs
CONFIG = dict(N=32, ntmax=30, R=4, seed=2023)
FACTORS = [(1.0, 1.0), (1.004, 0.997), (0.995, 1.005), (1.002, 1.002)]
# tests/test_checkpoint.py:176-240: the elastic restore's run
ELASTIC = dict(N=32, full_sim=True, generator='uniform', jitter=0.01,
               kappa_tilde=KAPPA)
ELASTIC_FACTORS = [(1.0, 1.0), (1.004, 0.997)]
# scripts/run_distributed_experiment.py:37-40
EXP_ARGS = ['-N', '32', '-n', '30', '--generator', 'lcg', '--seed', '2023',
            '--kappa-tilde', '2.98911291966116e-4', '--runs', '8',
            '--A-source', 'uniform', '--A-seed', '85972', '--file-id',
            'distexp', '--host-procs', '2']
ROW_RTOL = 1e-12


def pairs(factors=FACTORS):
    A0 = jmaterial.A0(923.15)
    A1 = jmaterial.A1(923.15)
    return np.array([[A0 * f0, A1 * f1] for f0, f1 in factors])


def port_config(**kw):
    return dict(N=CONFIG['N'], ntmax=CONFIG['ntmax'], no_gui=True,
                full_sim=True, generator='lcg', seed=CONFIG['seed'],
                kappa_tilde=KAPPA, device='cpu', **kw)


def jax_params(values):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in values.items():
        if k != 'device':
            setattr(p, k, v)
    return p


def single_port(values, prs, steps):
    e = EnsembleSolver(ctt.Parameters(**values), prs)
    e.prepare()
    return e.solve_or_resume(steps)


def jax_run(values, prs, steps, mesh):
    j = JaxEnsemble(jax_params(values), prs, mesh=mesh)
    j.prepare()
    return j.solve_or_resume(steps)


def assert_rows_match_jax(got, jsols, rtol=ROW_RTOL):
    for r, js in enumerate(jsols):
        assert got['computed_steps'][r] == js.computed_steps
        assert got['stop_reason'][r] == js.stop_reason
        np.testing.assert_allclose(got['timedata'][r], js.timedata.data(),
                                   rtol=rtol, atol=1e-300)


def same_on_every_rank(results, key):
    first = results[0][key]
    for res in results[1:]:
        if isinstance(first, np.ndarray):
            assert np.array_equal(res[key], first), key
        else:
            assert all(np.array_equal(a, b)
                       for a, b in zip(res[key], first)), key


# ----------------------------------------------------------------------
# an 'ens' world of 2 ranks: the members split, each rank's members local
# ----------------------------------------------------------------------

MERGE_ROWS = [
    # rank 0 owns runs 0 and 2 (a NaN in sa), rank 1 run 1 (None factors)
    [(1.0, 2.0, 0.8, 0.9, float('nan'), 0.95, 30, 1.5, 7, 0, 1.0, 1.0),
     (1.1, 2.1, 0.8, 0.9, 0.85, 0.95, 31, 1.6, 8, 2, 1.0, 1.0)],
    [(1.2, 2.2, 0.8, 0.9, 0.85, 0.95, 32, 1.7, 9, 1, None, None)],
]


@pytest.fixture(scope='module')
def ens_world():
    tasks = [('ensemble', {'params': port_config(), 'pairs': pairs(),
                           'steps': CONFIG['ntmax']}),
             ('imported', {}),
             ('ensemble_error', {'params': port_config(),
                                 'pairs': pairs()[:3]}),
             ('merge_rows', {'rows_by_rank': MERGE_ROWS, 'nr_items': 3})]
    return spawn_world(run_tasks, (2, 1, 1), backend='gloo', device='cpu',
                       args=(tasks,), timeout=300, threads=1)


def test_ens_world_members_are_the_single_process_batch(ens_world):
    ref = single_port(port_config(), pairs(), CONFIG['ntmax'])
    for rank, res in enumerate(ens_world):
        got = res[0]
        assert got['local_members'] == (2 * rank, 2 * rank + 2)
        assert 'mesh (' in got['mesh'] and '(2, 1, 1)' in got['mesh']
        for r, s in enumerate(ref):
            assert got['computed_steps'][r] == s.computed_steps
            assert (got['tau0'][r], got['t0'][r]) == (s.tau0, s.t0)
            assert np.array_equal(got['timedata'][r], s.timedata.data())
            assert np.array_equal(got['U'][r], s.U.numpy())


def test_ens_world_matches_the_jax_ens_mesh(ens_world):
    jsols = jax_run(port_config(), pairs(), CONFIG['ntmax'],
                    make_ensemble_mesh(2))
    got = ens_world[0][0]
    assert_rows_match_jax(got, jsols)
    for r, js in enumerate(jsols):
        np.testing.assert_allclose(got['U'][r], np.asarray(js.U),
                                   rtol=ROW_RTOL)


def test_ens_world_refuses_members_the_axis_does_not_divide(ens_world):
    for res in ens_world:
        assert res[2].startswith('ValueError')
        assert 'divisible by 2' in res[2]


def test_the_merge_keeps_nan_and_none_apart(ens_world):
    """The rows travel as objects: a NaN comes back a NaN, a None a None
    (the JAX package's float64 gather turns a real NaN into None), in run
    order, the same on every rank."""
    for res in ens_world:
        merged = res[3]
        assert [r[9] for r in merged] == [0, 1, 2]
        assert np.isnan(merged[0][4]) and merged[0][4] is not None
        assert merged[1][10] is None and merged[1][11] is None
        assert isinstance(merged[0][8], int) and isinstance(merged[2][9],
                                                            int)
        assert merged[2] == MERGE_ROWS[0][1]


# ----------------------------------------------------------------------
# a (2, 2, 2) world: grid-sharded member fields (K7_members), and the
# elastic ensemble restore
# ----------------------------------------------------------------------

def _elastic_part(path):
    """The elastic test's unsharded run to step 12, saved to ``path``."""
    part = EnsembleSolver(ctt.Parameters(ntmax=24, no_gui=True,
                                         device='cpu', **ELASTIC),
                          pairs(ELASTIC_FACTORS))
    part.prepare()
    part.solve_or_resume(12)
    tck.save_ensemble_checkpoint(path, part)
    return part


@pytest.fixture(scope='module')
def grid_world(tmp_path_factory):
    d = tmp_path_factory.mktemp('grid_world')
    saved = str(d / 'ens-unsharded.npz')
    part = _elastic_part(saved)
    back = str(d / 'ens-sharded.npz')
    tasks = [('ensemble', {'params': port_config(), 'pairs': pairs(),
                           'steps': CONFIG['ntmax']}),
             ('imported', {}),
             ('restore_ensemble', {'path': saved, 'steps': 12,
                                   'device': 'cpu', 'save': back})]
    res = spawn_world(run_tasks, (2, 2, 2), backend='gloo', device='cpu',
                      args=(tasks,), timeout=300, threads=1)
    return res, part, back


def test_grid_world_matches_the_jax_mesh(grid_world):
    """R=4 on ('ens', 'x', 'y') = (2, 2, 2): U within 1e-12 of JAX's
    single-process run on the same global mesh, E2 within 1e-10, the same
    bits on every rank, and no rank imports jax."""
    res, _, _ = grid_world
    runs = [r[0] for r in res]
    for key in ('U', 'timedata', 'computed_steps'):
        same_on_every_rank(runs, key)
    for r in res:
        assert not {'jax', 'jaxlib', 'chsimpy_tpu'} & set(r[1])
    jsols = jax_run(port_config(), pairs(), CONFIG['ntmax'],
                    make_ensemble_mesh(2, (2, 2)))
    got = runs[0]
    for r, js in enumerate(jsols):
        assert got['computed_steps'][r] == js.computed_steps
        np.testing.assert_allclose(got['U'][r], np.asarray(js.U),
                                   rtol=1e-12)
        np.testing.assert_allclose(got['timedata'][r][:, 2],
                                   js.timedata.data()[:, 2], rtol=1e-10)
    # the ranks' members: ens slot e holds [2e, 2e + 2)
    assert [r[0]['local_members'] for r in res] == [(0, 2)] * 4 + \
        [(2, 4)] * 4


def test_grid_world_matches_the_single_process_batch(grid_world):
    res, _, _ = grid_world
    got = res[0][0]
    for r, s in enumerate(single_port(port_config(), pairs(),
                                      CONFIG['ntmax'])):
        assert got['computed_steps'][r] == s.computed_steps
        np.testing.assert_allclose(got['timedata'][r], s.timedata.data(),
                                   rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(got['U'][r], s.U.numpy(), rtol=1e-12)


def test_ensemble_checkpoint_restores_onto_a_different_mesh(grid_world):
    """tests/test_checkpoint.py:176-240 in the port: a file of an
    unsharded run restores onto the (2, 2, 2) world (the handoff to the
    bit) and continues within 1e-12 of the unsharded run; the world's own
    file restores unsharded with the world's bits."""
    res, part, back = grid_world
    full = EnsembleSolver(ctt.Parameters(ntmax=24, no_gui=True,
                                         device='cpu', **ELASTIC),
                          pairs(ELASTIC_FACTORS))
    full.prepare()
    full.solve_or_resume(12)
    sols_full = full.solve_or_resume(12)
    runs = [r[2] for r in res]
    same_on_every_rank(runs, 'U')
    got = runs[0]
    assert np.array_equal(got['handoff_U'], part._states.U.numpy())
    for r, a in enumerate(sols_full):
        assert got['computed_steps'][r] == a.computed_steps
        np.testing.assert_allclose(got['U'][r], a.U.numpy(), rtol=1e-12)
        np.testing.assert_allclose(got['timedata'][r], a.timedata.data(),
                                   rtol=1e-12)
    restored = tck.restore_ensemble(back, device='cpu')
    for r, b in enumerate(restored.solutions()):
        assert np.array_equal(got['U'][r], b.U.numpy())
        assert np.array_equal(got['timedata'][r], b.timedata.data())


def test_an_ensemble_mesh_of_one_slot_is_the_grid_mesh():
    """``EnsembleMesh(1, (2, 2))`` gives ``GridMesh((2, 2))``'s
    collectives and bits: the grid statistics (halo exchange, world
    gather) and the grid DCTs (strip gathers)."""
    rng = np.random.default_rng(8)
    U = 0.875 + 0.01 * (rng.random((32, 32)) - 0.5)
    E = rng.random((32, 32))
    p = ctt.Parameters(N=32, kappa_tilde=KAPPA)
    from chsimpy_tpu_torch.derived import Derived
    d = Derived.from_params(p)
    phys = dict(RT=d.RT, BRT=d.BRT, A0=d.A0, A1=d.A1, delx=d.delx, B=p.B,
                threshold=p.threshold, Amr=d.Amr, L=p.L,
                kappa_tilde=d.kappa_tilde)
    tasks = [('fused_stats', dict(U=U, E=E, dtype='float64', phys=phys)),
             ('dcts', dict(U=U, dtype='float64'))]
    kw = dict(backend='gloo', device='cpu', args=(tasks,), timeout=300,
              threads=1)
    ens = spawn_world(run_tasks, (1, 2, 2), **kw)
    grid = spawn_grid(run_tasks, (2, 2), **kw)
    for a, b in zip(ens, grid):
        assert a[0] == b[0]
        assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

@pytest.mark.parametrize('route', ['split', 'ozaki'])
def test_grid_sharded_members_refuse_the_pencil_routes(route):
    # the pencil layout needs the grid's rank count to divide N (N=32 on
    # 2x2 runs: tests/test_torch_pencil.py); N=34 on 4 ranks is refused
    # on split before any world is needed, and takes the grid layout on
    # ozaki (tests/test_torch_grid.py), which asks for its world
    cfg = port_config(mesh_shape=(2, 2), precision='float64',
                      transform_backend=route)
    cfg['N'] = 34
    exc, match = ((ValueError, 'divisible by the device count 4')
                  if route == 'split' else (RuntimeError, 'process group'))
    with pytest.raises(exc, match=match):
        EnsembleSolver(ctt.Parameters(**cfg), pairs())


def test_grid_sharded_members_refuse_fft_and_need_a_world():
    p = ctt.Parameters(**port_config(mesh_shape=(2, 2),
                                     transform_backend='fft'))
    with pytest.raises(ValueError, match='does not shard'):
        EnsembleSolver(p, pairs())
    p = ctt.Parameters(**port_config(mesh_shape=(2, 2)))
    with pytest.raises(RuntimeError, match='coordinator'):
        EnsembleSolver(p, pairs())


# ----------------------------------------------------------------------
# K7_members' plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k7_members_plain_version_is_k7_per_member(dtype):
    rng = np.random.default_rng(12)
    R, N, bn, bw, i, j = 3, 48, 16, 8, 1, 2
    F = torch.tensor(0.875 + 0.01 * (rng.random((R, N, N)) - 0.5),
                     dtype=dtype)
    E = torch.tensor(rng.random((R, N, N)), dtype=dtype)
    r0, c0 = i * bn, j * bw
    Ub = F[:, r0:r0 + bn, c0:c0 + bw].contiguous()
    Eb = E[:, r0:r0 + bn, c0:c0 + bw].contiguous()
    halo = (F[:, r0 - 1, c0:c0 + bw].contiguous(),
            F[:, r0 + bn, c0:c0 + bw].contiguous(),
            F[:, r0:r0 + bn, c0 - 1].contiguous(),
            F[:, r0:r0 + bn, c0 + bw].contiguous())
    A0s = torch.tensor(pairs()[:R, 0])
    A1s = torch.tensor(pairs()[:R, 1])
    kw = dict(N=N, delx=0.01, RT=1.5, B=0.3, threshold=0.875)
    K.reset_launches()
    for e in (Eb, None):
        got = K.local_band_sums_members(Ub, *halo, e, A0s, A1s, r0, c0,
                                        **kw)
        assert torch.equal(got, K.local_band_sums_members_ref(
            Ub, *halo, e, A0s, A1s, r0, c0, **kw))
        for r in range(R):
            one = K.local_band_sums_ref(
                Ub[r], *(h[r] for h in halo), None if e is None else e[r],
                float(A0s[r]), float(A1s[r]), r0, c0, **kw)
            assert torch.equal(got[r], one)
    assert K.launches['local_band_sums_members'] == 0   # the CPU path
    with pytest.raises(ValueError, match='up_row'):
        K.local_band_sums_members(Ub, halo[0][:, 1:], *halo[1:], Eb, A0s,
                                  A1s, r0, c0, **kw)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k11_plain_version_is_the_single_runs_ra(dtype):
    """K11's plain version (each member's Ra) is the single run's Ra of
    the member's field (``core/stepper.py`` ``_stats``), to the bit; the
    CPU path counts no launch."""
    rng = np.random.default_rng(4)
    R, N = 3, 40
    U = torch.tensor(0.875 + 0.01 * (rng.random((R, N, N)) - 0.5),
                     dtype=dtype)
    K.reset_launches()
    got = K.row_absdev_members(U, N // 2 + 1)
    assert torch.equal(got, K.row_absdev_members_ref(U, N // 2 + 1))
    for r in range(R):
        mid = U[r, N // 2 + 1, :]
        one = torch.mean(torch.abs(mid - torch.mean(mid))).to(torch.float64)
        assert torch.equal(got[r], one)
    assert K.launches['row_absdev_members'] == 0
    with pytest.raises(ValueError, match='row'):
        K.row_absdev_members(U, N)


# ----------------------------------------------------------------------
# the single run's checkpoint on a 2x2 world
# ----------------------------------------------------------------------

def _grid_params(**kw):
    return dict(N=32, no_gui=True, full_sim=True, generator='uniform',
                kappa_tilde=KAPPA, device='cpu', chunk_size=5, **kw)


@pytest.fixture(scope='module')
def grid_checkpoint(tmp_path_factory):
    """A 2x2 world saving at step 16 (chunks of 5, every 15 steps) and
    running on to 30, beside the run that re-enters at 16 and the one
    that runs straight to 30; then a new 2x2 world restoring the file and
    running to 30."""
    ck = str(tmp_path_factory.mktemp('grid_ckpt') / 'mesh.npz')
    first = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                       threads=1, timeout=300, args=([
                           ('solve', {'params': _grid_params(
                               checkpoint_file=ck, checkpoint_every=15),
                               'steps': 30, 'return_U': True}),
                           ('solve', {'params': _grid_params(),
                                      'steps': [16, 14]})],))
    second = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                        threads=1, timeout=300, args=([
                            ('solve', {'params': dict(
                                restore_file=ck, ntmax=14, no_gui=True,
                                device='cpu')})],))
    return ck, first, second


def test_mesh_checkpoint_restores_on_a_new_world(grid_checkpoint):
    """The restored world is the run that re-enters the solve at the
    saved step (a resume recomputes the spectral image, the reference's
    entry semantics) to the bit, on every rank, and within 1e-12 of the
    run that went straight on."""
    ck, first, second = grid_checkpoint
    restored = [r[0] for r in second]
    same_on_every_rank(restored, 'timedata')
    same_on_every_rank(restored, 'U')
    got = restored[0]
    reentry = first[0][1]
    straight = first[0][0]
    assert got['computed_steps'] == reentry['computed_steps'] == 30
    assert got['mesh'].startswith('mesh 2x2')
    assert np.array_equal(got['timedata'], reentry['timedata'])
    assert np.array_equal(got['U'], reentry['U'])
    np.testing.assert_allclose(got['timedata'], straight['timedata'],
                               rtol=1e-12)


def test_mesh_checkpoint_loads_in_the_jax_package(grid_checkpoint):
    ck, first, _ = grid_checkpoint
    jparams, payload = jax_load_checkpoint(ck)
    assert tuple(jparams.mesh_shape) == (2, 2)
    assert payload['header']['computed_steps'] == 16
    assert payload['U'].shape == (32, 32)
    params, mine = tck.load_checkpoint(ck, device='cpu')
    assert params.mesh_shape == (2, 2)
    assert np.array_equal(mine['U'], payload['U'])
    np.testing.assert_array_equal(payload['timedata'],
                                  first[0][0]['timedata'][:16])


# ----------------------------------------------------------------------
# the multi-process experiment CLI
# ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _experiment(cwd, *extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('XLA_FLAGS', None)
    return subprocess.Popen(
        [sys.executable, '-m', 'chsimpy_tpu_torch.experiment', *EXP_ARGS,
         '--device', 'cpu', *extra], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_two_process_experiment_cli_byte_identical_results(tmp_path):
    """scripts/run_distributed_experiment.py for the port: two processes
    of the experiment CLI (gloo) write results.csv and results-agg.csv
    byte-identical to the same command line run as one process; each
    process writes the per-run files of the runs it owns."""
    dirs = [tmp_path / 'p0', tmp_path / 'p1']
    single_dir = tmp_path / 'single'
    for d in dirs + [single_dir]:
        d.mkdir()
    coord = f'127.0.0.1:{_free_port()}'
    procs = [_experiment(dirs[pid], '--coordinator', coord,
                         '--num-processes', '2', '--process-id', str(pid),
                         '--dist-backend', 'gloo') for pid in (0, 1)]
    procs.append(_experiment(single_dir))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    for suffix in ('-results.csv', '-results-agg.csv'):
        a = (dirs[0] / f'distexp{suffix}').read_bytes()
        b = (single_dir / f'distexp{suffix}').read_bytes()
        assert a == b, suffix
    files = [sorted(os.listdir(d)) for d in dirs]
    assert sorted(files[0] + files[1]) == sorted(os.listdir(single_dir))
    # process p wrote the per-run files of the runs r % 2 == p alone
    for p, names in enumerate(files):
        runs = [int(n.split('-run')[1].split('.')[0]) for n in names
                if '-run' in n]
        assert runs and all(r % 2 == p for r in runs)
    assert 'distexp-results.csv' not in files[1]
    # only process 0 prints the parameters and the tables
    assert "'N': 32" in outs[0] and "'N': 32" not in outs[1]
    assert 'Output files:' in outs[0] and 'Output files:' not in outs[1]


def test_a_coordinator_without_its_peer_fails_naming_it(tmp_path):
    """A process whose peer never comes fails within the store's timeout
    with an error naming the coordinator (no fallback to one process)."""
    coord = f'127.0.0.1:{_free_port()}'
    code = ("from chsimpy_tpu_torch.parallel import distributed\n"
            f"distributed.initialize('gloo', 'cpu', coordinator_address="
            f"'{coord}', num_processes=2, process_id=0, timeout=3)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f'coordinator {coord}' in proc.stderr
