"""The grid layout of chsimpy_tpu_torch where the JAX package's default
path runs it: the matmul route on blocks whose sides are no multiple of 8
(``core/solver.py`` ``check_grid_mesh``: N divisible by mx and by my), and
the ozaki route with N not divisible by the rank count (``ops/ozaki.py``
``dct2_ozaki_grid`` / ``idct2_ozaki_grid``, K5 sharded, the strip gathers
of ``parallel/collectives.py``), for the single run, the grid ensemble, a
checkpoint, the audit and the experiment, on the CPU.

Worlds of gloo ranks come from ``spawn_grid`` / ``spawn_world``; the JAX
runs use the test process's 8 virtual CPU devices (tests/conftest.py).
Bounds: tests/test_sharding.py's (U 1e-12 absolute, E 1e-12 and E2 1e-10
relative, the same stop) against the JAX mesh runs and the port's own
one-device runs, with the ozaki forward untrimmed ((5, 7), as there: the
port's one-device ozaki route folds, and its grid mean is summed in
another order than JAX's), and the same rows on every rank.  A rank's
block of the grid ozaki transforms is the one-device unfolded
transform's block to the bit, given the same mean (column by column,
then the columns in order: the pencil layout's order).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import material as jmaterial
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble
from chsimpy_tpu.parallel.mesh import make_ensemble_mesh

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import ozaki
from chsimpy_tpu_torch.parallel.distributed import spawn_grid, spawn_world
from chsimpy_tpu_torch.parallel.workers import run_tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAPPA = 2.98911291966116e-4
STEPS = 20
BASE = dict(full_sim=True, generator='lcg', precision='float64',
            kappa_tilde=KAPPA, ntmax=STEPS)
FULL = {'ozaki_fwd_pairs': (5, 7)}
# name: (mesh, N, route, the port's and JAX's extra params); the rank
# count divides none of these N, and N=40 and 36 are no multiple of 8*mx
CASES = {'matmul_40_2x2': ((2, 2), 40, 'matmul', {}),
         'matmul_36_2x4': ((2, 4), 36, 'matmul', {}),
         'ozaki_34_2x2': ((2, 2), 34, 'ozaki', FULL),
         'ozaki_36_2x4': ((2, 4), 36, 'ozaki', FULL)}
FACTORS = [(1.001, 0.999), (0.999, 1.001)]
ENS_CASES = {'matmul_40': (40, 'matmul', {}), 'ozaki_34': (34, 'ozaki', FULL)}


# scripts/run_distributed_experiment.py:37-40, on the grid ozaki route
EXP_ARGS = ['-N', '34', '-n', '12', '--generator', 'lcg', '--seed', '2023',
            '--kappa-tilde', '2.98911291966116e-4', '--runs', '2',
            '--A-source', 'uniform', '--A-seed', '85972', '--file-id',
            'gridexp', '--host-procs', '1', '--export-csv', 'E2',
            '--transform', 'ozaki', '--precision', 'float64',
            '--device', 'cpu', '--dist-backend', 'gloo']


def port(N, tb, **kw):
    return {**BASE, 'N': N, 'transform_backend': tb, 'no_gui': True,
            'device': 'cpu', **kw}


def pairs():
    A0 = jmaterial.A0(923.15)
    A1 = jmaterial.A1(923.15)
    return np.array([[A0 * f0, A1 * f1] for f0, f1 in FACTORS])


def jax_params(values):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in values.items():
        if k != 'device':
            setattr(p, k, v)
    return p


def seeded(N, R=0):
    rng = np.random.default_rng(N + R)
    shape = (R, N, N) if R else (N, N)
    return 0.8 + 0.3 * rng.standard_normal(shape)


def world(shape, tasks):
    kw = dict(backend='gloo', device='cpu', args=(tasks,), timeout=300,
              threads=1)
    if len(shape) == 3:
        return spawn_world(run_tasks, shape, **kw)
    return spawn_grid(run_tasks, shape, **kw)


def mesh_tasks(shape, ck=None):
    """The solves of CASES on ``shape`` (in CASES order), the grid ozaki
    transforms of a field and of 2 members (trimmed and untrimmed), and on
    2x2 the trimmed ozaki run, a checkpointed run, its restore, and the
    audit."""
    tasks = [('solve', {'params': port(N, tb, **kw), 'steps': STEPS})
             for m, N, tb, kw in CASES.values() if m == shape]
    N = [c[1] for c in CASES.values() if c[0] == shape and
         c[2] == 'ozaki'][0]
    tasks += [('ozaki_grid', {'x': seeded(N)}),
              ('ozaki_grid', {'x': seeded(N, 2), 's1': 5, 's2': 7})]
    if ck is not None:
        grid = dict(chunk_size=5)
        tasks += [('solve', {'params': port(N, 'ozaki'), 'steps': STEPS}),
                  ('solve', {'params': port(N, 'ozaki', checkpoint_file=ck,
                                            checkpoint_every=14, **grid),
                             'steps': [15, 5]}),
                  ('solve', {'params': dict(restore_file=ck, ntmax=5,
                                            no_gui=True, device='cpu')}),
                  ('audit', {'N': N, 'precision': 'float64',
                             'transform': 'ozaki'}),
                  ('audit', {'N': 2 * N - 2, 'precision': 'float64',
                             'transform': 'ozaki'})]
    return tasks


# the 2x2 world's tasks after its two solves and two transforms
OZ_TRIMMED, SAVED, RESTORED, AUDIT, AUDIT_66 = 4, 5, 6, 7, 8


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('grid')
    ck = str(tmp / 'grid.npz')
    ens = [('ensemble', {'params': port(N, tb, **kw), 'pairs': pairs(),
                         'kappas': [KAPPA] * 2, 'steps': STEPS})
           for N, tb, kw in ENS_CASES.values()]
    exp = tmp / 'exp'
    exp_tasks = [('experiment', {'argv': EXP_ARGS + ['--mesh', '2x2'],
                                 'cwd': str(exp)})]

    def others():
        return {'24': world((2, 4), mesh_tasks((2, 4))),
                'ens': world((2, 2, 2), ens)}

    with ThreadPoolExecutor(1) as pool:
        rest = pool.submit(others)
        out = {'22': world((2, 2), mesh_tasks((2, 2), ck)),
               'exp': world((1, 2, 2), exp_tasks), 'exp_dir': exp,
               'tmp': tmp}
        out.update(rest.result())
    return out


def same_on_every_rank(results, i, keys=('timedata', 'U')):
    for key in keys:
        for r in results[1:]:
            assert np.array_equal(np.asarray(r[i][key]),
                                  np.asarray(results[0][i][key])), key


def assert_close(got_U, got_td, U, td, steps=None):
    """tests/test_sharding.py's bounds."""
    np.testing.assert_allclose(got_U, U, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_td[:, 1], td[:, 1], rtol=1e-12)
    np.testing.assert_allclose(got_td[:, 2], td[:, 2], rtol=1e-10)


def case_result(runs, name):
    shape, N, tb, kw = CASES[name]
    key = '%d%d' % shape
    i = [n for n, c in CASES.items() if c[0] == shape].index(name)
    return runs[key], i


# ----------------------------------------------------------------------
# single runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name', list(CASES))
def test_grid_world_matches_the_jax_mesh_run(runs, name):
    shape, N, tb, kw = CASES[name]
    res, i = case_result(runs, name)
    got = res[0][i]
    assert not got['pencil'] and got['computed_steps'] == STEPS
    assert got['block_shapes']['U'] == (N // shape[0], N // shape[1])
    same_on_every_rank(res, i)
    sim = ct.Simulator(jax_params({**port(N, tb, **kw),
                                   'mesh_shape': shape}))
    assert not sim.solver.cfg.pencil
    sol = sim.solve()
    assert sol.computed_steps == got['computed_steps']
    assert_close(got['U'], got['timedata'], np.asarray(sol.U),
                 sol.timedata.data())


@pytest.mark.parametrize('name', list(CASES))
def test_grid_world_is_near_the_one_device_run(runs, name):
    """Against the port's one-device run of the route (ozaki: its folded
    route, untrimmed)."""
    shape, N, tb, kw = CASES[name]
    res, i = case_result(runs, name)
    got = res[0][i]
    sol = ctt.Simulator(ctt.Parameters(**port(N, tb, **kw))).solve()
    assert sol.computed_steps == got['computed_steps']
    assert_close(got['U'], got['timedata'], sol.U.numpy(),
                 sol.timedata.data())


def test_trimmed_grid_ozaki_run_is_near_the_jax_mesh_run(runs):
    """The default forward pairs (3, 5) drop the products below 2^-28 of
    the slices' scale, so the two packages' means, summed in other
    orders, part the runs by more than an ulp: held to 1e-12 (the pencil
    runs' bound for the trimmed route, tests/test_torch_pencil.py)."""
    got = runs['22'][0][OZ_TRIMMED]
    same_on_every_rank(runs['22'], OZ_TRIMMED)
    sol = ct.Simulator(jax_params({**port(34, 'ozaki'),
                                   'mesh_shape': (2, 2)})).solve()
    np.testing.assert_allclose(got['U'], np.asarray(sol.U), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got['timedata'][:, 1],
                               sol.timedata.data()[:, 1], rtol=1e-12)


def test_grid_ozaki_keeps_the_grid_layout(runs):
    """The field and its spectral image both as (N/mx, N/my) blocks (the
    pencil layout would hold a column and a row block)."""
    for shape, N in (('22', 34), ('24', 36)):
        res, i = case_result(runs, f'ozaki_{N}_{shape[0]}x{shape[1]}')
        mx, my = int(shape[0]), int(shape[1])
        for r in res:
            assert not r[i]['pencil']
            assert r[i]['block_shapes'] == {'U': (N // mx, N // my),
                                            'hat_U': (N // mx, N // my)}
            assert r[i]['U_finite']


@pytest.mark.parametrize('shape', ['22', '24'])
@pytest.mark.parametrize('members', [False, True])
def test_grid_ozaki_transforms_are_the_unfolded_transforms_blocks(
        runs, shape, members):
    """Each rank's block of dct2_ozaki_grid is dct2_ozaki's block of the
    same field, to the bit, given the same mean (and idct2_ozaki_grid's
    idct2_ozaki's); the mean is the whole field's, summed column by
    column."""
    res = runs[shape]
    n_solves = sum(1 for c in CASES.values()
                   if '%d%d' % c[0] == shape)
    i = n_solves + int(members)
    got = res[0][i]
    for r in res[1:]:
        for k in ('dct2', 'idct2', 'mean'):
            assert np.array_equal(r[i][k], got[k])
    N = got['dct2'].shape[-1]
    U = torch.as_tensor(seeded(N, 2 if members else 0))
    s1, s2 = (5, 7) if members else (3, 5)
    m = U.transpose(-1, -2).contiguous().sum(-1).sum(-1) / float(N * N)
    assert np.array_equal(got['mean'], m.numpy())
    Cs, CsT, sc = ozaki.dct_slices(N)
    want = ozaki._transform2d(U - ozaki._bcast(m), Cs, CsT, sc, s1=s1,
                              s2=s2)
    want[..., 0, 0] += m * N
    assert np.array_equal(got['dct2'], want.numpy())
    assert np.array_equal(got['idct2'],
                          ozaki.idct2_ozaki(U, Cs, CsT, sc).numpy())


# ----------------------------------------------------------------------
# the grid ensemble
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name', list(ENS_CASES))
def test_grid_ensemble_matches_jax_and_the_unsharded_ensemble(runs, name):
    N, tb, kw = ENS_CASES[name]
    i = list(ENS_CASES).index(name)
    res = runs['ens']
    got = res[0][i]
    for r in res[1:]:
        for a, b in zip(r[i]['timedata'], got['timedata']):
            assert np.array_equal(a, b)
    values = port(N, tb, **kw)
    j = JaxEnsemble(jax_params({**values, 'mesh_shape': None}), pairs(),
                    mesh=make_ensemble_mesh(2, (2, 2)))
    j.prepare()
    one = EnsembleSolver(ctt.Parameters(**values), pairs(),
                         kappas=np.array([KAPPA] * 2))
    one.prepare()
    for ref in (j.solve_or_resume(STEPS), one.solve_or_resume(STEPS)):
        for r, s in enumerate(ref):
            assert got['computed_steps'][r] == s.computed_steps
            U = s.U.numpy() if torch.is_tensor(s.U) else np.asarray(s.U)
            assert_close(got['U'][r], got['timedata'][r], U,
                         s.timedata.data())


# ----------------------------------------------------------------------
# checkpoint, audits, experiment
# ----------------------------------------------------------------------

def test_grid_ozaki_checkpoint_restores(runs):
    """A run saved on the grid ozaki route at step 15 (the first chunk
    boundary 14 steps after the start), where it re-enters, and the file
    restored on the same mesh: the restored run continues with the saved
    run's rows and field, to the bit."""
    res = runs['22']
    saved, restored = res[0][SAVED], res[0][RESTORED]
    same_on_every_rank(res, RESTORED)
    assert saved['computed_steps'] == restored['computed_steps'] == 20
    assert restored['mesh'].startswith('mesh 2x2')
    assert not restored['pencil']
    assert np.array_equal(restored['timedata'], saved['timedata'])
    assert np.array_equal(restored['U'], saved['U'])


@pytest.mark.parametrize('i', [AUDIT, AUDIT_66])
def test_grid_ozaki_audit(runs, i):
    """tests/test_sharding.py:153-167's bounds: no collective moves the
    field, the total is at most 16 fields; strip gathers, no transpose."""
    a = runs['22'][0][i]
    assert a['transform'] == 'ozaki' and not a['pencil']
    assert a['max_single_collective_bytes'] < a['field_bytes']
    assert a['total_bytes'] <= 16 * a['field_bytes']
    assert a['per_op_bytes']['all-gather'] > 0
    assert a['per_op_bytes']['all-to-all'] == 0


def test_grid_ozaki_experiment(runs, tmp_path):
    """The experiment with --transform ozaki --mesh 2x2 at N=34 (4 does
    not divide 34) on a world of 4 processes: the members' fields on the
    grid ozaki route; process 0's tables and each run's E2 against the
    experiment in one process (the one-device route)."""
    one = tmp_path / 'one'
    one.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('XLA_FLAGS', None)
    proc = subprocess.run([sys.executable, '-m', 'chsimpy_tpu_torch.'
                           'experiment', *EXP_ARGS], cwd=one, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rank0 = runs['exp_dir'] / 'rank0'
    for r in range(2):
        name = f'gridexp-run{r}.solution.E2.csv'
        owner = runs['exp_dir'] / f'rank{r % 4}'
        got = np.loadtxt(owner / name, delimiter=',')
        want = np.loadtxt(one / name, delimiter=',')
        assert got.shape == want.shape == (12,)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    assert (rank0 / 'gridexp-results.csv').exists()
    assert not (runs['exp_dir'] / 'rank1' / 'gridexp-results.csv').exists()


# ----------------------------------------------------------------------
# the refusals
# ----------------------------------------------------------------------

@pytest.mark.parametrize('N,mesh', [(36, (1, 8)), (34, (4, 2))])
def test_a_mesh_that_n_does_not_tile_is_refused(N, mesh):
    """JAX's device_put refuses an uneven split: N % mx or N % my."""
    p = ctt.Parameters(**port(N, 'matmul'), mesh_shape=mesh)
    with pytest.raises(ValueError, match='divisible'):
        ctt.Solver(p)
    with pytest.raises(ValueError, match='divisible'):
        EnsembleSolver(p, pairs())
