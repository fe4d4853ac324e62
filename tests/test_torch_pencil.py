"""The pencil layout of chsimpy_tpu_torch (``--mesh MxN`` with ``--transform
split`` or ``ozaki``: ``parallel/mesh.py`` field and spectral views,
``parallel/collectives.py`` transposes, ``ops/dct.py`` and ``ops/ozaki.py``
pencil transforms, K5 sharded, ``parallel/audit.py``) on the CPU, against
the JAX package's pencil runs (its Solver and ensemble on meshes of the
virtual CPU devices) and the port's own one-rank and unsharded runs.

Worlds of gloo ranks come from ``spawn_grid`` / ``spawn_world``, one per
shape for the module.  Bounds are tests/test_sharding.py's: U 1e-13
absolute and E 1e-12 relative against JAX and the unsharded runs.  Against
the one-rank pencil run the fields are held to the bit: every product
contracts a local axis and the CPU's products give the columns (rows) of
the whole product's bits, and the ozaki mean is summed column by column,
in the same order for any rank count.  E sums the ranks' partials in rank
order, so it is held to 1e-13 relative there.

The ozaki route's forward transform keeps the pair cutoffs (3, 5) by
default: it drops the slice products below 2^-28 of its scale, so a mean
that differs in its last bit moves the result by that much more than an
ulp.  The JAX package's own pencil runs differ so between mesh shapes (U
3.0e-13 apart on (1, 1) and (2, 2) after these 30 steps, where their
means are summed in other orders; its test_sharding.py compares (1, 1)
with (2, 4), whose means agree), and its unsharded route, which folds,
lies 3.7e-11 away.  So the ozaki runs are held to JAX's bound with the
untrimmed cutoffs (5, 7), and with the default cutoffs to 1e-12.  Against
the port's one-device ozaki route, which folds and so slices other
operands, the untrimmed runs are held to 1e-12: that route is itself
1.3e-13 from the float64 matmul route after these 30 steps.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import material as jmaterial
from chsimpy_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from chsimpy_tpu.core.solver import Solver as JaxSolver
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble
from chsimpy_tpu.ops import ozaki as jozaki
from chsimpy_tpu.parallel.mesh import make_ensemble_mesh

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.parallel.distributed import spawn_grid, spawn_world
from chsimpy_tpu_torch.parallel.workers import run_tasks

from test_torch_ozaki import _assert_scale

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4
# tests/test_sharding.py's _pencil_params
PENCIL = dict(N=64, full_sim=True, generator='lcg', precision='float64',
              kappa_tilde=KAPPA)
STEPS = {'split': 40, 'ozaki': 30}
FULL = {'ozaki_fwd_pairs': (5, 7)}     # the untrimmed forward transform
# -a adapts delt from step 502 on: 520 steps take 10 adaptations
ADAPTIVE_STEPS = 520
FACTORS = [(1.001, 0.999), (0.999, 1.001)]


def port(tb, **kw):
    return {**PENCIL, 'transform_backend': tb, 'no_gui': True,
            'device': 'cpu', 'ntmax': STEPS[tb], **kw}


def pairs():
    A0 = jmaterial.A0(923.15)
    A1 = jmaterial.A1(923.15)
    return np.array([[A0 * f0, A1 * f1] for f0, f1 in FACTORS])


def jax_params(tb, mesh_shape, **kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in {**PENCIL, 'transform_backend': tb, 'ntmax': STEPS[tb],
                 'mesh_shape': mesh_shape, **kw}.items():
        setattr(p, k, v)
    return p


# the jitter modes on the split route: the host stream cut to the rank's
# columns, and K9 (device_sobol) and K10 (device) on the column block
JITTER = {'stream': dict(generator='uniform', jitter=0.01),
          'device_sobol': dict(generator='sobol', jitter=0.01,
                               jitter_backend='device'),
          'device': dict(generator='uniform', jitter=0.01,
                         jitter_backend='device')}

# the solves of each single-run world, in this order
SPLIT, OZAKI, OZAKI_FULL = range(3)
JITTERED = {mode: 3 + k for k, mode in enumerate(JITTER)}
ADAPTIVE = 3 + len(JITTER)


def solve_tasks():
    return [('solve', {'params': p, 'steps': p['ntmax']})
            for p in (port('split'), port('ozaki'), port('ozaki', **FULL),
                      *(port('split', **kw) for kw in JITTER.values()),
                      port('split', adaptive_time=True,
                           ntmax=ADAPTIVE_STEPS))]


def world(shape, tasks):
    kw = dict(backend='gloo', device='cpu', args=(tasks,), timeout=300,
              threads=1)
    if len(shape) == 3:
        return spawn_world(run_tasks, shape, **kw)
    return spawn_grid(run_tasks, shape, **kw)


def seeded_fields():
    """A field whose max lies in one column block and one row block only
    and is one ulp above a power of two, and a member stack with such a
    member."""
    rng = np.random.default_rng(2024)
    x = 0.3 * rng.standard_normal((64, 64))
    x[3, 40] = np.nextafter(2.0, 3.0)
    xm = 0.3 * rng.standard_normal((2, 64, 64))
    xm[1, 50, 7] = -np.nextafter(0.5, 1.0)
    return x, xm


SLICE_CASES = [('field', False), ('spec', False), ('field', True),
               ('spec', True)]
# the other tasks of the 2x2 world, after its solves
TRANSPOSES = 7
SLICES = 8
AUDIT_SPLIT, AUDIT_OZAKI, AUDIT_GRID = 12, 13, 14
SAVED, REENTRY, DCTS = 15, 16, 17


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp('pencil_ckpt') / 'pencil.npz')
    x, xm = seeded_fields()
    grid = dict(chunk_size=5, generator='uniform', full_sim=True)
    tasks22 = solve_tasks() + [
        ('transposes', {'N': 64}),
        *[('slice_sharded', {'x': xm if m else x, 'n_slices': 6,
                             'members': m, 'layout': lay})
          for lay, m in SLICE_CASES],
        ('audit', {'N': 64, 'precision': 'float32', 'transform': 'split'}),
        ('audit', {'N': 64, 'precision': 'float64', 'transform': 'ozaki'}),
        ('audit', {'N': 64, 'precision': 'float32', 'transform': 'matmul'}),
        ('solve', {'params': port('split', checkpoint_file=ck,
                                  checkpoint_every=15, **grid),
                   'steps': 30}),
        ('solve', {'params': port('split', **grid), 'steps': [16, 14]}),
        ('pencil_dcts', {'U': seeded_fields()[0], 'dtype': 'float64'})]
    ens = [('ensemble', {'params': p, 'pairs': pairs(),
                         'kappas': [KAPPA] * 2, 'steps': 30})
           for p in (port('split', ntmax=30), port('ozaki', **FULL))]

    def others():
        return {'12': world((1, 2), solve_tasks()[:ADAPTIVE]),
                '11': world((1, 1), solve_tasks()),
                'ens': world((2, 2, 2), ens)}

    # two worlds at a time: the 2x2 world and the restore that reads its
    # checkpoint beside the others
    with ThreadPoolExecutor(1) as pool:
        rest = pool.submit(others)
        out = {'22': world((2, 2), tasks22),
               'restored': world((1, 4), [('solve', {'params': dict(
                   restore_file=ck, ntmax=14, no_gui=True,
                   device='cpu')})]),
               'ck': ck}
        out.update(rest.result())
    return out


def rank0(results, i):
    return results[0][i]


def same_on_every_rank(results, i, keys=('timedata', 'U')):
    for key in keys:
        for r in results[1:]:
            assert np.array_equal(np.asarray(r[i][key]),
                                  np.asarray(results[0][i][key])), key


def jax_solve(tb, mesh_shape, **kw):
    s = JaxSolver(jax_params(tb, mesh_shape, **kw))
    assert s.cfg.pencil
    if 'jitter' in kw:
        assert s.cfg.jitter_mode == next(
            m for m, j in JITTER.items() if j == kw)
    s.prepare()
    s.solve_or_resume(STEPS[tb])
    return np.asarray(s.solution.U), s.solution.timedata.data()


# ----------------------------------------------------------------------
# single runs
# ----------------------------------------------------------------------

# (task, route, the JAX run's extra params, U's bound)
JAX_CASES = {'split': (SPLIT, 'split', {}, 1e-13),
             'ozaki': (OZAKI_FULL, 'ozaki', FULL, 1e-13),
             'ozaki_trimmed': (OZAKI, 'ozaki', {}, 1e-12)}


@pytest.mark.parametrize('case', list(JAX_CASES))
@pytest.mark.parametrize('shape', ['12', '22'])
def test_pencil_world_matches_the_jax_pencil_run(runs, case, shape):
    i, tb, kw, atol = JAX_CASES[case]
    got = rank0(runs[shape], i)
    assert got['pencil'] and got['computed_steps'] == STEPS[tb]
    same_on_every_rank(runs[shape], i)
    U, td = jax_solve(tb, (int(shape[0]), int(shape[1])), **kw)
    np.testing.assert_allclose(got['U'], U, rtol=0, atol=atol)
    np.testing.assert_allclose(got['timedata'][:, 1], td[:, 1], rtol=1e-12)


@pytest.mark.parametrize('i', [SPLIT, OZAKI])
@pytest.mark.parametrize('shape', ['12', '22'])
def test_pencil_world_is_the_one_rank_pencil_run(runs, i, shape):
    got, one = rank0(runs[shape], i), rank0(runs['11'], i)
    assert one['pencil']
    assert np.array_equal(got['U'], one['U'])
    np.testing.assert_allclose(got['timedata'], one['timedata'], rtol=1e-13)


@pytest.mark.parametrize('i', [SPLIT, OZAKI_FULL])
def test_pencil_world_is_near_the_unsharded_run(runs, i):
    """The one-device split route nests the inverse's sums the other way
    round, and the one-device ozaki route folds: the same transforms, to
    the float64 class (ozaki untrimmed, see the module's docstring)."""
    got = rank0(runs['22'], i)
    tb, kw, atol = (('split', {}, 1e-13) if i == SPLIT
                    else ('ozaki', FULL, 1e-12))
    sol = ctt.Simulator(ctt.Parameters(**port(tb, **kw))).solve()
    np.testing.assert_allclose(got['U'], sol.U.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(got['timedata'][:, 1],
                               sol.timedata.data()[:, 1], rtol=1e-12)


@pytest.mark.parametrize('mode', list(JITTER))
@pytest.mark.parametrize('shape', ['12', '22'])
def test_jittered_pencil_world(runs, mode, shape):
    """The jitter on the column block (the host slab cut to the rank's
    columns; K9 and K10 at the block's column offset), the statistics'
    halo columns exchanged over the (1, D) view: JAX's pencil run with
    the same jitter (U 1e-13, E 1e-12) and the port's one-rank pencil run
    (U to the bit, E 1e-13)."""
    i = JITTERED[mode]
    got, one = rank0(runs[shape], i), rank0(runs['11'], i)
    assert got['pencil'] and got['computed_steps'] == STEPS['split']
    same_on_every_rank(runs[shape], i)
    assert np.array_equal(got['U'], one['U'])
    np.testing.assert_allclose(got['timedata'], one['timedata'], rtol=1e-13)
    U, td = jax_solve('split', (int(shape[0]), int(shape[1])),
                      **JITTER[mode])
    np.testing.assert_allclose(got['U'], U, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got['timedata'][:, 1], td[:, 1], rtol=1e-12)


def test_pencil_adaptive_delt_column_to_the_bit(runs):
    """Each column is whole on its rank: the column sums need no
    exchange, only their minimum crosses ranks."""
    got, one = rank0(runs['22'], ADAPTIVE), rank0(runs['11'], ADAPTIVE)
    same_on_every_rank(runs['22'], ADAPTIVE)
    delt = got['timedata'][:, 8]
    assert got['computed_steps'] == ADAPTIVE_STEPS
    assert len(np.unique(delt)) > 2          # it adapted
    assert np.array_equal(delt, one['timedata'][:, 8])
    assert np.array_equal(got['U'], one['U'])


def test_pencil_footprint_is_total_over_D(runs):
    """tests/test_sharding.py:353-374: every field-sized leaf holds
    total/D bytes on each rank (U a column block, hat_U a row block)."""
    shapes = rank0(runs['22'], SPLIT)['block_shapes']
    assert tuple(shapes['U']) == (64, 16)
    assert tuple(shapes['hat_U']) == (16, 64)
    for s in shapes.values():
        assert 4 * s[0] * s[1] == 64 * 64


# ----------------------------------------------------------------------
# the ensemble
# ----------------------------------------------------------------------

@pytest.mark.parametrize('tb', ['split', 'ozaki'])
def test_pencil_ensemble_matches_jax_and_the_unsharded_ensemble(runs, tb):
    """Split against JAX's ensemble on make_ensemble_mesh(2, (2, 2)) and
    the port's unsharded ensemble; ozaki (untrimmed) against the port's
    unsharded ensemble, which folds."""
    res = runs['ens']
    i = ('split', 'ozaki').index(tb)
    kw, atol = ({}, 1e-13) if tb == 'split' else (FULL, 1e-12)
    for r in res[1:]:
        for a, b in zip(r[i]['timedata'], res[0][i]['timedata']):
            assert np.array_equal(a, b)
        assert np.array_equal(r[i]['U'], res[0][i]['U'])
    got = res[0][i]
    assert got['mesh'].startswith("mesh ('ens', 'x', 'y') = (2, 2, 2)")
    ref = EnsembleSolver(ctt.Parameters(**port(tb, ntmax=30, **kw)),
                         pairs(), kappas=[KAPPA] * 2)
    ref.prepare()
    want = [ref.solve_or_resume(30)]
    if tb == 'split':
        j = JaxEnsemble(jax_params(tb, None, ntmax=30), pairs(),
                        mesh=make_ensemble_mesh(2, (2, 2)))
        assert j.cfg.pencil
        j.prepare()
        want.append(j.solve_or_resume(30))
    for sols in want:
        for r, s in enumerate(sols):
            np.testing.assert_allclose(got['U'][r], np.asarray(s.U), rtol=0,
                                       atol=atol)
            np.testing.assert_allclose(got['timedata'][r][:, 1],
                                       s.timedata.data()[:, 1], rtol=1e-12)


# ----------------------------------------------------------------------
# K5 sharded's plain version, the transposes, the audit
# ----------------------------------------------------------------------

@pytest.mark.parametrize('case', range(len(SLICE_CASES)))
def test_k5_sharded_is_the_whole_field_slice_on_each_block(runs, case):
    """Each rank's planes are JAX's slice_field of the whole field (of
    each member) restricted to its block, to the bit, and its scale the
    whole field's: the max lies in one block only and one ulp above a
    power of two, so a block's own max would give another scale."""
    import jax
    import jax.numpy as jnp
    layout, members = SLICE_CASES[case]
    x, xm = seeded_fields()
    fields = xm if members else x[None]
    whole = [jozaki.slice_field(jnp.asarray(f), 6) for f in fields]
    for rank, res in enumerate(runs['22']):
        planes, scale = res[SLICES + case]
        sl = slice(16 * rank, 16 * (rank + 1))
        for m, (p, s) in enumerate(whole):
            p = np.asarray(jax.device_get(p))
            p = p[:, :, sl] if layout == 'field' else p[:, sl, :]
            mine = planes[:, m] if members else planes
            assert np.array_equal(mine, p)
            _assert_scale(scale[m] if members else scale, s)
    if not members:
        own = jozaki.slice_field(jnp.asarray(x[:, :16]), 6)[1]
        assert float(own) < 0.5 * float(whole[0][1])


def test_pencil_transforms_are_the_whole_field_transforms(runs):
    """The matmul and split routes' pencil forms, gathered, against the
    one-device transforms of the whole field (float64; the inverses nest
    their sums the other way round)."""
    from chsimpy_tpu_torch.ops import dct as dct_ops
    U = torch.tensor(seeded_fields()[0])
    C = dct_ops.dct_matrix(64)
    tree = dct_ops.split_tree(64, 2)
    want = (dct_ops.dct2(U, C), dct_ops.idct2(U, C),
            dct_ops.dct2_split_perm(U, tree),
            dct_ops.idct2_split_perm(U, tree))
    for r in runs['22']:
        for k, (got, w) in enumerate(zip(r[DCTS], want)):
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-13)
            assert np.array_equal(got, runs['22'][0][DCTS][k])


def test_block_bits_tool(capsys):
    """``benchmarks/block_bits.py``: on the CPU a float64 product's column
    and row blocks give the whole product's bits (what the pencil runs'
    bits across rank counts rest on here)."""
    from chsimpy_tpu_torch.benchmarks import block_bits
    lines = block_bits.main(['--sizes', '64', '--ranks', '2,4',
                             '--device', 'cpu'])
    assert len(lines) == 2 and capsys.readouterr().out.count('\n') == 2
    assert lines[0] == ('N=64 float64: D=2: column blocks True, row blocks '
                        'True; D=4: column blocks True, row blocks True')


def test_transposes_round_trip(runs):
    got = rank0(runs['22'], TRANSPOSES)
    for r in runs['22']:
        assert r[TRANSPOSES] == got
    assert got == {'pencil': (True, True), 'members': (True, True),
                   'int8': (True, True)}


def test_audit_split_moves_transposes_not_gathers(runs):
    """tests/test_sharding.py test_pencil_field_layout_and_audit on a
    (2, 2) world: all-to-alls, no all-gather, less than a field a step,
    no single collective above a quarter of the field; the statistics'
    halo columns cross in the exchange over the (1, D) view."""
    res = rank0(runs['22'], AUDIT_SPLIT)
    assert res['pencil'] and res['per_op_bytes']['all-to-all'] > 0
    assert res['per_op_bytes']['all-gather'] == 0
    assert res['per_op_bytes']['collective-permute'] > 0
    assert res['total_bytes'] < res['field_bytes']
    assert res['max_single_collective_bytes'] <= res['field_bytes'] // 4


def test_audit_entry_point_runs_on_the_card_unless_asked():
    """``audit_sharded_chunk`` runs on the card by default, as every entry
    point of the port; asked for the CPU it runs a world of gloo ranks."""
    import inspect
    from chsimpy_tpu_torch.parallel.audit import audit_sharded_chunk
    sig = inspect.signature(audit_sharded_chunk)
    assert sig.parameters['device'].default == 'cuda'
    res = audit_sharded_chunk(32, (1, 2), 'float32', transform='split',
                              device='cpu')
    assert res['pencil'] and res['per_op_bytes']['all-to-all'] > 0
    assert res['per_op_bytes']['all-gather'] == 0
    assert res['max_single_collective_bytes'] <= res['field_bytes'] // 2


def test_audit_ozaki_moves_the_slice_stacks(runs):
    res = rank0(runs['22'], AUDIT_OZAKI)
    assert res['pencil'] and res['per_op_bytes']['all-to-all'] > 0
    assert res['per_op_bytes']['all-gather'] == 0
    assert res['total_bytes'] < 3 * res['field_bytes']


def test_audit_grid_route_gathers_more_than_the_pencil(runs):
    grid = rank0(runs['22'], AUDIT_GRID)
    pencil = rank0(runs['22'], AUDIT_SPLIT)
    assert not grid['pencil'] and grid['per_op_bytes']['all-gather'] > 0
    assert grid['per_op_bytes']['all-to-all'] == 0
    assert pencil['total_wire_bytes'] < grid['total_wire_bytes']
    assert pencil['total_bytes'] < grid['total_bytes']


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def test_pencil_checkpoint_restores_on_a_world_of_another_shape(runs):
    """Saved on a 2x2 world at step 16, restored on a 1x4 world (the same
    pencil layout): the run that re-entered at 16, to the bit."""
    restored = runs['restored']
    same_on_every_rank(restored, 0)
    got, reentry = restored[0][0], rank0(runs['22'], REENTRY)
    assert got['mesh'].startswith('mesh 1x4') and got['pencil']
    assert got['computed_steps'] == reentry['computed_steps'] == 30
    assert np.array_equal(got['timedata'], reentry['timedata'])
    assert np.array_equal(got['U'], reentry['U'])


def test_pencil_checkpoint_loads_in_the_jax_package(runs):
    jparams, payload = jax_load_checkpoint(runs['ck'])
    assert tuple(jparams.mesh_shape) == (2, 2)
    assert jparams.transform_backend == 'split'
    assert payload['header']['computed_steps'] == 16
    np.testing.assert_array_equal(payload['timedata'],
                                  rank0(runs['22'], SAVED)['timedata'][:16])


# ----------------------------------------------------------------------
# what stays refused
# ----------------------------------------------------------------------

@pytest.mark.parametrize('transform,N,exc,match', [
    ('fft', 64, ValueError, 'does not shard under --mesh'),
    ('split', 66, ValueError, 'divisible by the device count 4'),
    ('ozaki', 66, RuntimeError, 'process group'),
])
def test_pencil_refusals(transform, N, exc, match):
    # ozaki with N not divisible by the rank count is no refusal: it
    # takes the grid layout (tests/test_torch_grid.py), and asks for its
    # world
    p = ctt.Parameters(N=N, no_gui=True, device='cpu', kappa_tilde=KAPPA,
                       precision='float64', mesh_shape=(2, 2),
                       transform_backend=transform)
    with pytest.raises(exc, match=match):
        ctt.Solver(p)
    with pytest.raises(exc, match=match):
        EnsembleSolver(p, pairs())
