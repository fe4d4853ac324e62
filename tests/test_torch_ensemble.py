"""The port's member-batched ensemble (chsimpy_tpu_torch/ensemble.py, K1-K4
``*_members``) against the JAX package's vmapped EnsembleSolver on the
CPU, float64, and against the port's own single runs.

The same (A0, A1) pairs and the same seeded fields go to both packages;
kappa_tilde is pinned as in tests/test_ensemble.py (or passed per member),
so no sympy solve runs.  Bounds: every trace row within 1e-12 relative of
the JAX ensemble (two float64 matmul orders), the same stop steps, tau0
and t0; against the port's single run of the member, the same bits (the
batched step does each member's arithmetic in the single step's order)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import material as jmaterial
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble
from chsimpy_tpu.ops import pallas_kernels as pk

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4
FACTORS = [(1.0, 1.0), (1.004, 0.997), (0.995, 1.005)]
# N=32 with delt = 1.4e-5 stops the three STOP_FACTORS members at steps
# 35, 33 and 46 (lcg field)
STOP_FACTORS = [(1.0, 1.0), (1.01, 1.01), (0.99, 0.99)]


def jax_params(**kw):
    p = ct.Parameters()
    p.N = 32
    p.ntmax = 40
    p.no_gui = True
    p.update_every = None
    p.full_sim = True
    p.generator = 'lcg'
    p.kappa_tilde = KAPPA
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def port_params(**kw):
    p = ctt.Parameters(N=32, ntmax=40, no_gui=True, update_every=None,
                       full_sim=True, generator='lcg', kappa_tilde=KAPPA,
                       device='cpu')
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def a_pairs(factors=FACTORS):
    A0 = jmaterial.A0(923.15)
    A1 = jmaterial.A1(923.15)
    return np.array([[A0 * f0, A1 * f1] for f0, f1 in factors])


def _run_both(kw, pairs, nsteps, kappas=None):
    j = JaxEnsemble(jax_params(**kw), pairs, kappas=kappas)
    j.prepare()
    jsols = j.solve_or_resume(nsteps)
    e = EnsembleSolver(port_params(**kw), pairs, kappas=kappas)
    e.prepare()
    return e, e.solve_or_resume(nsteps), jsols


def _assert_members_match(sols, jsols, U_atol=1e-12):
    assert len(sols) == len(jsols)
    for s, j in zip(sols, jsols):
        assert s.computed_steps == j.computed_steps
        assert s.stop_reason == j.stop_reason
        assert s.tau0 == j.tau0
        np.testing.assert_allclose(s.t0, j.t0, rtol=1e-12)
        a, b = s.timedata.data(), j.timedata.data()
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:, 1:3], b[:, 1:3], rtol=1e-12)
        np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-300)
        np.testing.assert_allclose(s.U.numpy(), np.asarray(j.U), rtol=0,
                                   atol=U_atol)


ENSEMBLE_CASES = {
    'matmul': dict(),
    'adaptive': dict(adaptive_time=True, delt=1e-6, delt_max=2e-6,
                     ntmax=60),
    'stream_jitter': dict(generator='uniform', jitter=0.01),
    'static_jitter': dict(generator='simplex', jitter=0.01),
    'time_limit': dict(time_max=3e-8 * 20 / 1.71e-8 / 60),
}


@pytest.mark.parametrize('case', sorted(ENSEMBLE_CASES))
def test_ensemble_matches_jax_ensemble(case):
    kw = ENSEMBLE_CASES[case]
    nsteps = kw.get('ntmax', 40)
    _, sols, jsols = _run_both(kw, a_pairs(), nsteps)
    _assert_members_match(sols, jsols)
    if case == 'time_limit':
        assert {s.stop_reason for s in sols} == {'time-limit'}


def test_per_member_early_stop_matches_jax():
    kw = dict(full_sim=False, delt=1.4e-5, ntmax=60)
    e, sols, jsols = _run_both(kw, a_pairs(STOP_FACTORS), 60)
    assert [s.computed_steps for s in sols] == [35, 33, 46]
    assert all(s.stop_reason == 'energy' for s in sols)
    _assert_members_match(sols, jsols)
    # a stopped member stays frozen: its row count is its stop step
    assert [len(s.timedata) for s in sols] == [35, 33, 46]


def test_per_member_kappas_match_jax():
    """Each member's own kappa (``kappas=``), as the experiment passes
    the sympy solutions."""
    kappas = KAPPA * np.array([1.0, 1.02, 0.97])
    _, sols, jsols = _run_both(dict(), a_pairs(), 40, kappas=kappas)
    _assert_members_match(sols, jsols)
    assert [s.kappa_tilde for s in sols] == list(kappas)


@pytest.mark.parametrize('case', ['matmul', 'split', 'fft', 'adaptive',
                                  'float32', 'stop'])
def test_members_equal_single_runs_to_the_bit(case):
    kw = {'matmul': dict(), 'split': dict(transform_backend='split'),
          'fft': dict(transform_backend='fft'),
          'adaptive': ENSEMBLE_CASES['adaptive'],
          'float32': dict(precision='float32'),
          'stop': dict(full_sim=False, delt=1.4e-5, ntmax=60)}[case]
    factors = STOP_FACTORS if case == 'stop' else FACTORS
    pairs = a_pairs(factors)
    nsteps = kw.get('ntmax', 40)
    e = EnsembleSolver(port_params(**kw), pairs)
    e.prepare()
    sols = e.solve_or_resume(nsteps)
    for (A0, A1), s in zip(pairs, sols):
        p = port_params(A0_const=float(A0), A1_const=float(A1), **kw)
        ref = ctt.Simulator(p).solve()
        assert s.computed_steps == ref.computed_steps
        assert np.array_equal(s.timedata.data(), ref.timedata.data())
        assert torch.equal(s.U, ref.U)


def test_resume_entry_and_mixed_entry_guard():
    """Re-entry continues every member (reference semantics);
    ``preserve_stops`` keeps stopped members stopped; members that mix
    fresh and resumed entry counts are refused, as in the JAX package."""
    kw = dict(full_sim=False, delt=1.4e-5, ntmax=60)
    pairs = a_pairs(STOP_FACTORS)
    e = EnsembleSolver(port_params(**kw), pairs)
    e.prepare()
    e.solve_or_resume(60)
    e.solve_or_resume(5, preserve_stops=True)
    assert [s.computed_steps for s in e.solutions()] == [35, 33, 46]
    j = JaxEnsemble(jax_params(**kw), pairs)
    j.prepare()
    j.solve_or_resume(60)
    jsols = j.solve_or_resume(5)
    _assert_members_match(e.solve_or_resume(5), jsols)
    e._states = e._states.replace(
        computed_steps=torch.tensor([1, 7, 7]))
    with pytest.raises(AssertionError, match='entry semantics'):
        e.solve_or_resume(3)


@contextlib.contextmanager
def _one_rank_world(tmp_path):
    """A torch.distributed world of this process alone (gloo)."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_ensemble_refusals_name_their_items(tmp_path):
    from chsimpy_tpu_torch.parallel.mesh import EnsembleMesh
    pairs = a_pairs()
    ref = EnsembleSolver(port_params(), pairs)
    ref.prepare()
    want = ref.solve_or_resume(12)
    with _one_rank_world(tmp_path):
        # an ensemble on a mesh, and with mesh_shape (the mesh built on
        # the process group), builds and runs: the same bits
        for e in (EnsembleSolver(port_params(), pairs,
                                 mesh=EnsembleMesh(1, (1, 1), 'cpu')),
                  EnsembleSolver(port_params(mesh_shape=(1, 1)), pairs)):
            assert e.mesh is not None and e.mesh.n_ens == 1
            e.prepare()
            for a, b in zip(e.solve_or_resume(12), want):
                assert np.array_equal(a.timedata.data(), b.timedata.data())
                assert torch.equal(a.U, b.U)
    # split and ozaki with grid-sharded member fields take the pencil
    # layout where the rank count divides N; at N=34 on 4 ranks split stays
    # refused and ozaki takes the grid layout, asking for its world
    for tb, exc, match in (('split', ValueError, 'device count 4'),
                           ('ozaki', RuntimeError, 'process group')):
        with pytest.raises(exc, match=match):
            EnsembleSolver(port_params(N=34, mesh_shape=(2, 2),
                                       precision='float64',
                                       transform_backend=tb), pairs)
    # the fold is the split route's, on member-local fields (item 14)
    with pytest.raises(ValueError, match='split transform route'):
        EnsembleSolver(port_params(fold_field=True), pairs)
    with pytest.raises(ValueError, match='host'):
        EnsembleSolver(port_params(generator='uniform', jitter=0.01,
                                   jitter_backend='device'), pairs)
    with pytest.raises(ValueError, match='lcg'):
        EnsembleSolver(port_params(jitter=0.01), pairs)
    with pytest.raises(ValueError, match=r'\(R, 2\)'):
        EnsembleSolver(port_params(), pairs[:, :1])
    with pytest.raises(ValueError, match=r'kappas'):
        EnsembleSolver(port_params(), pairs, kappas=[KAPPA])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            EnsembleSolver(port_params(device='cuda'), pairs)
    # the entry point defaults to the card
    assert ctt.Parameters().device == 'cuda'


def test_one_step_from_the_jax_ensemble_state():
    """The JAX ensemble's batched consts and state, carried into the port
    (convert.py), step to the JAX step's next state."""
    pairs = a_pairs()
    j = JaxEnsemble(jax_params(), pairs)
    j.prepare()
    j.solve_or_resume(6)
    jstate = j._states
    jc = {k: np.asarray(v) for k, v in j._consts.items()
          if k not in ('tree', 'rf')}
    consts = convert.members_consts_from_jax(jc)
    state = convert.members_state_from_jax(
        {f: np.asarray(getattr(jstate, f))
         for f in jstate.__dataclass_fields__})
    e = EnsembleSolver(port_params(), pairs)
    for k in ('CHeig', 'A0', 'A1', 'kappa_tilde', 'Seig', 'C'):
        assert torch.equal(consts[k], e._consts[k]), k
    r = int(np.asarray(jstate.rows)[0])
    nxt = tst._members_step(e.cfg, consts, state)
    jrun = jst.make_ensemble_runner(j.cfg)
    # the runner donates (deletes) the state it is given
    jnext = jrun(jstate, jnp.asarray(1, jnp.int32), j._consts, j._null_jbuf)
    np.testing.assert_allclose(nxt.U.numpy(), np.asarray(jnext.U), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(nxt.rowbuf[:, r].numpy(),
                               np.asarray(jnext.rowbuf)[:, r], rtol=1e-12)


# ----------------------------------------------------------------------
# member-batched K1-K4: the plain versions against the Pallas kernels
# (interpret mode) vmapped over the member axis as the JAX ensemble does
# ----------------------------------------------------------------------

@pytest.fixture
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _member_inputs(N, R, npdt, seed):
    rng = np.random.default_rng(seed)
    U = (0.875 + 0.01 * (rng.random((R, N, N)) - 0.5)).astype(npdt)
    pairs = a_pairs([(1.0 + 0.003 * r, 1.0 - 0.002 * r) for r in range(R)])
    return U, pairs[:, 0].copy(), pairs[:, 1].copy()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_member_kernels_ref_match_vmapped_pallas(dtype, interpret_mode):
    import jax
    npdt = np.float32 if dtype == 'float32' else np.float64
    N, R = 64, 3
    p = ct.Parameters()
    p.N = N
    p.kappa_tilde = KAPPA
    from chsimpy_tpu.derived import Derived
    d = Derived.from_params(p)
    U, A0s, A1s = _member_inputs(N, R, npdt, 5)
    tU, tA0, tA1 = torch.from_numpy(U), torch.from_numpy(A0s), \
        torch.from_numpy(A1s)
    f64 = dtype == 'float64'

    mu = K.chemical_potential_members_ref(tU, d.RT, d.BRT, tA0, tA1)
    jmu = jax.vmap(lambda u, a0, a1: pk.chemical_potential(
        u, d.RT, d.BRT, a0, a1))(jnp.asarray(U), jnp.asarray(A0s),
                                 jnp.asarray(A1s))
    if f64:
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    else:
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                                   atol=1e-4)
    for r in range(R):   # member r = the single plain version, to the bit
        assert torch.equal(mu[r], K.chemical_potential_ref(
            tU[r], d.RT, d.BRT, A0s[r], A1s[r]))

    rng = np.random.default_rng(9)
    hE = rng.random((R, N, N)).astype(npdt)
    S = rng.random((N, N)).astype(npdt)
    CH = (1 + rng.random((R, N, N))).astype(npdt)
    up = K.spectral_update_members_ref(tU, torch.from_numpy(hE),
                                       torch.from_numpy(S),
                                       torch.from_numpy(CH))
    jup = jax.vmap(pk.spectral_update, in_axes=(0, 0, None, 0))(
        jnp.asarray(U), jnp.asarray(hE), jnp.asarray(S), jnp.asarray(CH))
    np.testing.assert_allclose(up.numpy(), np.asarray(jup),
                               rtol=1e-12 if f64 else 1e-6)

    kw = dict(delx=d.delx, RT=d.RT, B=p.B, threshold=p.threshold)
    E = mu.numpy()
    sums = K.stats_sums_members_ref(tU, mu, tA0, tA1, **kw)
    jsums = jax.vmap(lambda u, e, a0, a1: pk.stats_band_sums(
        u, e, a0, a1, **kw))(jnp.asarray(U), jnp.asarray(E),
                             jnp.asarray(A0s), jnp.asarray(A1s))
    jsums = np.asarray(jsums)[:, 0, :5].astype(np.float64)
    np.testing.assert_allclose(sums.numpy(), jsums,
                               rtol=1e-12 if f64 else 1e-5)
    assert np.array_equal(sums.numpy()[:, 3], jsums[:, 3])
    mean = (sums[:, 2] / (N * N)).to(tU.dtype)
    ps = K.absdev_sum_members_ref(tU, mean)
    jps = jax.vmap(pk.absdev_band_sums)(jnp.asarray(U),
                                        jnp.asarray(mean.numpy()))
    np.testing.assert_allclose(ps.numpy(),
                               np.asarray(jps)[:, 0, 0].astype(np.float64),
                               rtol=1e-12 if f64 else 1e-5)
    for r in range(R):
        assert torch.equal(sums[r], K.stats_sums_ref(
            tU[r], mu[r], A0s[r], A1s[r], **kw))
        assert torch.equal(ps[r], K.absdev_sum_ref(tU[r], mean[r]))


def test_member_wrappers_take_the_plain_version_on_the_cpu():
    N, R = 16, 2
    U, A0s, A1s = _member_inputs(N, R, np.float64, 3)
    tU, tA0, tA1 = map(torch.from_numpy, (U, A0s, A1s))
    K.reset_launches()
    mu = K.chemical_potential_members(tU, 1.0, 2.0, tA0, tA1)
    assert torch.equal(mu, K.chemical_potential_members_ref(
        tU, 1.0, 2.0, tA0, tA1))
    kw = dict(delx=0.1, RT=1.0, B=1.0, threshold=0.875)
    assert torch.equal(K.stats_sums_members(tU, mu, tA0, tA1, **kw),
                       K.stats_sums_members_ref(tU, mu, tA0, tA1, **kw))
    assert torch.equal(K.spectral_update_members(tU, tU, tU[0], tU + 1),
                       K.spectral_update_members_ref(tU, tU, tU[0], tU + 1))
    m = tU.mean((-2, -1))
    assert torch.equal(K.absdev_sum_members(tU, m),
                       K.absdev_sum_members_ref(tU, m))
    assert set(K.launches.values()) == {0}
    with pytest.raises(ValueError, match=r'\(R, N, N\)'):
        K.chemical_potential_members(tU[0], 1.0, 2.0, tA0, tA1)
    with pytest.raises(ValueError, match='A0s'):
        K.chemical_potential_members(tU, 1.0, 2.0, tA0[:1], tA1)
    with pytest.raises(ValueError, match='Seig'):
        K.spectral_update_members(tU, tU, tU[0, :4], tU)
    with pytest.raises(ValueError, match='mean'):
        K.absdev_sum_members(tU, m.float())


def test_chip_smoke_member_kappas_are_the_sympy_values():
    """The canonical batch's 16 per-member kappas that chip_smoke.py
    carries (the card's machine has no sympy) equal the common-tangent
    solve of each member's (A0, A1)."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(root, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pairs = cs.canonical_pairs()
    assert pairs.shape == (16, 2)
    p = ct.Parameters()
    for (A0, A1), kappa in zip(pairs, cs.CANONICAL_KAPPAS):
        base = jmaterial.get_distance_common_tangent(
            R=p.R, T=p.temp, B=p.B, a0=float(A0), a1=float(A1), at=p.XXX)
        assert base / (0.1602564 * 64) ** 2 == kappa


# ----------------------------------------------------------------------
# the chunks' CUDA graphs: replayed only on the card without jitter or a
# mesh; the replay loop and the solver's capture, with a stand-in graph
# ----------------------------------------------------------------------

def _replay_cases(tmp_path):
    """(name, solver, its chunk's steps) of the runs that launch every
    step: on the CPU, with host jitter, on an ens-only mesh (a world of
    one gloo rank, open while the generator is)."""
    from chsimpy_tpu_torch.parallel.mesh import EnsembleMesh
    pairs = a_pairs()
    yield 'cpu', EnsembleSolver(port_params(), pairs)
    yield 'jitter', EnsembleSolver(port_params(generator='uniform',
                                               jitter=0.01), pairs)
    with _one_rank_world(tmp_path):
        yield 'mesh', EnsembleSolver(port_params(), pairs,
                                     mesh=EnsembleMesh(1, (1, 1), 'cpu'))


def test_the_replay_rule_takes_the_card_without_jitter_or_mesh(
        tmp_path, monkeypatch):
    """``_replays`` is False on the CPU, and with host jitter or a mesh
    also where the fields lay on the card."""
    seen = []
    for name, e in _replay_cases(tmp_path):
        assert not e._replays(), name
        monkeypatch.setattr(e, 'device', torch.device('cuda'))
        assert e._replays() == (name == 'cpu'), name
        seen.append(name)
    assert seen == ['cpu', 'jitter', 'mesh']


def test_runs_that_launch_each_step_make_no_graph(tmp_path, monkeypatch):
    """On the CPU, with host jitter and on an ens-only mesh, a chunk of
    more than STOP_POLL steps builds no ChunkGraph, and a profiler
    session records no ``ch.capture`` or ``ch.replay``."""
    from chsimpy_tpu_torch import ensemble, tracing

    def refused(*args, **kwargs):
        raise AssertionError('a graph was built')
    monkeypatch.setattr(ensemble, 'ChunkGraph', refused)
    for name, e in _replay_cases(tmp_path):
        e.prepare()
        with torch.autograd.profiler.profile(use_kineto=True):
            tracing.reset()
            e.solve_or_resume(tst.STOP_POLL + 6)
        got = tracing.summary()
        tracing.reset()
        assert e._graph is None, name
        assert got['ch.step']['count'] == tst.STOP_POLL + 5, name
        assert not {'ch.capture', 'ch.replay'} & set(got), name


class _EagerBlocks:
    """A stand-in for ChunkGraph on the CPU: a replay runs its STOP_POLL
    steps one by one."""
    made = []

    def __init__(self, cfg, consts, state, members=False):
        assert members
        self.cfg, self.consts, self.step = cfg, consts, tst._members_step
        self.replays = 0
        self.made.append((self, int(state.computed_steps.max())))

    def replay(self, state):
        self.replays += 1
        for _ in range(tst.STOP_POLL):
            state = self.step(self.cfg, self.consts, state)
        return state


@pytest.mark.parametrize('chunk', [100, 128, 64])
def test_replayed_blocks_keep_the_eager_chunks_bits_and_polls(
        monkeypatch, chunk):
    """With a stand-in graph, a batch whose members stop at steps ~160-260
    (N=64): the solver builds one graph, at its first chunk, and its
    chunks replay each whole STOP_POLL steps, poll where the eager loop
    polls and run the rest step by step: the eager batch's rows, stops
    and fields to the bit, and its polls."""
    from chsimpy_tpu_torch import ensemble, tracing
    kw = dict(N=64, ntmax=600, delt=1e-6, XXX=0.875, threshold=0.875,
              generator='uniform', full_sim=False, chunk_size=chunk)
    pairs = np.array([[jmaterial.A0(923.15) * f, jmaterial.A1(923.15) / f]
                      for f in np.linspace(0.995, 1.005, 4)])

    def run():
        e = EnsembleSolver(port_params(**kw), pairs)
        e.prepare()
        with torch.autograd.profiler.profile(use_kineto=True):
            tracing.reset()
            sols = e.solve_or_resume()
        got = tracing.summary()
        tracing.reset()
        return e, sols, got
    e0, eager, got0 = run()
    monkeypatch.setattr(EnsembleSolver, '_replays', lambda self: True)
    monkeypatch.setattr(ensemble, 'ChunkGraph', _EagerBlocks)
    _EagerBlocks.made = []
    e1, replayed, got1 = run()
    assert [m[0] for m in _EagerBlocks.made] == [e1._graph]
    assert _EagerBlocks.made[0][1] == 1
    stops = [s.computed_steps for s in eager]
    assert all(s.stop_reason == 'energy' for s in eager)
    assert min(stops) > 128 and len(set(stops)) > 1
    for a, b in zip(eager, replayed):
        assert (a.computed_steps, a.tau0, a.t0) == \
            (b.computed_steps, b.tau0, b.t0)
        assert np.array_equal(a.timedata.data(), b.timedata.data())
        assert torch.equal(a.U, b.U)
    polls = [got.get('ch.poll', {}).get('count', 0) for got in (got0, got1)]
    assert polls[0] == polls[1] and (polls[0] > 0) == (chunk > 64)
    assert got1['ch.chunk']['count'] == got0['ch.chunk']['count']
    # every whole block of a chunk replayed, the steps it left run one
    # by one: the chunks' step iterations
    iters = got0['ch.step']['count']
    assert e1._graph.replays == iters // chunk * (chunk // tst.STOP_POLL) \
        + (iters % chunk) // tst.STOP_POLL
