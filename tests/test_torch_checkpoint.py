"""Checkpoints of the port (chsimpy_tpu_torch/checkpoint.py) and of the JAX
package, crossing between the packages both ways, on the CPU.

A resume recomputes the spectral image from U at the solve entry (the
reference's entry semantics), so a restored run is, to the bit, the run of
the restoring package that re-entered ``solve_or_resume`` at the saved
step.  A file written by the other package carries that package's first
part of the trajectory, so the restored run is held to 1e-12 relative of
the restoring package's own run there (two float64 matmul orders); the
restoring package's own file to the bit."""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import checkpoint as jck
from chsimpy_tpu import material as jmaterial
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import checkpoint as tck
from chsimpy_tpu_torch.ensemble import EnsembleSolver

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4
BASE = dict(N=32, ntmax=60, full_sim=True, generator='uniform',
            kappa_tilde=KAPPA, chunk_size=16)
MODES = {'plain': dict(), 'stream_jitter': dict(jitter=0.01),
         'adaptive': dict(adaptive_time=True, delt=1e-6, delt_max=2e-6),
         'sobol_device_jitter': dict(generator='sobol', jitter=0.01,
                                     jitter_backend='device'),
         'device_jitter': dict(jitter=0.01, jitter_backend='device')}


def jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in dict(BASE, **kw).items():
        setattr(p, k, v)
    return p


def port_params(**kw):
    p = ctt.Parameters(no_gui=True, update_every=None, device='cpu')
    for k, v in dict(BASE, **kw).items():
        setattr(p, k, v)
    return p


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


def port_reentry(kw, first=30, then=30):
    """Rows and U of the port's run that re-enters at step ``first``."""
    sim = ctt.Simulator(port_params(ntmax=first, **kw))
    sim.solve()
    sol = sim.solver.solve_or_resume(then)
    return sol.timedata.data(), sol.U.numpy()


def jax_reentry(kw, first=30, then=30):
    sim = ct.Simulator(jax_params(ntmax=first, **kw))
    sim.solve()
    sol = sim.solver.solve_or_resume(then)
    return sol.timedata.data(), np.asarray(sol.U)


@pytest.mark.parametrize('seed', [0, 2023, -5, 2 ** 40 + 7])
def test_rng_key_is_jax_prng_key(seed):
    assert np.array_equal(tck.jax_prng_key(seed),
                          np.asarray(jax.random.PRNGKey(seed)))
    assert tck.jax_prng_key(seed).dtype == np.uint32


@pytest.mark.parametrize('mode', sorted(MODES))
def test_port_checkpoint_resumes_to_the_bit(mode, tmp_path):
    kw = MODES[mode]
    f = str(tmp_path / 'run.ckpt')
    ctt.Simulator(port_params(ntmax=30, checkpoint_file=f, **kw)).solve()
    assert os.path.exists(f)      # no '.npz' appended
    sim = ctt.Simulator(port_params(restore_file=f, ntmax=30, **kw))
    sol = sim.solve()
    rows, U = port_reentry(kw)
    assert np.array_equal(sol.timedata.data(), rows)
    assert np.array_equal(sol.U.numpy(), U)
    assert sol.computed_steps == 60


@pytest.mark.parametrize('mode', ['plain', 'stream_jitter', 'adaptive'])
def test_checkpoints_cross_packages(mode, tmp_path):
    kw = MODES[mode]
    # port -> JAX
    f = str(tmp_path / 'port.npz')
    ctt.Simulator(port_params(ntmax=30, checkpoint_file=f, **kw)).solve()
    z = np.load(f)
    assert np.array_equal(z['rng_key'], np.asarray(jax.random.PRNGKey(2023)))
    js = jck.restore_solver(f)
    jrows = js.solve_or_resume(30).timedata.data()
    rows, _ = jax_reentry(kw)
    np.testing.assert_allclose(jrows, rows, rtol=1e-12, atol=1e-300)
    # JAX -> port
    g = str(tmp_path / 'jax.npz')
    ct.Simulator(jax_params(ntmax=30, checkpoint_file=g, **kw)).solve()
    sol = ctt.Simulator(port_params(restore_file=g, ntmax=30, **kw)).solve()
    rows, U = port_reentry(kw)
    assert sol.computed_steps == 60
    np.testing.assert_allclose(sol.timedata.data(), rows, rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(sol.U.numpy(), U, rtol=0, atol=1e-12)


def _key(solver):
    return np.asarray(solver._state.rng_key).astype(np.int64)


def test_device_jitter_stream_crosses_packages(tmp_path):
    """The device jitter's threefry key rides in rng_key: a file of either
    package continues the same stream in the other.  The restored run's
    key ends where the restoring package's uninterrupted run's does, to
    the bit, and its rows hold that run's to 1e-12 (a stream that differed
    would move them by ~1e-3)."""
    kw = dict(jitter=0.01, jitter_backend='device')
    # port -> JAX
    f = str(tmp_path / 'port.npz')
    sim = ctt.Simulator(port_params(ntmax=30, checkpoint_file=f, **kw))
    sim.solve()
    z = np.load(f)
    assert tck.TORCH_GENERATOR_KEY not in z.files
    assert np.array_equal(z['rng_key'].astype(np.int64), _key(sim.solver))
    js = jck.restore_solver(f)
    jrows = js.solve_or_resume(30).timedata.data()
    ref = ct.Simulator(jax_params(ntmax=30, **kw))
    ref.solve()
    rows = ref.solver.solve_or_resume(30).timedata.data()
    assert np.array_equal(_key(js), _key(ref.solver))
    np.testing.assert_allclose(jrows, rows, rtol=1e-12, atol=1e-300)
    # JAX -> port
    g = str(tmp_path / 'jax.npz')
    ct.Simulator(jax_params(ntmax=30, checkpoint_file=g, **kw)).solve()
    back = ctt.Simulator(port_params(restore_file=g, ntmax=30, **kw))
    sol = back.solve()
    ref = ctt.Simulator(port_params(ntmax=30, **kw))
    ref.solve()
    rows = ref.solver.solve_or_resume(30).timedata.data()
    assert sol.computed_steps == 60
    assert np.array_equal(_key(back.solver), _key(ref.solver))
    np.testing.assert_allclose(sol.timedata.data(), rows, rtol=1e-12,
                               atol=1e-300)


def test_torch_generator_checkpoint_is_refused(tmp_path):
    """A file of the port's former device jitter (a torch.Generator state
    under 'torch_jitter_generator') cannot continue its stream: refused,
    single and ensemble."""
    kw = dict(jitter=0.01, jitter_backend='device')
    f = str(tmp_path / 'old.npz')
    ctt.Simulator(port_params(ntmax=10, checkpoint_file=f, **kw)).solve()
    arrays = dict(np.load(f))
    arrays[tck.TORCH_GENERATOR_KEY] = np.zeros(16, dtype=np.uint8)
    np.savez(f, **arrays)
    with pytest.raises(ValueError, match='stream has changed'):
        tck.restore_solver(f, device='cpu')
    with pytest.raises(ValueError, match='stream has changed'):
        tck.restore_ensemble(f, device='cpu')


def test_header_modes_are_validated(tmp_path):
    f = str(tmp_path / 'c.npz')
    ct.Simulator(jax_params(ntmax=5, kernel_backend='pallas',
                            checkpoint_file=f)).solve()
    s = tck.restore_solver(f, device='cpu')
    assert s.params.kernel_backend == 'xla' and s.params.device == 'cpu'
    assert s.solution.computed_steps == 5
    z = dict(np.load(f))
    h = json.loads(bytes(z['header']).decode())
    h['params']['kernel_backend'] = 'pallas-fused'
    z['header'] = np.frombuffer(json.dumps(h).encode(), dtype=np.uint8)
    g = str(tmp_path / 'fused.npz')
    np.savez(g, **z)
    with pytest.raises(ValueError, match='pallas-fused'):
        tck.restore_solver(g, device='cpu')
    h['format_version'] = 1
    z['header'] = np.frombuffer(json.dumps(h).encode(), dtype=np.uint8)
    np.savez(g, **z)
    with pytest.raises(ValueError, match='version'):
        tck.restore_solver(g, device='cpu')


def test_checkpoint_every_survives_reentry(tmp_path, monkeypatch):
    saves = []
    real = tck.save_checkpoint

    def spy(fname, solver):
        saves.append(solver.solution.computed_steps)
        real(fname, solver)
    monkeypatch.setattr(tck, 'save_checkpoint', spy)
    f = str(tmp_path / 'c.npz')
    s = ctt.Solver(port_params(chunk_size=8, checkpoint_file=f,
                               checkpoint_every=20))
    s.prepare()
    for _ in range(6):
        s.solve_or_resume(8)
    # chunk boundaries at 8, 16, ...: saves once 20 steps have passed
    # since the last, across the six entries
    assert saves == [24, 48]
    restored = tck.restore_solver(f, device='cpu')
    assert restored.solution.computed_steps == 48


def _pairs():
    A0 = jmaterial.A0(923.15)
    A1 = jmaterial.A1(923.15)
    return np.array([[A0 * f0, A1 * f1]
                     for f0, f1 in ((1.0, 1.0), (1.004, 0.997),
                                    (0.995, 1.005))])


def _port_ens(kw, pairs, kappas=None):
    e = EnsembleSolver(port_params(**kw), pairs, kappas=kappas)
    e.prepare()
    e.solve_or_resume(30)
    return e


def test_ensemble_checkpoint_keeps_member_kappas(tmp_path):
    """The restore takes each member's kappa from the file (the JAX
    package re-derives them from the parameters, which with a pinned
    kappa_tilde gives every member the pinned value: ROADMAP.md queue
    C)."""
    pairs = _pairs()
    kappas = KAPPA * np.array([1.0, 1.01, 0.99])
    ref = [s.timedata.data()
           for s in _port_ens({}, pairs, kappas).solve_or_resume(30)]
    f = str(tmp_path / 'port.npz')
    tck.save_ensemble_checkpoint(f, _port_ens({}, pairs, kappas),
                                 extra_header={'done': 3})
    r = tck.restore_ensemble(f, device='cpu')
    assert r._ckpt_extra == {'done': 3}
    assert np.array_equal(r.kappas, kappas)
    out = [s.timedata.data() for s in r.solve_or_resume(30)]
    assert all(np.array_equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize('mode', ['plain', 'stream_jitter'])
def test_ensemble_checkpoints_cross_packages(mode, tmp_path):
    kw = MODES[mode]
    pairs = _pairs()

    def jax_ens():
        j = JaxEnsemble(jax_params(**kw), pairs)
        j.prepare()
        j.solve_or_resume(30)
        return j

    ref = [s.timedata.data()
           for s in _port_ens(kw, pairs).solve_or_resume(30)]
    jref = [s.timedata.data() for s in jax_ens().solve_or_resume(30)]
    f = str(tmp_path / 'port.npz')
    tck.save_ensemble_checkpoint(f, _port_ens(kw, pairs))
    out = [s.timedata.data()
           for s in tck.restore_ensemble(f, device='cpu').solve_or_resume(30)]
    assert all(np.array_equal(a, b) for a, b in zip(out, ref))
    out = [s.timedata.data()
           for s in jck.restore_ensemble(f).solve_or_resume(30)]
    for a, b in zip(out, jref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)
    g = str(tmp_path / 'jax.npz')
    jck.save_ensemble_checkpoint(g, jax_ens())
    out = [s.timedata.data()
           for s in tck.restore_ensemble(g, device='cpu').solve_or_resume(30)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)
    single = str(tmp_path / 'single.npz')
    ctt.Simulator(port_params(ntmax=3, checkpoint_file=single)).solve()
    with pytest.raises(ValueError, match='not an ensemble'):
        tck.restore_ensemble(single, device='cpu')
    # onto a mesh (a world of one rank): the same bits
    from chsimpy_tpu_torch.parallel.mesh import EnsembleMesh
    with _one_rank_world(tmp_path):
        r = tck.restore_ensemble(f, mesh=EnsembleMesh(1, (1, 1), 'cpu'),
                                 device='cpu')
        out = [s.timedata.data() for s in r.solve_or_resume(30)]
    assert all(np.array_equal(a, b) for a, b in zip(out, ref))


def test_cli_checkpoint_and_restore(tmp_path, capsys, monkeypatch):
    from chsimpy_tpu_torch.__main__ import main
    monkeypatch.chdir(tmp_path)
    common = ['-N', '16', '--no-gui', '-g', 'lcg', '-K', str(KAPPA),
              '-z', '--device', 'cpu', '--chunk-size', '8']
    main(common + ['-n', '20', '--checkpoint-file', 'c.npz',
                   '--checkpoint-every', '10'])
    main(['--no-gui', '--restore', 'c.npz', '-n', '10', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'computed_steps = 30' in out
    s = ctt.Solver(port_params(N=16, generator='lcg', chunk_size=8))
    s.prepare()
    s.solve_or_resume(20)
    rows = s.solve_or_resume(10).timedata.data()
    r = tck.restore_solver('c.npz', device='cpu')
    assert r.solution.computed_steps == 20
    # the restored run of the CLI, replayed in memory
    assert np.array_equal(r.solve_or_resume(10).timedata.data(), rows)
