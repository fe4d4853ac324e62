"""The ``device`` jitter of chsimpy_tpu_torch (kernel K10's plain version,
``ops/kernels.py`` ``threefry_*``) against the JAX package's
``jax.random`` threefry stream, on the CPU.

Bounds: split and uniform bit-equal to ``jax.random`` (the JAX 0.9
defaults, ``jax_threefry_partitionable``); a ``-j 0.01 --jitter-backend
device`` run draws the JAX stream to the bit (its rows and U equal the
port's run fed the JAX package's draws, and its key ends where the JAX
run's does) and holds the JAX package's run to 1e-12 relative in float64
(the two packages' float64 matmuls sum in other orders, as in every
cross-package run test) and E to 1e-5 in float32; a 2x2 gloo world
draws each block of one device's field to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch.core.state import jax_prng_key
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.parallel.distributed import spawn_grid
from chsimpy_tpu_torch.parallel.workers import run_tasks

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4
SEEDS = (0, 2023, 2 ** 31 + 5)
NS = (1, 7, 64, 129)
DTYPES = {'float32': (jnp.float32, torch.float32),
          'float64': (jnp.float64, torch.float64)}
BASE = dict(N=32, ntmax=60, full_sim=True, kappa_tilde=KAPPA, jitter=0.01)


def key_of(seed):
    return torch.as_tensor(jax_prng_key(seed).astype(np.int64))


def jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def port_params(**kw):
    return ctt.Parameters(no_gui=True, update_every=None, device='cpu', **kw)


def jax_draws(seed, steps, N, dtype):
    """The JAX step's draws: ``key, sub = split(key)``, ``uniform(sub)``,
    ``steps`` times from PRNGKey(seed); and the last key."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (N, N),
                                                 DTYPES[dtype][0])))
    return np.stack(out), np.asarray(key)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('seed', SEEDS)
def test_split_and_uniform_equal_jax_random(seed, dtype):
    jdt, tdt = DTYPES[dtype]
    key, tkey = jax.random.PRNGKey(seed), key_of(seed)
    assert np.array_equal(np.asarray(key).astype(np.int64), tkey.numpy())
    for _ in range(3):
        key, sub = jax.random.split(key)
        tkey, tsub = K.threefry_split_ref(tkey)
        assert np.array_equal(np.asarray(key).astype(np.int64), tkey.numpy())
        assert np.array_equal(np.asarray(sub).astype(np.int64), tsub.numpy())
        for N in NS:
            want = np.asarray(jax.random.uniform(sub, (N, N), jdt))
            got = K.threefry_uniform_ref(tsub, N, tdt).numpy()
            assert got.dtype == want.dtype
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        # a block of the draw hashes its own counters: the field's block
        blk = K.threefry_uniform_ref(tsub, 129, tdt, 64, 65, 30, 40).numpy()
        assert np.array_equal(blk, want[64:94, 65:105])


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_threefry_jitter_plain_version(dtype):
    """One step of the mode: U += jitter·(2r − 1) with r from the subkey,
    the next key into another buffer, the key kept where go is false."""
    jdt, tdt = DTYPES[dtype]
    N, jit = 33, 0.01
    U0 = torch.tensor(0.875 + 0.01 * np.random.default_rng(3).random(
        (N, N)), dtype=tdt)
    k = key_of(2023)
    out = torch.empty_like(k)
    U = K.threefry_jitter(U0.clone(), k, out, jit, N)
    key, sub = jax.random.split(jax.random.PRNGKey(2023))
    r = jax.random.uniform(sub, (N, N), jdt)
    want = np.asarray(jnp.asarray(U0.numpy()) + jit * (2.0 * r - 1.0))
    assert np.array_equal(U.numpy(), want)
    assert np.array_equal(out.numpy(), np.asarray(key).astype(np.int64))
    kept = torch.empty_like(k)
    blk = K.threefry_jitter(U0[5:20, 7:30].clone(), k, kept, jit, N, 5, 7,
                            go=torch.tensor(False))
    assert np.array_equal(blk.numpy(), want[5:20, 7:30])
    assert torch.equal(kept, k)
    assert set(K.launches.values()) == {0}       # the CPU path counts none
    with pytest.raises(ValueError, match='another buffer'):
        K.threefry_jitter(U0.clone(), k, k, jit, N)
    with pytest.raises(ValueError, match='does not lie'):
        K.threefry_jitter(U0.clone(), k, out, jit, N, 1, 0)
    with pytest.raises(ValueError, match='int64'):
        K.threefry_jitter(U0.clone(), k.int(), out, jit, N)


class _JaxDraws:
    """A port Solver's ``stream`` jitter fed the JAX package's draws."""

    def __init__(self, slabs):
        self.slabs, self.i = torch.as_tensor(slabs), 0

    def __call__(self, k):
        out = self.slabs[self.i:self.i + k]
        self.i += k
        return out


@pytest.mark.parametrize('precision', ['float64', 'float32'])
def test_device_run_draws_the_jax_stream(precision):
    """-j 0.01 --jitter-backend device, N=32, 60 steps, uniform: the
    port's rows and U equal, to the bit, its run on the JAX package's
    draws; the key ends as the JAX run's; the JAX run's rows within 1e-12
    (float64), or E within the float32 class (1e-5)."""
    kw = dict(BASE, generator='uniform', precision=precision)
    sim = ctt.Simulator(port_params(jitter_backend='device', **kw))
    assert sim.solver.cfg.jitter_mode == 'device'
    sol = sim.solve()
    fed = ctt.Solver(port_params(**kw))
    assert fed.cfg.jitter_mode == 'stream'
    slabs, last_key = jax_draws(2023, 59, 32, precision)
    fed._draw_jitter_buf = _JaxDraws(slabs)
    fed.prepare()
    ref = fed.solve_or_resume()
    assert np.array_equal(sol.timedata.data(), ref.timedata.data())
    assert torch.equal(sol.U, ref.U)
    jsim = ct.Simulator(jax_params(jitter_backend='device', **kw))
    jsol = jsim.solve()
    assert np.array_equal(sim.solver._state.rng_key.numpy(),
                          last_key.astype(np.int64))
    assert np.array_equal(np.asarray(jsim.solver._state.rng_key), last_key)
    td, jtd = sol.timedata.data(), jsol.timedata.data()
    if precision == 'float64':
        np.testing.assert_allclose(td, jtd, rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U),
                                   rtol=0, atol=1e-12)
    else:   # tests/test_torch_solver.py's float32 class
        np.testing.assert_allclose(td[:, 1], jtd[:, 1], rtol=1e-5)
        np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U),
                                   rtol=0, atol=1e-5)


def test_device_sobol_run_matches_jax():
    """The sobol generator with the device backend (K9's mode): the JAX
    package's run to 1e-12; its key untouched in both."""
    kw = dict(BASE, generator='sobol', jitter_backend='device')
    sim = ctt.Simulator(port_params(**kw))
    assert sim.solver.cfg.jitter_mode == 'device_sobol'
    sol = sim.solve()
    jsim = ct.Simulator(jax_params(**kw))
    jsol = jsim.solve()
    np.testing.assert_allclose(sol.timedata.data(), jsol.timedata.data(),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=1e-12)
    assert np.array_equal(sim.solver._state.rng_key.numpy(),
                          jax_prng_key(2023).astype(np.int64))


@pytest.mark.parametrize('chunk', [1024, 7])
def test_the_stream_stops_where_the_jax_loop_exits(chunk):
    """An energy stop mid-chunk: the steps after it are thrown away and
    draw nothing, so the key is the JAX run's, which exits its loop
    there."""
    kw = dict(N=32, ntmax=100, delt=1.4e-5, generator='uniform',
              kappa_tilde=KAPPA, jitter=0.01, jitter_backend='device')
    sim = ctt.Simulator(port_params(chunk_size=chunk, **kw))
    sol = sim.solve()
    jsim = ct.Simulator(jax_params(**kw))
    jsol = jsim.solve()
    assert sol.stop_reason == jsol.stop_reason == 'energy'
    assert sol.computed_steps == jsol.computed_steps < 100
    assert np.array_equal(sim.solver._state.rng_key.numpy(),
                          np.asarray(jsim.solver._state.rng_key))
    np.testing.assert_allclose(sol.timedata.data(), jsol.timedata.data(),
                               rtol=1e-12, atol=1e-300)


def test_world_blocks_are_one_devices_draw():
    """A 2x2 gloo world: each rank draws its block of the field (its own
    counters), gathered = one device's draw, to the bit, in both types;
    every rank's next key the same."""
    N = 32
    rng = np.random.default_rng(5)
    U = 0.875 + 0.01 * rng.random((N, N))
    key = jax_prng_key(2 ** 31 + 5)
    tasks = [('threefry_jitter', dict(U=U, key=key, jitter=0.01,
                                      dtype=d)) for d in DTYPES]
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=(tasks,), threads=1, timeout=300)
    for i, dtype in enumerate(DTYPES):
        tdt = DTYPES[dtype][1]
        want = torch.tensor(U, dtype=tdt)
        nxt = torch.empty(2, dtype=torch.int64)
        K.threefry_jitter(want, key_of(2 ** 31 + 5), nxt, 0.01, N)
        for r in res:
            field, k = r[i]
            assert np.array_equal(field, want.numpy())
            assert np.array_equal(k, nxt.numpy())
