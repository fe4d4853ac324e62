"""Adaptive time stepping, per-step jitter and the sobol and simplex
generators of chsimpy_tpu_torch against the JAX package and the reference
goldens, on the CPU (the plain versions of the kernels, K9's included).

Bounds: the goldens with the tolerances of tests/test_golden.py and
tests/test_golden_extra.py (n64_adaptive_600 is chaotic past step ~500,
hence its loose class); the device Sobol jitter bit-equal to the host
stream; generators and Sobol points bit-equal to the JAX package's; the
adaptive delt of one nonlinear term within 2 ulps of JAX's (XLA fuses the
delt_max / sqrt(1 + α·E²) chain, torch rounds each operation); one
adaptive step from a carried JAX state: delt within 5e-14 relative in
float64 (it follows the nonlinear term's rounding) and 1e-5 in float32, U
within 1e-13 / 1e-6; a 2x2 gloo world against one device with
tests/test_combined_features.py's bounds (delt 1e-9, E 1e-10) and the
same rows on every rank."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu import noise as jnoise
from chsimpy_tpu import rng as jrng
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.ops import sobol as jsobol

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import convert, noise, rng
from chsimpy_tpu_torch.__main__ import main
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.core.solver import resolve_jitter_mode
from chsimpy_tpu_torch.core.state import init_state
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.ops import sobol
from chsimpy_tpu_torch.parallel.distributed import spawn_grid
from chsimpy_tpu_torch.parallel.workers import run_tasks
from chsimpy_tpu_torch.timedata import COLUMNS

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706   # the derived kappa_tilde, to the bit
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, 'tests', 'golden')


def load(name):
    with open(os.path.join(GOLDEN_DIR, name + '.json')) as f:
        return json.load(f)


def port_params(**kw):
    p = ctt.Parameters(no_gui=True, update_every=None, device='cpu',
                       kappa_tilde=KAPPA)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def jax_params(**kw):
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    p.kappa_tilde = KAPPA
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def run_golden(name, **extra):
    g = load(name)
    sim = ctt.Simulator(port_params(**g['config'], **extra))
    return g, sim, sim.solve()


# ----------------------------------------------------------------------
# the seven goldens of the slice
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name,route,rtol_E,rtol_delt,rtol_E2', [
    ('n64_sobol_100', 'matmul', 1e-11, 1e-12, 1e-6),
    ('n64_adaptive_400', 'matmul', 1e-11, 1e-11, 1e-6),
    ('n64_adaptive_floor_600', 'matmul', 1e-11, 1e-12, 1e-6),
    ('n64_adaptive_600', 'matmul', 1e-8, 1e-6, 1e-4),
    ('n64_adaptive_600', 'split', 1e-8, 1e-6, 1e-4),
    ('n64_adaptive_600', 'fft', 1e-8, 1e-6, 1e-4),
    # untrimmed forward pairs: the default (3, 5) trim's ~1e-16 rounding,
    # amplified by the chaotic trace, lands 1.6e-7 from the golden in the
    # JAX package too (test_ozaki_trim_on_the_chaotic_trace_as_in_jax)
    ('n64_adaptive_600', 'ozaki', 1e-8, 1e-6, 1e-4),
])
def test_golden_trace(name, route, rtol_E, rtol_delt, rtol_E2):
    extra = {'transform_backend': route}
    if route == 'ozaki':
        extra['ozaki_fwd_pairs'] = (5, 7)
    g, _, sol = run_golden(name, **extra)
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps']
    assert sol.stop_reason == g['stop_reason']
    assert sol.tau0 == g['tau0']
    np.testing.assert_allclose(sol.t0, g['t0'], rtol=rtol_delt)
    np.testing.assert_array_equal(td[:, 0], np.asarray(g['it']))
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=rtol_E)
    np.testing.assert_allclose(td[:, 8], np.asarray(g['delt']),
                               rtol=rtol_delt)
    np.testing.assert_allclose(td[:, 2], np.asarray(g['E2']), rtol=rtol_E2)
    U = sol.U.numpy()
    np.testing.assert_allclose(np.sum(U), g['U_sum'], rtol=1e-12)
    np.testing.assert_allclose(U[:2, :2], np.asarray(g['U_corner']),
                               rtol=1e-5)
    if name == 'n64_adaptive_600':
        assert td[-1, 8] != td[0, 8]        # adapted after step 500


def test_ozaki_trim_on_the_chaotic_trace_as_in_jax():
    """The ozaki route's default (3, 5) forward trim on n64_adaptive_600:
    the port lands where the JAX package does (both ~1.6e-7 from the
    golden in E, outside its 1e-8); their traces agree in E to the
    golden's class, 1e-8, and in delt to 2e-6 (measured 1.007e-6: the
    chaotic tail of two trimmed traces, against the golden's 1e-6 for an
    untrimmed one)."""
    g = load('n64_adaptive_600')
    cfg = dict(g['config'], transform_backend='ozaki')
    tsol = ctt.Simulator(port_params(**cfg)).solve()
    jsol = ct.Simulator(jax_params(**cfg)).solve()
    tt, tj = tsol.timedata.data(), jsol.timedata.data()
    np.testing.assert_allclose(tt[:, 1], tj[:, 1], rtol=1e-8)
    np.testing.assert_allclose(tt[:, 8], tj[:, 8], rtol=2e-6)


@pytest.mark.parametrize('name,rtol_E2,check_corner', [
    ('n64_jitter_100', None, False),
    ('n64_sobol_jitter_100', 1e-4, True),
    ('n64_simplex_jitter_100', None, False),
])
def test_golden_jitter(name, rtol_E2, check_corner):
    """tests/test_golden_extra.py's checks: the host pre-draw consumes the
    stream in the reference's order (simplex: the same slab each step)."""
    g, sim, sol = run_golden(name)
    assert sim.solver.cfg.jitter_mode == ('static' if 'simplex' in name
                                          else 'stream')
    td = sol.timedata.data()
    assert sol.computed_steps == g['computed_steps']
    np.testing.assert_allclose(td[:, 1], np.asarray(g['E']), rtol=1e-11)
    if rtol_E2 is not None:
        np.testing.assert_allclose(td[:, 2], np.asarray(g['E2']),
                                   rtol=rtol_E2)
    U = sol.U.numpy()
    np.testing.assert_allclose(np.sum(U), g['U_sum'], rtol=1e-12)
    if check_corner:
        np.testing.assert_allclose(U[:2, :2], np.asarray(g['U_corner']),
                                   rtol=1e-5)


@pytest.mark.parametrize('chunk', [1024, 7])
def test_device_sobol_is_bit_equal_to_the_host_stream(chunk):
    """--jitter-backend device with -g sobol (K9's plain version): the
    golden, and U and every row bit-equal to the host-stream run, across
    chunk boundaries too."""
    g, _, host = run_golden('n64_sobol_jitter_100', chunk_size=chunk)
    _, sim, dev = run_golden('n64_sobol_jitter_100', chunk_size=chunk,
                             jitter_backend='device')
    assert sim.solver.cfg.jitter_mode == 'device_sobol'
    np.testing.assert_allclose(dev.timedata.data()[:, 1],
                               np.asarray(g['E']), rtol=1e-11)
    assert torch.equal(dev.U, host.U)
    assert np.array_equal(dev.timedata.data(), host.timedata.data())
    # the host engine never advanced: the initial field's N points
    assert sim.solver.generator.sobol_position == 64


def test_device_sobol_resume_continues_the_host_stream():
    """Over two entries (50 + 30 steps) the device Sobol base follows
    computed_steps as the host stream follows its engine: U and every row
    bit-equal."""
    g = load('n64_sobol_jitter_100')
    out = []
    for backend in ('host', 'device'):
        s = ctt.Solver(port_params(**g['config'], jitter_backend=backend))
        s.prepare()
        s.solve_or_resume(50)
        sol = s.solve_or_resume(30)
        out.append((sol.U, sol.timedata.data()))
    assert sol.computed_steps == 80
    assert torch.equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


# ----------------------------------------------------------------------
# generators, stream positions and Sobol points
# ----------------------------------------------------------------------

def test_noise2array_bit_equal_to_jax():
    for n in (16, 64, 101):
        lin = np.linspace(0, 48, n)
        assert np.array_equal(noise.noise2array(lin, lin),
                              jnoise.noise2array(lin, lin))
    assert np.array_equal(noise.build_permutation(7),
                          jnoise.build_permutation(7))


@pytest.mark.parametrize('kind', ['sobol', 'simplex', 'uniform'])
def test_generator_streams_bit_equal_to_jax(kind):
    ours = rng.FieldGenerator(kind, 24, 2023)
    ref = jrng.FieldGenerator(kind, 24, 2023)
    assert np.array_equal(ours.initial_field(0.875),
                          ref.initial_field(0.875))
    for _ in range(3):
        assert np.array_equal(ours.next_sample(), ref.next_sample())


@pytest.mark.parametrize('kind', ['sobol', 'uniform', 'simplex', 'lcg'])
def test_state_dict_round_trips(kind):
    """A stream position saved by either package continues bit-exact in
    the port; the dicts are the same data."""
    ours = rng.FieldGenerator(kind, 16, 11)
    ref = jrng.FieldGenerator(kind, 16, 11)
    ours.initial_field(0.875)
    ref.initial_field(0.875)
    if kind != 'lcg':
        ours.next_sample()
        ref.next_sample()
    assert ours.state_dict() == ref.state_dict()
    for d in (ours.state_dict(), json.loads(json.dumps(ref.state_dict()))):
        back = rng.FieldGenerator.from_state(d)
        want = jrng.FieldGenerator.from_state(d)
        if kind == 'lcg':
            with pytest.raises(ValueError):
                back.next_sample()
            continue
        for _ in range(2):
            assert np.array_equal(back.next_sample(), want.next_sample())


@pytest.mark.parametrize('N', [64, 37])
@pytest.mark.parametrize('where', ['zero', 'deep', 'wrap'])
def test_sobol_points_bit_equal_to_jax(N, where):
    base = {'zero': 0, 'deep': 12345 * N, 'wrap': 2 ** 32 - N // 2}[where]
    sv, sh = sobol.sobol_tables(N, 2023)
    jsv, jsh = jsobol.sobol_tables(N, 2023)
    assert np.array_equal(sv, jsv) and np.array_equal(sh, jsh)
    want = np.asarray(jsobol.sobol_points(
        jnp.asarray(jsv), jnp.asarray(jsh), jnp.asarray(base, jnp.uint32),
        N))
    tsv = torch.tensor(sv.astype(np.int64))
    tsh = torch.tensor(sh.astype(np.int64))
    got = sobol.sobol_points_ref(tsv, tsh, torch.tensor(base), N)
    assert np.array_equal(got.numpy(), want)
    if where == 'zero':
        # and the scipy engine's own stream
        from scipy.stats import qmc
        assert np.array_equal(got.numpy(),
                              qmc.Sobol(d=N, seed=2023).random(N))


def _kernel_walk(sv, shift, base, bn, W, row_off, col_off, rows=32):
    """K9's point walk emulated on the host: a thread forms the first
    point of its strip of ``rows`` rows in full, then steps one row with
    one XOR of sv[j, ctz(n + 1)] (none when ctz >= 30 or n + 1 wraps to
    0).  Returns the (bn, W) uint32 accumulators."""
    m = np.uint64(0xFFFFFFFF)
    out = np.zeros((bn, W), dtype=np.uint32)
    for j in range(W):
        d = col_off + j
        for r0 in range(0, bn, rows):
            n = (np.uint64(base) + np.uint64(row_off + r0)) & m
            g = int(n ^ (n >> np.uint64(1)))
            acc = int(shift[d])
            for k in range(30):
                if (g >> k) & 1:
                    acc ^= int(sv[d, k])
            for r in range(r0, min(r0 + rows, bn)):
                out[r, j] = acc
                n = (n + np.uint64(1)) & m
                if n:
                    k = (int(n) & -int(n)).bit_length() - 1
                    if k < 30:
                        acc ^= int(sv[d, k])
    return out


@pytest.mark.parametrize('base', [0, 5 * 64 + 3, 2 ** 32 - 40])
def test_the_kernels_gray_code_walk_gives_the_points(base):
    """The algorithm K9 runs on the card (one full point a strip, then one
    XOR a row) gives sobol_points_ref's points, across the 2^32 wrap and
    on a block with offsets."""
    N = 48
    sv, sh = sobol.sobol_tables(N, 5)
    tsv = torch.tensor(sv.astype(np.int64))
    tsh = torch.tensor(sh.astype(np.int64))
    for bn, W, r0, c0 in ((N, N, 0, 0), (24, 16, 24, 32), (70, 5, 3, 40)):
        acc = _kernel_walk(sv, sh, base, bn, W, r0, c0, rows=8)
        want = sobol.sobol_points_ref(tsv[c0:c0 + W], tsh[c0:c0 + W],
                                      base + r0, bn)
        assert np.array_equal(acc.astype(np.float64) * 2.0 ** -30,
                              want.numpy())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_sobol_jitter_plain_version(dtype):
    """K9's plain version: the JAX step's U + jitter·(2r − 1) with the JAX
    points, to the bit; a block with offsets is that block of the whole
    field's; the CPU path counts no launch."""
    N, jit = 40, 0.01
    sv, sh = sobol.sobol_tables(N, 2023)
    tsv = torch.tensor(sv.astype(np.int64))
    tsh = torch.tensor(sh.astype(np.int64))
    U0 = 0.875 + 0.01 * np.random.default_rng(0).random((N, N))
    base = 3 * N
    r = jsobol.sobol_points(jnp.asarray(sv), jnp.asarray(sh),
                            jnp.asarray(base, jnp.uint32), N)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jnp.asarray(U0, jdt)
                      + jit * (2.0 * r.astype(jdt) - 1.0))
    K.reset_launches()
    U = torch.tensor(U0, dtype=dtype)
    got = K.sobol_jitter(U, tsv, tsh, torch.tensor(base), jit)
    assert got is U and np.array_equal(got.numpy(), want)
    blk = torch.tensor(U0, dtype=dtype)[8:24, 16:36].contiguous()
    K.sobol_jitter(blk, tsv, tsh, torch.tensor(base), jit, 8, 16)
    assert np.array_equal(blk.numpy(), want[8:24, 16:36])
    assert K.launches['sobol_jitter'] == 0
    with pytest.raises(ValueError, match='does not lie'):
        K.sobol_jitter(blk, tsv, tsh, torch.tensor(base), jit, 0, 30)
    with pytest.raises(TypeError, match='int64'):
        K.sobol_jitter(blk, tsv.int(), tsh, torch.tensor(base), jit)


# ----------------------------------------------------------------------
# one adaptive step against the JAX step
# ----------------------------------------------------------------------

def _jax_adapted_delt(E, delt, delt_max=9e-8, delt_base=3e-8):
    """The `adapted` branch of chsimpy_tpu/core/stepper.py:543-565 (the
    natural layout), on its own."""
    x = delt_max / jnp.sqrt(1.0 + jst.ADAPT_ALPHA * jnp.abs(E) ** 2)
    x = jax.lax.optimization_barrier(x)
    delt_dyn = jnp.min(jnp.sum(x, axis=0)).astype(jnp.float64)
    delt_new = jnp.maximum(delt_base, delt_dyn)
    return jnp.where(delt_new / delt > 1.15, 0.75 * delt + 0.25 * delt_new,
                     delt_new)


@pytest.mark.parametrize('precision', ['float64', 'float32'])
def test_adapted_delt_of_one_field_matches_jax(precision):
    """The same nonlinear term in both: delt within 2 ulps of the field's
    type (XLA fuses 1 + α·E² into a multiply-add and rewrites the division
    by the square root; torch rounds each operation and sums the columns
    in its own order), over fields of several scales, both branches of
    the 1.15 blend and N=32 and 64."""
    dt = np.float64 if precision == 'float64' else np.float32
    jf = jax.jit(_jax_adapted_delt)
    for seed in range(40):
        N = (32, 64)[seed % 2]
        cfg = tst.StepConfig(N=N, dtype=precision, RT=1.0, BRT=1.0, B=1.0,
                             Amr=1.0, L=1.0, delx=1.0, delx2=1.0,
                             M_tilde=1.0, threshold=1.0, adaptive_time=True)
        r = np.random.default_rng(seed)
        E = r.standard_normal((N, N)) * 10 ** r.uniform(-1, 1.5)
        delt = float(r.choice([3e-8, 4e-7]))
        s = init_state(torch.zeros(N, N), torch.zeros(N, N), delt, 0.0,
                       1, seed).replace(computed_steps=torch.tensor(502))
        got = float(tst.adapted_delt(cfg, s, torch.tensor(E.astype(dt))))
        want = float(jf(jnp.asarray(E, dt), jnp.asarray(delt)))
        # 2 ulps of the type (the blend runs in float64 after it)
        assert abs(got / want - 1) <= 2 * np.finfo(dt).eps, (seed, got,
                                                            want)
        # before step 501 and on odd steps: the old delt
        for steps in (500, 503):
            s2 = s.replace(computed_steps=torch.tensor(steps))
            assert float(tst.adapted_delt(
                cfg, s2, torch.tensor(E.astype(dt)))) == delt


@pytest.mark.parametrize('precision', ['float64', 'float32'])
def test_adaptive_steps_from_a_carried_jax_state(precision):
    """Steps 495-530 of an N=32 run: from each JAX state, the port's step
    and the JAX step give the same delt and U.  The nonlinear term differs
    between XLA and torch by ~1e-14 relative where its terms cancel, and
    delt follows it: delt within 5e-14 relative (float32: 1e-5), U within
    1e-13 (1e-6)."""
    jp = jax_params(N=32, generator='lcg', adaptive_time=True,
                    full_sim=True, precision=precision, chunk_size=512)
    js = ct.Solver(jp)
    js.prepare()
    js.solve_or_resume(494)
    state = js._state
    assert int(state.computed_steps) == 494
    jstep = jax.jit(lambda c, s: jst._step(js.cfg, c, s, None))
    tcfg = ctt.Solver(convert.params_from_jax(jp.scalar_dict(),
                                              device='cpu')).cfg
    assert tcfg.adaptive_time and tcfg.delt_max == jp.delt_max
    consts = convert.consts_from_jax(
        {k: np.asarray(js._consts[k]) for k in
         ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1', 'kappa_tilde')})
    f64 = precision == 'float64'
    changed = 0
    for _ in range(36):
        tstate = convert.state_from_jax(
            {k: np.asarray(getattr(state, k)) for k in
             ('U', 'hat_U', 'delt', 'time_delta_sum', 'computed_steps',
              'skip_check', 'stop_reason', 'tau0', 't0', 'E2_first',
              'E2_prev', 'rows', 'rowbuf')})
        tnext = tst._step(tcfg, consts, tstate)
        jnext = jstep(js._consts, state)
        td, jd = float(tnext.delt), float(jnext.delt)
        assert abs(td / jd - 1) <= (5e-14 if f64 else 1e-5), \
            (int(state.computed_steps), td, jd)
        changed += jd != float(state.delt)
        np.testing.assert_allclose(tnext.U.numpy(), np.asarray(jnext.U),
                                   rtol=0, atol=1e-13 if f64 else 1e-6)
        assert int(tnext.computed_steps) == int(jnext.computed_steps)
        state = jnext
    assert changed >= 10        # delt moved on the even steps after 500


def test_default_delt_max_diverges_at_n128_as_in_jax():
    """-a with the default delt_max at N=128: the adapted delt is a column
    sum over N rows, so the first adapted steps take tens of times the
    base delt and the field turns NaN at step 508, in the JAX package and
    in the port alike (ROADMAP.md queue C).  One step a chunk, so the NaN
    guard stops both on the same step with the same rows before it."""
    kw = dict(N=128, ntmax=520, full_sim=True, generator='lcg',
              adaptive_time=True, chunk_size=1)
    out = {}
    for name, solver in (('port', ctt.Solver(port_params(**kw))),
                         ('jax', ct.Solver(jax_params(**kw)))):
        solver.prepare()
        with pytest.raises(FloatingPointError):
            solver.solve_or_resume()
        out[name] = solver.solution
    port, ref = out['port'], out['jax']
    assert port.stop_reason == ref.stop_reason == 'nan'
    assert port.computed_steps == ref.computed_steps == 508
    td, tj = port.timedata.data(), ref.timedata.data()
    assert len(td) == len(tj) == 508
    np.testing.assert_array_equal(td[:, 0], tj[:, 0])
    np.testing.assert_allclose(td[:, 8], tj[:, 8], rtol=1e-9)
    np.testing.assert_allclose(td[:, 1], tj[:, 1], rtol=1e-8)
    assert np.all(tj[:501, 8] == 3e-8) and tj[-1, 8] > 10 * 3e-8


# ----------------------------------------------------------------------
# the 2x2 world (tests/test_combined_features.py's configuration)
# ----------------------------------------------------------------------

WORLD = dict(N=32, full_sim=True, generator='lcg',
             kappa_tilde=2.98911291966116e-4, device='cpu')
WORLD_CASES = {
    'adaptive': dict(WORLD, ntmax=520, adaptive_time=True),
    'stream': dict(WORLD, ntmax=60, generator='uniform', jitter=0.01),
    'device_sobol': dict(WORLD, ntmax=60, generator='sobol', jitter=0.01,
                         jitter_backend='device'),
    # every rank draws the whole field from the same seed, keeps its block
    'device': dict(WORLD, ntmax=60, generator='uniform', jitter=0.01,
                   jitter_backend='device'),
}


@pytest.fixture(scope='module')
def world_2x2():
    tasks = [('solve', dict(params=c)) for c in WORLD_CASES.values()]
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=(tasks,), threads=1, timeout=300)
    return {name: [r[i] for r in res]
            for i, name in enumerate(WORLD_CASES)}


@pytest.mark.parametrize('case', list(WORLD_CASES))
def test_world_matches_one_device(world_2x2, case):
    single = ctt.Simulator(ctt.Parameters(no_gui=True,
                                          **WORLD_CASES[case])).solve()
    ranks = world_2x2[case]
    td, td1 = ranks[0]['timedata'], single.timedata.data()
    assert ranks[0]['computed_steps'] == single.computed_steps
    np.testing.assert_allclose(td[:, 8], td1[:, 8], rtol=1e-9)
    np.testing.assert_allclose(td[:, 1], td1[:, 1], rtol=1e-10)
    np.testing.assert_allclose(ranks[0]['U'], single.U.numpy(), rtol=0,
                               atol=1e-12)
    for r in ranks[1:]:
        assert np.array_equal(r['timedata'], td)
    if case == 'adaptive':
        assert td[-1, 8] != td[0, 8]


# ----------------------------------------------------------------------
# device jitter, scope, CLI, conversion, the bench
# ----------------------------------------------------------------------

JIT = dict(N=16, ntmax=20, full_sim=True, generator='uniform')


def test_device_jitter_reproducible_and_not_reference_exact():
    a = ctt.Simulator(port_params(**JIT, jitter=0.01,
                                  jitter_backend='device'))
    assert a.solver.cfg.jitter_mode == 'device'
    b = ctt.Simulator(port_params(**JIT, jitter=0.01,
                                  jitter_backend='device'))
    host = ctt.Simulator(port_params(**JIT, jitter=0.01)).solve()
    none = ctt.Simulator(port_params(**JIT)).solve()
    ua, ub = a.solve().U, b.solve().U
    assert torch.equal(ua, ub)              # same seed, same stream
    assert not torch.allclose(ua, none.U)
    assert not torch.equal(ua, host.U)


def test_device_jitter_restarts_from_the_seed_at_prepare():
    """Two prepare+solve cycles of one Solver give the same rows and
    field, as in the JAX package, whose prepare() resets the key.  Only
    domtime moves on: prepare() keeps time_delta_sum (the reference's
    quirk) in both."""
    runs = {}
    for name, solver in (
            ('port', ctt.Solver(port_params(**JIT, jitter=0.01,
                                            jitter_backend='device'))),
            ('jax', ct.Solver(jax_params(**JIT, jitter=0.01,
                                         jitter_backend='device')))):
        assert solver.cfg.jitter_mode == 'device'
        runs[name] = []
        for _ in range(2):
            solver.prepare()
            sol = solver.solve_or_resume()
            runs[name].append((sol.timedata.data().copy(),
                               np.array(sol.U, copy=True)))
    keep = [i for i, c in enumerate(COLUMNS) if c != 'domtime']
    for (td_a, U_a), (td_b, U_b) in runs.values():
        np.testing.assert_array_equal(td_a[:, keep], td_b[:, keep])
        np.testing.assert_array_equal(U_a, U_b)


@pytest.mark.parametrize('jitter', [0.5, 0.0, -0.01])
def test_jitter_out_of_range_ignored(jitter):
    pj = port_params(**JIT, jitter=jitter)
    assert resolve_jitter_mode(pj) == 'none'
    assert torch.equal(ctt.Simulator(pj).solve().U,
                       ctt.Simulator(port_params(**JIT)).solve().U)


def test_jitter_modes_resolve_as_in_jax():
    for gen, backend, mode in (('uniform', 'host', 'stream'),
                               ('uniform', 'device', 'device'),
                               ('sobol', 'host', 'stream'),
                               ('sobol', 'device', 'device_sobol'),
                               ('simplex', 'device', 'static')):
        p = port_params(N=16, generator=gen, jitter=0.01,
                        jitter_backend=backend)
        jp = jax_params(N=16, generator=gen, jitter=0.01,
                        jitter_backend=backend)
        assert resolve_jitter_mode(p) == mode
        assert ct.Solver(jp).cfg.jitter_mode == mode
    with pytest.raises(ValueError, match="'lcg' generator has none"):
        ctt.Solver(port_params(N=16, generator='lcg', jitter=0.01))
    # the 64 MB pre-draw cap shrinks the stream chunk at large N
    p = port_params(N=2048, generator='uniform', jitter=0.01)
    assert resolve_jitter_mode(p) == 'stream'
    assert (64 << 20) // (2048 * 2048 * 8) == 2


def test_cli_drives(capsys):
    base = ['-N', '16', '-n', '12', '-z', '--no-gui', '-K', str(KAPPA),
            '--device', 'cpu']
    main(base + ['-a'])
    out = capsys.readouterr().out
    assert 'computed_steps = 12' in out and "'adaptive_time': True" in out
    main(base + ['-j', '0.01', '-g', 'sobol', '--jitter-backend', 'device'])
    out = capsys.readouterr().out
    assert 'computed_steps = 12' in out and "'jitter_backend': 'device'" \
        in out
    main(base + ['-g', 'simplex', '-j', '0.01'])
    assert 'computed_steps = 12' in capsys.readouterr().out
    with pytest.raises(ValueError, match='lcg'):
        main(base + ['-g', 'lcg', '-j', '0.01'])


def test_params_carried_from_jax_with_the_slice():
    d = ct.Parameters().scalar_dict()
    d.update(adaptive_time=True, jitter=0.01, jitter_backend='device',
             generator='sobol')
    p = convert.params_from_jax(d, device='cpu')
    assert (p.adaptive_time, p.jitter, p.jitter_backend, p.generator) == \
        (True, 0.01, 'device', 'sobol')
    d['generator'] = 'simplex'
    assert convert.params_from_jax(d, device='cpu').generator == 'simplex'


def test_generator_state_from_jax_continues_bit_exact():
    ref = jrng.FieldGenerator('sobol', 32, 2023)
    ref.initial_field(0.875)
    ref.next_sample()
    ours = rng.FieldGenerator.from_state(ref.state_dict())
    for _ in range(3):
        assert np.array_equal(ours.next_sample(), ref.next_sample())


def test_sobol_consts_carried_from_jax():
    """The JAX solver's device_sobol tables and base (set at solve entry)
    become the port's int64 consts, equal to what the port's solver
    builds."""
    cfg = dict(N=16, ntmax=3, full_sim=True, generator='sobol',
               jitter=0.01, jitter_backend='device')
    js = ct.Solver(jax_params(**cfg))
    js.prepare()
    js.solve_or_resume(3)
    carried = convert.consts_from_jax(
        {k: np.asarray(v) for k, v in js._consts.items()
         if k in ('C', 'leig', 'CHeig', 'Seig', 'eaxis', 'A0', 'A1',
                  'kappa_tilde', 'sobol_sv', 'sobol_shift', 'sobol_base')})
    ts = ctt.Solver(port_params(**cfg))
    ts.prepare()
    ts.solve_or_resume(3)
    for k in ('sobol_sv', 'sobol_shift', 'sobol_base'):
        assert carried[k].dtype == torch.int64
        assert torch.equal(carried[k], ts._consts[k]), k
    assert int(carried['sobol_base']) == 16


def test_bench_writes_the_jax_schema(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, '-m', 'chsimpy_tpu_torch.benchmarks.bench', '-N',
         '32', '-n', '20', '-R', '1', '-w', '0', '--device', 'cpu', '-K',
         str(KAPPA), '-f', 'b1'], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / 'b1.bench.json') as f:
        art = json.load(f)
    assert set(art) == {'schema', 'file_id', 'options', 'config', 'host',
                        'devices', 'warmup', 'reps', 'steps_per_s'}
    assert art['schema'] == 'chsimpy-tpu-bench-v1'
    assert {'N', 'ntmax', 'precision', 'generator', 'seed', 'adaptive_time',
            'kernel_backend', 'transform_backend', 'matmul_precision',
            'chunk_size', 'mesh_shape'} <= set(art['config'])
    assert art['reps'][0]['steps'] == 19
    assert art['devices'][0] == 'device, cpu'
    assert not (tmp_path / 'BENCHMARK.json').exists()
