"""The statistics kernel's body and K11 folded into K4_members' second pass
(chsimpy_tpu_torch): on the CPU, the fused K4 + Ra wrapper against the
plain K4_members and K11 to the bit, the members' step taking one fused
pass and no K11 of its own, the division by the constants h and 2h
(``cdiv`` in ``csrc/ch_kernels.cu``) emulated in exact rational arithmetic
against the correctly rounded quotient, and the statistics' plain versions
against the JAX package.  The card's side (the body against the parent
body to the bit, the fused pass against K4 + K11, cdiv over every finite
float32) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import math
import random
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core import stepper as jst
from chsimpy_tpu.derived import Derived as JDerived
from chsimpy_tpu.ops import pallas_kernels as pk

from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ops import dct as dct_ops
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _members(R, N, dtype, seed):
    rng = np.random.default_rng(seed)
    U = torch.tensor(0.875 + 0.01 * (rng.random((R, N, N)) - 0.5),
                     dtype=dtype)
    return U, (U.double().sum((1, 2)) / (N * N)).to(dtype)


# ----------------------------------------------------------------------
# K4_members with each member's Ra in its second pass
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('R', [1, 3, 16])
@pytest.mark.parametrize('row', ['natural', 'folded', 'sharded'])
def test_fused_pass_is_k4_members_and_k11_to_the_bit(R, dtype, row):
    """(PS sums, Ra) of absdev_ra_members on the CPU = absdev_sum_members
    and row_absdev_members, bit for bit: the natural mid row of the
    fields, the folded fields' mid row unfolded (the step's _mid_row
    under fold_field) and a grid run's gathered mid row (R, 1, N)."""
    N = 34
    U, mean = _members(R, N, dtype, 100 + R)
    if row == 'natural':
        rows, r = U, N // 2 + 1
    elif row == 'folded':
        F = dct_ops.fold1(U)
        rows, r = dct_ops.fold_cols(F[..., N - 2, :]).unsqueeze(1), 0
        assert torch.equal(rows[:, 0], U[:, N // 2 + 1])
    else:
        rows = U[:, N // 2 + 1].reshape(R, 2, N // 2).reshape(R, 1, N)
        rows, r = rows.contiguous(), 0
    K.reset_launches()
    ps, ra = K.absdev_ra_members(U, mean, rows, r)
    assert ps.dtype == ra.dtype == torch.float64
    assert torch.equal(ps, K.absdev_sum_members_ref(U, mean))
    assert torch.equal(ra, K.row_absdev_members_ref(rows, r))
    assert torch.equal(ra, K.row_absdev_members(rows, r))
    assert set(K.launches.values()) == {0}     # the CPU path counts none


def test_fused_pass_checks_its_rows():
    U, mean = _members(3, 16, torch.float64, 7)
    with pytest.raises(ValueError, match='rows hold 2 members'):
        K.absdev_ra_members(U, mean, U[:2], 9)
    with pytest.raises(ValueError, match=r'row 16 is not in \[0, 16\)'):
        K.absdev_ra_members(U, mean, U, 16)
    with pytest.raises(TypeError):
        K.absdev_ra_members(U, mean, U.float(), 9)


class _Spy:
    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(K, name)

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(K, name, spy)


@pytest.mark.parametrize('fold', [False, True])
def test_members_step_takes_one_fused_pass_and_no_k11(monkeypatch, fold):
    """Each members step calls the fused K4 + Ra pass once and K11 (and
    K4_members without Ra) never; the step's Ra and PS are those of the
    plain K11 and K4_members."""
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    fused = _Spy(monkeypatch, 'absdev_ra_members')
    k11 = _Spy(monkeypatch, 'row_absdev_members')
    k4 = _Spy(monkeypatch, 'absdev_sum_members')
    kw = dict(N=32, device='cpu', kappa_tilde=KAPPA, precision='float32',
              transform_backend='split', fold_field=fold, ntmax=6,
              full_sim=True, generator='lcg')
    p = Parameters(**kw)
    A0, A1 = p.func_A0(p.temp), p.func_A1(p.temp)
    pairs = np.array([[A0, A1], [1.004 * A0, 0.997 * A1]])
    ens = EnsembleSolver(p, pairs)
    ens.prepare()
    assert fused.calls == 1                     # the prepare row
    sols = ens.solve_or_resume(6)               # 5 step iterations
    assert fused.calls == 1 + 5 and k11.calls == 0 and k4.calls == 0
    assert all(s.computed_steps == 6 for s in sols)


def test_members_stats_are_k4_and_k11_of_the_members():
    """_members_stats' PS and Ra = K4_members' sums over N^2 and K11's
    Ra of row N/2+1, to the bit (natural and folded layouts)."""
    N, R = 32, 3
    cfg = tst.StepConfig(N=N, dtype='float64', RT=1.0, BRT=0.5, B=0.3,
                         Amr=1.0, L=2.0, delx=2.0 / (N - 1),
                         delx2=(2.0 / (N - 1)) ** 2, M_tilde=1.0,
                         threshold=0.875)
    U, _ = _members(R, N, torch.float64, 3)
    consts = {'A0': torch.full((R,), 2.0, dtype=torch.float64),
              'A1': torch.full((R,), 0.5, dtype=torch.float64),
              'kappa_tilde': torch.full((R,), KAPPA, dtype=torch.float64)}
    E, E2, PS, L2, Ra, SA = tst._members_stats(cfg, consts, U)
    sums = K.stats_sums_members_ref(U, None, consts['A0'], consts['A1'],
                                    delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                                    threshold=cfg.threshold)
    mean = (sums[:, 2] / (N * N)).to(U.dtype)
    assert torch.equal(PS, K.absdev_sum_members_ref(U, mean) / (N * N))
    assert torch.equal(Ra, K.row_absdev_members_ref(U, N // 2 + 1))
    folded = dataclasses.replace(cfg, fold_field=True)
    got = tst._members_stats(folded, consts, dct_ops.fold1(U))
    assert torch.equal(got[4], Ra) and torch.equal(got[2], PS)


# ----------------------------------------------------------------------
# cdiv: the body's division by h and 2h, in exact rational arithmetic
# ----------------------------------------------------------------------

FORMATS = {'float32': (24, -126, 127), 'float64': (53, -1022, 1023)}


def _rn(q: Fraction, fmt: str):
    """q rounded to nearest, ties to even, in ``fmt`` (subnormals and
    overflow to infinity included), as a float (or +-inf)."""
    p, emin, emax = FORMATS[fmt]
    if q == 0:
        return 0.0
    s = -1 if q < 0 else 1
    a = abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    if Fraction(2) ** (e + 1) <= a:
        e += 1
    ulp = Fraction(2) ** (max(e, emin) - p + 1)
    n, r = divmod(a, ulp)
    if r * 2 > ulp or (r * 2 == ulp and n % 2):
        n += 1
    v = n * ulp
    if v >= Fraction(2) ** (emax + 1):
        return s * math.inf
    return s * float(v)


def _fma(a, b, c, fmt):
    return _rn(Fraction(a) * Fraction(b) + Fraction(c), fmt)


def cdiv32(x: float, c: float, y: float) -> float:
    """The float32 body: RN32(RN64(x * y)), y = RN64(1 / c)."""
    return _rn(Fraction(_rn(Fraction(x) * Fraction(y), 'float64')),
               'float32')


LO, HI = 2.0 ** -900, 2.0 ** 901


def cdiv64(x: float, c: float, y: float) -> float:
    """The float64 body: the product by y corrected twice by fma, the
    true division outside 2^-900 <= |x| < 2^901."""
    if not LO <= abs(x) < HI:
        return _rn(Fraction(x) / Fraction(c), 'float64')
    q0 = _rn(Fraction(x) * Fraction(y), 'float64')
    q1 = _fma(_fma(-q0, c, x, 'float64'), y, q0, 'float64')
    return _fma(_fma(-q1, c, x, 'float64'), y, q1, 'float64')


def _f32(v: float) -> float:
    return float(np.float32(v))


def _inputs32(rnd, n):
    xs = [0.0, -0.0, 1.0, -1.0, 2.0 ** -149, -(2.0 ** -149), 2.0 ** -126,
          float(np.finfo(np.float32).max), -float(np.finfo(np.float32).max),
          1e-3, 0.875 - 0.87499994]
    for _ in range(n):
        bits = rnd.getrandbits(32)
        x = float(np.array(bits, dtype=np.uint32).view(np.float32))
        if math.isfinite(x):
            xs.append(x)
        # differences of two field values in (0, 1)
        xs.append(_f32(_f32(rnd.random()) - _f32(rnd.random())))
    return xs


def _inputs64(rnd, n, c):
    xs = [0.0, -0.0, 5e-324, -5e-324, 2.0 ** -1022, 1.7976931348623157e308,
          LO, -LO, math.nextafter(LO, 0.0), math.nextafter(HI, 0.0),
          HI, 1.0, -1.0]
    for _ in range(n):
        m = rnd.getrandbits(52)
        ex = rnd.randint(-960, 960)
        xs.append(math.ldexp(1 + m / 2 ** 52, ex) * rnd.choice((1, -1)))
        xs.append(rnd.random() - rnd.random())
        # x / c near a double and near a midpoint of two
        q = math.ldexp(1 + rnd.getrandbits(52) / 2 ** 52, rnd.randint(-60, 60))
        xs.append(_rn(Fraction(q) * Fraction(c), 'float64'))
        xs.append(_rn((Fraction(q) + Fraction(math.ulp(q)) / 2)
                      * Fraction(c), 'float64'))
    return xs


# the runs' h: the canonical delx (N=512) and the other fields' sizes
RUN_NS = [512, 1024, 2048, 4096, 1000, 1001, 1002, 4094, 64, 66]


def _delx(N):
    p = ct.Parameters()
    p.N = N
    return JDerived.from_params(p).delx


@pytest.mark.parametrize('N', RUN_NS)
def test_cdiv_float32_gives_the_true_quotient(N):
    """float32: the product of the float x by the double reciprocal of
    the float c = h or 2h, rounded to float, is RN32(x / c) exactly, for
    random bit patterns, differences of field values and the edges."""
    rnd = random.Random(N)
    delx = _delx(N)
    for c in (_f32(delx), _f32(2.0 * delx)):
        y = _rn(1 / Fraction(c), 'float64')
        for x in _inputs32(rnd, 150):
            assert cdiv32(x, c, y) == _rn(Fraction(x) / Fraction(c),
                                          'float32'), (c, x)


@pytest.mark.parametrize('N', RUN_NS)
def test_cdiv_float64_gives_the_true_quotient(N):
    """float64: q0 = x y, two fma corrections, is RN64(x / c) for c = h
    and 2h on random inputs across and beyond the guarded range, values
    near a quotient's double or midpoint, and the edges."""
    rnd = random.Random(N)
    delx = _delx(N)
    for c in (delx, 2.0 * delx):
        y = _rn(1 / Fraction(c), 'float64')
        assert y == 1.0 / c
        for x in _inputs64(rnd, 40, c):
            assert cdiv64(x, c, y) == _rn(Fraction(x) / Fraction(c),
                                          'float64'), (c, x)


def test_rn_rounds_as_the_hardware():
    """The emulation's rounding agrees with IEEE arithmetic where the
    hardware computes the same thing: products and quotients in both
    types, a float64 -> float32 conversion, ties to even."""
    rnd = random.Random(5)
    for _ in range(300):
        a, b = rnd.uniform(-4, 4), rnd.uniform(0.1, 4)
        assert _rn(Fraction(a) * Fraction(b), 'float64') == a * b
        assert _rn(Fraction(a) / Fraction(b), 'float64') == a / b
        assert _rn(Fraction(a), 'float32') == _f32(a)
        fa, fb = np.float32(a), np.float32(b)
        assert _rn(Fraction(float(fa)) / Fraction(float(fb)),
                   'float32') == float(fa / fb)
    assert _rn(Fraction(1) + Fraction(1, 2 ** 24), 'float32') == 1.0
    assert _rn(Fraction(1) + Fraction(3, 2 ** 24), 'float32') == \
        1.0 + 2 ** -22
    assert _rn(Fraction(2) ** 128, 'float32') == math.inf
    assert _rn(Fraction(1, 2 ** 150), 'float32') == 0.0
    assert _rn(Fraction(3, 2 ** 150), 'float32') == 2.0 ** -148


# ----------------------------------------------------------------------
# the statistics' plain versions against the JAX package
# ----------------------------------------------------------------------

def _cfgs(N, dtype):
    p = ct.Parameters()
    p.N = N
    p.kappa_tilde = KAPPA
    d = JDerived.from_params(p)
    kw = dict(N=N, dtype=dtype, RT=d.RT, BRT=d.BRT, B=p.B, Amr=d.Amr,
              L=p.L, delx=d.delx, delx2=d.delx2, M_tilde=p.M_tilde,
              threshold=p.threshold, A0=d.A0, A1=d.A1,
              kappa_tilde=d.kappa_tilde)
    jcfg = jst.StepConfig(**kw)
    return jcfg, jst.make_consts(jcfg, p.delt), tst.StepConfig(**kw)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N,R', [(32, 3), (34, 2)])
@pytest.mark.parametrize('fold', [False, True])
def test_members_stats_match_jax_stats(N, R, dtype, fold):
    """Every member's (E, E2, PS, L2, Ra, SA) from the port's members
    statistics (the fused pass for PS and Ra) against the JAX package's
    _stats of the member (float64 1e-12, float32 1e-5 relative; the
    folded layout against JAX's folded statistics)."""
    npdt = np.float32 if dtype == 'float32' else np.float64
    jcfg, jc, tcfg = _cfgs(N, dtype)
    if fold:
        jcfg = dataclasses.replace(jcfg, fold_field=True)
        tcfg = dataclasses.replace(tcfg, fold_field=True)
    rng = np.random.default_rng(N + R)
    U = (0.875 + 0.01 * (rng.random((R, N, N)) - 0.5)).astype(npdt)
    A0s = jc['A0'] * (1 + 0.002 * np.arange(R))
    A1s = jc['A1'] * (1 - 0.003 * np.arange(R))
    kts = KAPPA * (1 + 0.001 * np.arange(R))
    Es, jouts = [], []
    for r in range(R):
        jcr = dict(jc, A0=jnp.asarray(A0s[r]), A1=jnp.asarray(A1s[r]),
                   kappa_tilde=jnp.asarray(kts[r]))
        Ur = U[r]
        if fold:
            Ur = np.asarray(dct_ops.fold1(torch.from_numpy(Ur)))
        E = np.asarray(jst._nonlinear_term(jcfg, jcr, jnp.asarray(Ur)))
        Es.append(E)
        jouts.append([float(v) for v in jst._stats_fast(
            jcfg, jcr, jnp.asarray(Ur), jnp.asarray(E))])
    consts = {'A0': torch.tensor(A0s), 'A1': torch.tensor(A1s),
              'kappa_tilde': torch.tensor(kts)}
    Ut = torch.from_numpy(np.stack([
        np.asarray(dct_ops.fold1(torch.from_numpy(u))) if fold else u
        for u in U]))
    got = tst._members_stats(tcfg, consts, Ut, torch.from_numpy(
        np.stack(Es)))
    rtol = 1e-12 if dtype == 'float64' else 1e-5
    for r in range(R):
        for name, g, want in zip(('E', 'E2', 'PS', 'L2', 'Ra', 'SA'), got,
                                 jouts[r]):
            np.testing.assert_allclose(g[r].item(), want, rtol=rtol,
                                       err_msg=f'member {r} {name}')


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [32, 34])
def test_stats_plain_versions_match_pallas_band_sums(N, dtype):
    """K3's and K7's plain versions (the parent and the new body's
    common reference) against the JAX package's Pallas band sums in
    interpret mode: the five sums of the field and, in rank order, of
    its four blocks with their halos."""
    npdt = np.float32 if dtype == 'float32' else np.float64
    jcfg, jc, tcfg = _cfgs(N, dtype)
    rng = np.random.default_rng(N)
    U = (0.875 + 0.01 * (rng.random((N, N)) - 0.5)).astype(npdt)
    E = np.asarray(jst._nonlinear_term(jcfg, jc, jnp.asarray(U)))
    kw = dict(delx=jcfg.delx, RT=jcfg.RT, B=jcfg.B,
              threshold=jcfg.threshold)
    tU, tE = torch.from_numpy(U), torch.from_numpy(E.copy())
    ours = K.stats_sums_ref(tU, tE, jc['A0'], jc['A1'], **kw)
    band = np.asarray(pk.stats_band_sums(jnp.asarray(U), jnp.asarray(E),
                                         jc['A0'], jc['A1'], **kw))
    rtol = 1e-12 if dtype == 'float64' else 1e-5
    np.testing.assert_allclose(ours.numpy(), band[0, :5].astype(np.float64),
                               rtol=rtol)
    assert ours[3].item() == band[0, 3]
    bn = N // 2
    blocks = torch.zeros(5, dtype=torch.float64)
    for i in range(2):
        for j in range(2):
            r0, c0 = i * bn, j * bn
            Ub = tU[r0:r0 + bn, c0:c0 + bn].contiguous()
            halo = (tU[max(r0 - 1, 0), c0:c0 + bn], tU[min(r0 + bn, N - 1),
                                                      c0:c0 + bn],
                    tU[r0:r0 + bn, max(c0 - 1, 0)],
                    tU[r0:r0 + bn, min(c0 + bn, N - 1)])
            blocks += K.local_band_sums_ref(
                Ub, *(h.contiguous() for h in halo),
                tE[r0:r0 + bn, c0:c0 + bn].contiguous(), jc['A0'],
                jc['A1'], r0, c0, N=N, **kw)
    np.testing.assert_allclose(blocks.numpy(), ours.numpy(), rtol=rtol)
    assert blocks[3].item() == ours[3].item()


def test_own_scratch_holds_its_buffers():
    """kernels.own_scratch (a CUDA graph's tickets and one-launch
    scratch): inside, one buffer a kind, device and size, kept in the
    owner's dict and never replaced; a nested owner has its own; the
    scope is the thread's."""
    import threading
    owner, dev = {}, torch.device('cpu')
    with K.own_scratch(owner):
        t, s = K._ticket(dev, 3), K._slice_scratch(dev, 4)
        assert K._ticket(dev, 3) is t and K._slice_scratch(dev, 4) is s
        with K.own_scratch({}):
            assert K._ticket(dev, 3) is not t
        assert K._ticket(dev, 3) is t
        seen = []
        th = threading.Thread(
            target=lambda: seen.append(getattr(K._OWNER, 'scratch', None)))
        th.start()
        th.join()
        assert seen == [None]
    assert getattr(K._OWNER, 'scratch', None) is None
    assert (t.dtype, t.numel(), s.dtype, s.numel()) == (
        torch.int32, 3, torch.int64, 5)
    assert not t.any() and not s.any()
    assert set(owner) == {('ticket', None, 3), ('slice', None, 5)}
