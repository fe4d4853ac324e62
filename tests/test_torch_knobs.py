"""The float32 knobs of the port (the product precision names, the
forward's, the banded inverse, the coefficients rebuilt per step by K12,
the auto gates) on the CPU, against the JAX package.

Bounds: the coefficients of ``--otf-coeffs`` to the bit against the JAX
package's ``get_coefficients_axis``; a short otf run against the JAX
package's within 1e-12 (float64) and 1e-6 (float32) relative at every
step; the guards' messages equal to the JAX Solver's; the banded inverse
within one TF32 rounding of its tail's products (2^-10 of the tail's
scale) of the JAX package's on the CPU, where XLA contracts every
precision in full float32."""

import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.core.solver import Solver as JaxSolver
from chsimpy_tpu.ensemble import EnsembleSolver as JaxEnsemble

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch.cli import CLIParser
from chsimpy_tpu_torch.core import solver as tsolver
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.ensemble import EnsembleSolver
from chsimpy_tpu_torch.ops import dct as dct_ops
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706


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


def _rand(*shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=dtype)


# ---------------------------------------------------------------- names

def test_tf32_round_keeps_ten_mantissa_bits():
    x = _rand(4096, seed=1)
    r = K.tf32_round(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    # round to nearest: within half a TF32 ulp (2^-11 relative)
    assert bool(((r - x).abs() <= x.abs() * 2.0 ** -11).all())
    # ties away from zero, as cvt.rna
    t = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert K.tf32_round(t).tolist() == [1.0 + 2.0 ** -10,
                                        -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize('precision', [None, 'highest', 'high', 'default'])
def test_precision_names_on_the_cpu(precision):
    A, B = _rand(33, 47, seed=2), _rand(47, 29, seed=3)
    got = dct_ops.mm(A, B, precision)
    if precision == 'default':
        want = torch.matmul(K.tf32_round(A), K.tf32_round(B))
    else:
        want = torch.matmul(A, B)
    assert torch.equal(got, want)
    # a member axis on either operand, as the ensemble's stacks give it
    As = torch.stack([A, 2 * A])
    assert torch.equal(dct_ops.mm(As, B, precision)[1],
                       dct_ops.mm(2 * A, B, precision))
    # float64 ignores the name
    A64, B64 = A.double(), B.double()
    assert torch.equal(dct_ops.mm(A64, B64, precision), A64 @ B64)


def test_unknown_precision_name_raises():
    A = _rand(4, 4)
    with pytest.raises(ValueError, match='unknown matmul precision'):
        dct_ops.mm(A, A, 'fast')
    with pytest.raises(SystemExit):
        CLIParser().get_parameters(['--no-gui', '--matmul-precision',
                                    'fast'])


@pytest.mark.parametrize('precision,bound', [('high', 1e-5),
                                             ('default', 3e-3)])
def test_split_round_trip_per_precision(precision, bound):
    """The split route's round trip in each name's class: full float32
    for 'high' on the CPU, one TF32 rounding of every operand for
    'default' (about 2^-11 a product)."""
    N, L = 64, 2
    tree = dct_ops.split_tree(N, L, torch.float32)
    x = torch.tensor(np.random.default_rng(4).random((N, N)),
                     dtype=torch.float32)
    y = dct_ops.idct2_split_perm(
        dct_ops.dct2_split_perm(x, tree, precision), tree, precision)
    assert (y - x).abs().max().item() <= bound


# ------------------------------------------------------------ inv-band

def _spectrum(N, seed=5):
    """A CH-like spectral image: a dominant low band, a decayed tail."""
    rng = np.random.default_rng(seed)
    k = np.arange(N)
    decay = np.exp(-k / (N / 8.0))
    return torch.tensor(rng.standard_normal((N, N))
                        * decay[:, None] * decay[None, :],
                        dtype=torch.float32)


def test_idct2_banded_against_jax():
    from chsimpy_tpu.ops import dct as jdct
    N = 64
    k0 = N // 4
    X = _spectrum(N)
    C = dct_ops.dct_matrix(N, torch.float32)
    got = dct_ops.idct2_banded(X, C, k0)
    want = np.asarray(jdct.idct2_banded(X.numpy(), C.numpy(), k0))
    tail = X.abs()[k0:].max().item()
    assert np.max(np.abs(got.numpy() - want)) <= 2.0 ** -10 * tail * N
    # no tail: the uniform inverse within float32 rounding
    X0 = X.clone()
    X0[k0:] = 0
    X0[:, k0:] = 0
    np.testing.assert_allclose(dct_ops.idct2_banded(X0, C, k0).numpy(),
                               dct_ops.idct2(X0, C).numpy(), atol=1e-6)


@pytest.mark.parametrize('folded', [False, True])
def test_split_band_frac_against_jax(folded):
    from chsimpy_tpu.ops import dct as jdct
    N, L = 64, 2
    perm = dct_ops._split_permutation_np(N, L)
    X = _spectrum(N)[perm][:, perm].contiguous()   # the permuted basis
    tree = dct_ops.split_tree(N, L, torch.float32)
    jtree = jdct.split_tree(N, L, np.float32)
    if folded:
        got = dct_ops.idct2_split_perm_folded(X, tree, band_frac=0.25)
        want = jdct.idct2_split_perm_folded(X.numpy(), jtree,
                                            band_frac=0.25)
    else:
        got = dct_ops.idct2_split_perm(X, tree, band_frac=0.25)
        want = jdct.idct2_split_perm(X.numpy(), jtree, band_frac=0.25)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 2e-5


def test_inv_band_cut_matches_jax_blocks():
    """_band cuts each split block where the JAX package's
    _mmt_banded_l cuts it."""
    for n in (1, 2, 3, 7, 16, 64, 100):
        for frac in (None, 0.0, 0.1, 0.25, 0.5, 0.99):
            j0 = max(1, int(n * frac)) if frac else n
            want = n if j0 >= n else j0
            assert dct_ops._band(n, frac) == want, (n, frac)


@pytest.mark.parametrize('route', ['matmul', 'split'])
def test_inv_band_run_stays_in_the_float32_class(route):
    """A run with --inv-band N/4 against the uniform float32 run: the
    tail's TF32 rounding stays inside the float32 class (E 1e-5)."""
    def run(band):
        s = ctt.Solver(port_params(N=64, ntmax=60, precision='float32',
                                   transform_backend=route, full_sim=True,
                                   inv_band=band))
        s.prepare()
        return np.asarray(s.solve_or_resume(60).timedata.E), s
    E0, _ = run(0)
    E1, s = run(16)
    assert s.cfg.inv_band == 16
    assert np.max(np.abs(E1 / E0 - 1)) <= 1e-5


# ----------------------------------------------------------------- otf

@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_otf_coefficients_bits_against_jax(dtype):
    import jax.numpy as jnp
    from chsimpy_tpu.ops import coeffs as jcoeffs
    from chsimpy_tpu.derived import Derived
    p = jax_params()
    d = Derived.from_params(p)
    N = 64
    tdt = getattr(torch, dtype)
    e = torch.tensor(dct_ops.split_permute_axis(
        tst.coeffs_ops.eigenvalue_axis(N), N, 2), dtype=tdt)
    for delt in (3e-8, 4.1e-8, 1.234567e-7):
        CH, S = K.otf_coefficients_ref(
            e, e, torch.tensor(delt, dtype=torch.float64), KAPPA, d.delx2)
        jCH, jS = jcoeffs.get_coefficients_axis(
            jnp.asarray(e.numpy()),
            jnp.asarray(KAPPA, jnp.float64).astype(dtype),
            jnp.asarray(delt, jnp.float64).astype(dtype), d.delx2)
        assert np.array_equal(CH.numpy(), np.asarray(jCH)), delt
        assert np.array_equal(S.numpy(), np.asarray(jS)), delt
    # per member: member r's grids are the single call's with its scalars
    kap = torch.tensor([KAPPA, 1.01 * KAPPA], dtype=torch.float64)
    dts = torch.tensor([3e-8, 3.3e-8], dtype=torch.float64)
    CHm, Sm = K.otf_coefficients_ref(e, e, dts, kap, d.delx2)
    for r in range(2):
        CH, S = K.otf_coefficients_ref(e, e, dts[r], kap[r].item(), d.delx2)
        assert torch.equal(CHm[r], CH) and torch.equal(Sm[r], S)


def test_update_otf_plain_version_and_blocks():
    N = 48
    e = torch.tensor(tst.coeffs_ops.eigenvalue_axis(N))
    hU, hE = _rand(N, N, seed=6, dtype=torch.float64), \
        _rand(N, N, seed=7, dtype=torch.float64)
    delt = torch.tensor(3e-8, dtype=torch.float64)
    args = (e, delt, KAPPA, 1e-4)
    whole = K.update_otf(hU, hE, *args)
    CH, S = K.otf_coefficients_ref(e, e, delt, KAPPA, 1e-4)
    assert torch.equal(whole, K.spectral_update_ref(hU, hE, S, CH))
    # a rank's block: the whole field's block, to the bit
    blk = K.update_otf(hU[16:40, 8:20].contiguous(),
                       hE[16:40, 8:20].contiguous(), *args, 16, 8)
    assert torch.equal(blk, whole[16:40, 8:20])
    # members: each member's own kappa and delt, a block too
    kap = torch.tensor([KAPPA, 2 * KAPPA], dtype=torch.float64)
    dts = torch.tensor([3e-8, 6e-8], dtype=torch.float64)
    st = torch.stack([hU, hE])
    m = K.update_otf_members(st, st.flip(0), e, dts, kap, 1e-4)
    assert torch.equal(m[1], K.update_otf(hE, hU, e, dts[1], 2 * KAPPA,
                                          1e-4))
    mb = K.update_otf_members(st[:, 4:9].contiguous(),
                              st.flip(0)[:, 4:9].contiguous(), e, dts, kap,
                              1e-4, 4, 0)
    assert torch.equal(mb, m[:, 4:9])
    with pytest.raises(ValueError, match='does not lie'):
        K.update_otf(hU, hE, *args, 1, 0)
    with pytest.raises(ValueError, match='float64'):
        K.update_otf(hU, hE, e, delt.float(), KAPPA, 1e-4)


@pytest.mark.parametrize('precision,rtol', [('float64', 1e-12),
                                            ('float32', 1e-6)])
@pytest.mark.parametrize('route', ['matmul', 'split'])
def test_otf_run_against_jax(route, precision, rtol):
    kw = dict(N=32, ntmax=80, full_sim=True, precision=precision,
              transform_backend=route, otf_coeffs=1, split_levels=2,
              fold_field=False, matmul_precision='highest')
    js = JaxSolver(jax_params(**kw))
    js.prepare()
    jE = np.asarray(js.solve_or_resume(80).timedata.E)
    ts = ctt.Solver(port_params(**kw))
    assert ts.cfg.otf_coeffs
    ts.prepare()
    tE = np.asarray(ts.solve_or_resume(80).timedata.E)
    assert js.cfg.otf_coeffs
    assert np.max(np.abs(tE / jE - 1)) <= rtol


def test_otf_adaptive_run_against_jax():
    """-a rebuilds the coefficients at the adapted delt every step: under
    --otf-coeffs K12 reads that delt on the device."""
    kw = dict(N=32, ntmax=540, full_sim=True, precision='float64',
              transform_backend='matmul', otf_coeffs=1, adaptive_time=True,
              delt_max=2.4e-9)
    js = JaxSolver(jax_params(**kw))
    js.prepare()
    jd = js.solve_or_resume(540).timedata.data()
    ts = ctt.Solver(port_params(**kw))
    ts.prepare()
    td = ts.solve_or_resume(540).timedata.data()
    assert np.max(np.abs(td[:, 1] / jd[:, 1] - 1)) <= 1e-12
    # delt moved after step 500, as in the JAX run
    assert np.max(np.abs(td[:, 8] / jd[:, 8] - 1)) <= 1e-12
    assert td[-1, 8] != td[0, 8]


def test_otf_ensemble_builds_no_member_grids():
    pairs = np.array([[1.0, 2.0], [1.1, 2.1]]) * [[-30.0, 10.0]]
    p = port_params(N=32, precision='float64', otf_coeffs=1, full_sim=True)
    ens = EnsembleSolver(p, pairs, kappas=np.array([KAPPA, 1.02 * KAPPA]))
    assert ens.cfg.otf_coeffs
    assert tuple(ens._consts['CHeig'].shape) == (32, 32)
    ens.prepare()
    sols = ens.solve_or_resume(30)
    ref = EnsembleSolver(port_params(N=32, precision='float64',
                                     full_sim=True), pairs,
                         kappas=np.array([KAPPA, 1.02 * KAPPA]))
    ref.prepare()
    for a, b in zip(sols, ref.solve_or_resume(30)):
        np.testing.assert_allclose(a.timedata.E, b.timedata.E, rtol=1e-12)


# -------------------------------------------------------------- guards

def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError('no ValueError')


@pytest.mark.parametrize('kw', [
    dict(inv_band=8),                                      # float64
    dict(inv_band=64, precision='float32'),                # not in (0, N)
    dict(inv_band=8, precision='float32', transform_backend='fft'),
    dict(fold_field=True, transform_backend='matmul'),
    dict(fold_field=True, transform_backend='fft'),
])
def test_guards_give_the_jax_messages(kw):
    kw = dict(N=64, **kw)
    got = _message(lambda: ctt.Solver(port_params(**kw)))
    want = _message(lambda: JaxSolver(jax_params(**kw)))
    assert got == want


def test_fold_under_a_mesh_gives_the_jax_message():
    kw = dict(N=64, fold_field=True, transform_backend='split',
              mesh_shape=(1, 2), dist_backend='gloo')
    got = _message(lambda: ctt.Solver(port_params(**kw)))
    assert got == ("--fold-field is single-device only (the folded seam "
                   "crosses shard halves)")


def test_ensemble_refuses_float64_inv_band_where_jax_accepts():
    """A fault of the reference the port does not copy: the JAX ensemble
    takes a pinned --inv-band in float64 (chsimpy_tpu/ensemble.py:171),
    which its own Solver refuses; the port's ensemble shares the single
    run's guard."""
    pairs = np.array([[-30.0, 20.0], [-30.3, 20.2]])
    kw = dict(N=32, inv_band=8)
    JaxEnsemble(jax_params(**kw), pairs)             # accepted there
    with pytest.raises(ValueError, match='float32 fast-mode'):
        EnsembleSolver(port_params(**kw), pairs,
                       kappas=np.array([KAPPA, KAPPA]))
    # float32: pinned, it runs on the ensemble
    ens = EnsembleSolver(port_params(N=32, inv_band=8, precision='float32'),
                         pairs, kappas=np.array([KAPPA, KAPPA]))
    assert ens.cfg.inv_band == 8


def test_inv_band_help_names_both_routes():
    text = CLIParser().parser.format_help()
    assert 'matmul and split routes' in ' '.join(text.split())
    assert 'item 14' not in text


# ---------------------------------------------------------- auto gates

def test_auto_route_table():
    for prec, rows in tsolver.AUTO_ROUTES.items():
        assert rows[-1][0] == 0                 # every N has a row
        assert [n for n, _ in rows] == sorted((n for n, _ in rows),
                                              reverse=True)
        for N in (16, 64, 512, 1024, 2048, 4096, 8192):
            route = tsolver.auto_route(N, prec)
            assert route == next(r for n, r in rows if N >= n) or N % 2
            p = port_params(N=N, precision=prec)
            assert tsolver.resolve_transform(p) == route
    # an odd N takes no even-N route; under a mesh only what shards
    assert tsolver.auto_route(513, 'float32') in ('matmul', 'ozaki')
    assert tsolver.auto_route(4096, 'float32', 4) in ('matmul', 'split')
    assert tsolver.auto_route(4094, 'float32', 4) == 'matmul'


def test_knob_resolvers_pin_and_gate():
    p = port_params(N=2048, precision='float32', transform_backend='split')
    # pinned values win
    for field, value, fn, want in (
            ('fwd_matmul_precision', 'high',
             tsolver.resolve_fwd_matmul_precision, 'high'),
            ('inv_band', 0, tsolver.resolve_inv_band, None),
            ('inv_band', 100, tsolver.resolve_inv_band, 100),
            ('otf_coeffs', 0, tsolver.resolve_otf_coeffs, False),
            ('otf_coeffs', 1, tsolver.resolve_otf_coeffs, True),
            ('fold_field', False, tsolver.resolve_fold_field, False),
            ('matmul_precision', 'default',
             tsolver.resolve_matmul_precision, 'default')):
        q = port_params(N=2048, precision='float32',
                        transform_backend='split', **{field: value})
        assert fn(q) == want, field
    # the auto gates follow the table of core/solver.py
    gate = tsolver.AUTO_FWD_DEFAULT_MIN_N
    assert tsolver.resolve_fwd_matmul_precision(p) == (
        'default' if gate is not None and 2048 >= gate else None)
    gate = tsolver.AUTO_INV_BAND_MIN_N
    assert tsolver.resolve_inv_band(p) == (
        512 if gate is not None and 2048 >= gate else None)
    gate = tsolver.AUTO_OTF_MIN_N
    assert tsolver.resolve_otf_coeffs(p) == (gate is not None
                                             and 2048 >= gate)
    assert tsolver.resolve_fold_field(p) == tsolver.AUTO_FOLD
    # a pinned --matmul-precision keeps the transforms symmetric, as in
    # the JAX package; float64 and a mesh take no gate
    for q in (port_params(N=2048, precision='float32', transform_backend=
                          'split', matmul_precision='high'),
              port_params(N=2048, transform_backend='split')):
        assert tsolver.resolve_fwd_matmul_precision(q) is None
        assert tsolver.resolve_inv_band(q) is None
        assert not tsolver.resolve_otf_coeffs(q)
    assert not tsolver.resolve_fold_field(
        port_params(N=2048, precision='float32', transform_backend='split',
                    mesh_shape=(1, 2)))
    # float64 takes full float64 products whatever the float32 default;
    # float32 'high' from F32_HIGH_MIN_N up
    assert tsolver.resolve_matmul_precision(port_params(N=4096)) == 'highest'
    for N in (512, 1024, 4096):
        assert tsolver.resolve_matmul_precision(
            port_params(N=N, precision='float32')) == (
                'high' if N >= tsolver.F32_HIGH_MIN_N else 'highest')


def test_ensemble_takes_band_and_otf_pinned_only():
    pairs = np.array([[-30.0, 20.0]])
    ens = EnsembleSolver(port_params(N=2048, precision='float32',
                                     transform_backend='split'), pairs,
                         kappas=np.array([KAPPA]))
    assert ens.cfg.inv_band is None and not ens.cfg.otf_coeffs
    assert ens.cfg.matmul_precision == 'high'


@pytest.mark.parametrize('N,fold,want', [(4096, False, 4), (4096, True, 5),
                                         (4112, True, 4), (2048, True, 3),
                                         (512, True, 2)])
def test_split_levels_fold_branch_as_in_jax(N, fold, want):
    from chsimpy_tpu.core import stepper as jst
    kw = dict(N=N, dtype='float32', RT=1.0, BRT=1.0, B=1.0, Amr=1.0, L=1.0,
              delx=1.0, delx2=1.0, M_tilde=1.0, threshold=0.5,
              transform_backend='split', fold_field=fold)
    assert tst.StepConfig(**kw).split_levels_resolved == want
    assert jst.StepConfig(**kw).split_levels_resolved == want


# ---------------------------------------------------------- under a mesh

@pytest.fixture(scope='module')
def mesh_runs():
    """The knobs on a 2x2 gloo world (the matmul route on the grid layout,
    split on the pencil layout) and on one device, from the same field:
    K12 on each rank's block of the spectral image, the banded inverse
    and the forward's precision on the sharded transforms."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    base = dict(N=32, ntmax=40, full_sim=True, no_gui=True, device='cpu',
                kappa_tilde=KAPPA, generator='uniform')
    cases = [dict(base, transform_backend='matmul', otf_coeffs=1),
             dict(base, transform_backend='split', otf_coeffs=1),
             dict(base, transform_backend='matmul', precision='float32',
                  otf_coeffs=1, inv_band=8, fwd_matmul_precision='default'),
             dict(base, transform_backend='split', precision='float32',
                  otf_coeffs=1, inv_band=8, fwd_matmul_precision='default')]
    tasks = [('solve', {'params': p, 'steps': 40, 'return_U': True})
             for p in cases]
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=(tasks,), timeout=300, threads=1)
    one = []
    for p in cases:
        s = ctt.Solver(ctt.Parameters(**p))
        s.prepare()
        sol = s.solve_or_resume(40)
        one.append((sol.timedata.data(), sol.U.numpy()))
    return res, one, cases


@pytest.mark.parametrize('i', range(4))
def test_knobs_under_a_mesh_are_the_one_device_run(mesh_runs, i):
    res, one, cases = mesh_runs
    got = res[0][i]
    assert got['pencil'] == (cases[i]['transform_backend'] == 'split')
    float64 = cases[i].get('precision', 'float64') == 'float64'
    rtol = 1e-12 if float64 else 1e-6
    np.testing.assert_allclose(got['timedata'][:, 1], one[i][0][:, 1],
                               rtol=rtol)
    np.testing.assert_allclose(got['U'], one[i][1], rtol=0,
                               atol=1e-12 if float64 else 1e-5)
    for r in res[1:]:
        assert np.array_equal(r[i]['timedata'], got['timedata'])
