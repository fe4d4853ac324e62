"""The CUDA kernels of chsimpy_tpu_torch against their plain PyTorch
versions, the ozaki transforms and short solves on the card against the
same on the CPU.

These tests need an NVIDIA card with ``nvcc`` (they build
``csrc/ch_kernels.cu``); without one they skip.  They import no jax, so
they run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chsimpy_tpu_torch import Parameters, Simulator
from chsimpy_tpu_torch.derived import Derived
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.ops import ozaki as oz

pytestmark = pytest.mark.cuda

KAPPA = 0.00029891134208698706


def _physics(N=1000):
    p = Parameters(N=N, kappa_tilde=KAPPA)
    d = Derived.from_params(p)
    return dict(RT=d.RT, BRT=d.BRT, A0=d.A0, A1=d.A1, delx=d.delx, B=p.B,
                threshold=p.threshold)


PHYS = _physics()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', torch.cuda.current_device())


def _field(N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    U = 0.875 + 0.01 * (rng.random((N, N)) - 0.5)
    return torch.tensor(U, dtype=dtype, device=device)


def _tol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [2, 3, 33, 1000])
def test_kernels_match_plain_versions(card, dtype, N):
    U = _field(N, dtype, card)
    p = PHYS
    K.reset_launches()
    mu = K.chemical_potential(U, p['RT'], p['BRT'], p['A0'], p['A1'])
    mu_ref = K.chemical_potential_ref(U, p['RT'], p['BRT'], p['A0'],
                                      p['A1'])
    err = (mu - mu_ref).abs().max().item()
    if dtype == torch.float64:
        assert err <= 1e-12 * mu_ref.abs().max().item()
    else:
        assert err <= 1e-4

    rng = np.random.default_rng(1)
    ops = [torch.tensor(rng.standard_normal((N, N)), dtype=dtype,
                        device=card) for _ in range(3)]
    CHeig = torch.tensor(1 + rng.random((N, N)), dtype=dtype, device=card)
    upd = K.spectral_update(*ops, CHeig)
    upd_ref = K.spectral_update_ref(*ops, CHeig)
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(upd, upd_ref, rtol=rtol, atol=0)

    kw = dict(delx=p['delx'], RT=p['RT'], B=p['B'],
              threshold=p['threshold'])
    for E in (mu, None):
        s = K.stats_sums(U, E, p['A0'], p['A1'], **kw).cpu()
        s_ref = K.stats_sums_ref(U, E, p['A0'], p['A1'], **kw).cpu()
        assert s[3] == s_ref[3]                      # threshold count
        torch.testing.assert_close(s, s_ref, rtol=_tol(dtype), atol=0)
        if E is None:
            assert s[4] == 0

    mean = (s[2] / (N * N)).to(dtype).to(card)
    a = K.absdev_sum(U, mean).item()
    a_ref = K.absdev_sum_ref(U, mean).item()
    assert abs(a - a_ref) <= _tol(dtype) * abs(a_ref)
    assert K.launches == {'chemical_potential': 1, 'spectral_update': 1,
                          'stats_sums': 2, 'absdev_sum': 1,
                          'slice_field': 0}


def test_stats_sums_are_reproducible(card):
    """Fixed-order reductions: the same input gives the same bits."""
    U = _field(1000, torch.float32, card)
    kw = dict(delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
              threshold=PHYS['threshold'])
    first = K.stats_sums(U, U, PHYS['A0'], PHYS['A1'], **kw)
    for _ in range(5):
        assert torch.equal(K.stats_sums(U, U, PHYS['A0'], PHYS['A1'], **kw),
                           first)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    U = _field(64, torch.float32, card)
    with pytest.raises(ValueError, match='contiguous'):
        K.chemical_potential(U.T, 1.0, 1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        K.spectral_update(U, U, U, U.double())
    with pytest.raises(ValueError, match='devices'):
        K.spectral_update(U, U, U, U.cpu())


def _solve(device, **kw):
    p = Parameters(N=64, ntmax=120, no_gui=True, device=device,
                   kappa_tilde=KAPPA, generator='lcg', chunk_size=32)
    for k, v in kw.items():
        setattr(p, k, v)
    return Simulator(p).solve()


@pytest.mark.parametrize('kw', [{}, {'delt': 3e-6}, {'delt': 3e-6,
                                                      'full_sim': True}])
def test_solve_on_card_matches_cpu(card, kw):
    """float64 on the card (kernels) against the CPU (plain versions):
    same stop step and bookkeeping, E within 1e-12."""
    g = _solve('cuda', **kw)
    c = _solve('cpu', **kw)
    assert (g.computed_steps, g.stop_reason, g.tau0) == \
        (c.computed_steps, c.stop_reason, c.tau0)
    np.testing.assert_allclose(g.t0, c.t0, rtol=1e-14)
    np.testing.assert_allclose(g.timedata.E, c.timedata.E, rtol=1e-12)
    np.testing.assert_allclose(g.U.cpu().numpy(), c.U.numpy(), rtol=0,
                               atol=1e-12)


def _slice_fields(shape, seed=3):
    rng = np.random.default_rng(seed)
    return {'solver': 0.875 + 0.01 * (rng.random(shape) - 0.5),
            'normal': rng.standard_normal(shape), 'zeros': np.zeros(shape)}


@pytest.mark.parametrize('shape', [(512, 512), (1000, 1000), (33, 47),
                                   (5, 3)])
def test_slice_kernel_matches_plain_version(card, shape):
    """K5 against its plain version on the card and on the CPU: the same
    int8 slices to the bit and the same scale, every slice count (the
    odd shapes take the kernel's unpacked stores)."""
    K.reset_launches()
    calls = 0
    for kind, f in _slice_fields(shape).items():
        x = torch.tensor(f, device=card)
        for n in range(1, 9):
            got, scale = K.slice_field(x, n)
            calls += 1
            want, wscale = K.slice_field_ref(x, n)
            cpu, cscale = K.slice_field_ref(x.cpu(), n)
            assert got.shape == (n,) + shape and got.dtype == torch.int8
            assert torch.equal(got, want), (kind, n)
            assert torch.equal(got.cpu(), cpu), (kind, n)
            assert float(scale) == float(wscale) == float(cscale), (kind, n)
    assert K.launches['slice_field'] == calls


def _route(N, route, L, device):
    if route == 'unfold':
        Cs, CsT, sc = oz.dct_slices(N, device)
        return (lambda x, s: oz.dct2_ozaki(x, Cs, CsT, sc, *s),
                lambda y: oz.idct2_ozaki(y, Cs, CsT, sc), 1)
    if route == 'fold':
        fs = oz.dct_fold_slices(N, device)
        return (lambda x, s: oz.dct2_ozaki_fold(x, fs, *s),
                lambda y: oz.idct2_ozaki_fold(y, fs), 2)
    rf, sc = oz.dct_rfold_slices(N, L, device)
    return (lambda x, s: oz.dct2_ozaki_rfold(x, rf, sc, L, *s),
            lambda y: oz.idct2_ozaki_rfold(y, rf, sc, L), L + 1)


@pytest.mark.parametrize('route,N,L', [('unfold', 129, 0), ('fold', 256, 0),
                                       ('rfold', 1024, 2)])
def test_ozaki_transform_on_card_matches_cpu(card, route, N, L):
    """One forward and one inverse on the card against the CPU, within
    2e-15 max|ref| (the mean is summed in another order); N=129 takes the
    zero-padded int8 products.  Every transform launches the slice kernel
    once per sliced operand."""
    x = 0.875 + 0.01 * (np.random.default_rng(N).random((N, N)) - 0.5)
    gf, gi, n_fwd = _route(N, route, L, card)
    cf, ci, _ = _route(N, route, L, 'cpu')
    K.reset_launches()
    for pairs in ((5, 7), (3, 5)):
        y = gf(torch.tensor(x, device=card), pairs)
        ref = cf(torch.tensor(x), pairs)
        bound = 2e-15 * ref.abs().max().item()
        assert (y.cpu() - ref).abs().max().item() <= bound, pairs
    u = gi(ref.to(card))
    uref = ci(ref)
    assert (u.cpu() - uref).abs().max().item() <= \
        2e-15 * uref.abs().max().item()
    assert K.launches['slice_field'] == 2 * n_fwd + 1


def test_ozaki_solve_on_card_matches_cpu(card):
    """The float64 ozaki route (level-1 fold, N=64) on the card against
    the CPU: same steps, E within 1e-12, U within 1e-11 (the route moves
    slice rounding boundaries on a one-ulp change of its operand), and
    the slice kernel launched three times per step plus twice at entry."""
    kw = {'transform_backend': 'ozaki'}
    K.reset_launches()
    g = _solve('cuda', **kw)
    iterations = 119                     # ntmax 120 in chunks of 32
    assert K.launches['slice_field'] == 2 + 3 * iterations
    assert K.launches['chemical_potential'] == iterations
    c = _solve('cpu', **kw)
    assert (g.computed_steps, g.stop_reason) == (c.computed_steps,
                                                 c.stop_reason)
    np.testing.assert_allclose(g.timedata.E, c.timedata.E, rtol=1e-12)
    np.testing.assert_allclose(g.U.cpu().numpy(), c.U.numpy(), rtol=0,
                               atol=1e-11)
