"""The CUDA kernels of chsimpy_tpu_torch (the GEMM with its member axis,
the grid-sharded K7/K8 and K7_members, the Sobol jitter K9, the threefry
jitter K10, K5 sharded, the otf update K12 and K3's fold mode included)
against their plain PyTorch versions, and the ozaki, split and FFT
transforms, short solves (under the float32 knobs too) and grid-sharded
and pencil solves of ranks sharing the card on the card against the same
on the CPU.

These tests need an NVIDIA card with ``nvcc`` (they build the kernels of
``csrc/``); without one they skip.  They import no jax, so
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
@pytest.mark.parametrize('N', [2, 3, 33, 1000, 1001])
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
    # these four launched as counted, every other kernel not at all
    assert K.launches == dict(dict.fromkeys(K.launches, 0),
                              chemical_potential=1, spectral_update=1,
                              stats_sums=2, absdev_sum=1)


def test_stats_sums_are_reproducible(card):
    """Fixed-order reductions: the same input gives the same bits."""
    U = _field(1000, torch.float32, card)
    kw = dict(delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
              threshold=PHYS['threshold'])
    first = K.stats_sums(U, U, PHYS['A0'], PHYS['A1'], **kw)
    for _ in range(5):
        assert torch.equal(K.stats_sums(U, U, PHYS['A0'], PHYS['A1'], **kw),
                           first)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_stats_sums_scalar_path_on_an_unaligned_field(card, dtype):
    """A field that starts 1 element past a 16-byte boundary takes K3's
    one-column path (the vector loads need aligned rows) and gives the
    vector path's sums, up to the float64 summation order."""
    N = 512
    U = _field(N, dtype, card)
    store = torch.empty(N * N + 1, dtype=dtype, device=card)
    Uo = store[1:].view(N, N)
    Uo.copy_(U)
    assert K.stats_grid(N, U.element_size(), Uo.data_ptr())[0] == 1
    assert K.stats_grid(N, U.element_size(), U.data_ptr())[0] > 1
    kw = dict(delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
              threshold=PHYS['threshold'])
    got = K.stats_sums(Uo, None, PHYS['A0'], PHYS['A1'], **kw)
    vec = K.stats_sums(U, None, PHYS['A0'], PHYS['A1'], **kw)
    ref = K.stats_sums_ref(U, None, PHYS['A0'], PHYS['A1'], **kw)
    assert got[3] == ref[3]
    torch.testing.assert_close(got, ref, rtol=_tol(dtype), atol=0)
    torch.testing.assert_close(got, vec, rtol=1e-13, atol=0)


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


@pytest.mark.parametrize('shape', [(1000, 1000), (64, 64), (33, 47)])
def test_slice_kernel_one_ulp_above_a_power_of_two(card, shape):
    """max|x| = 2^8 (1 + 2^-52): the kernel's scale is the plain version's
    exp2(ceil(log2(amax + 1e-30)) + 2) on the card, not frexp's, and the
    slices are the same bits; one count per call."""
    rng = np.random.default_rng(17)
    f = np.clip(rng.standard_normal(shape) * 20.0, -120.0, 120.0)
    f[shape[0] // 3, shape[1] // 2] = -np.nextafter(256.0, np.inf)
    x = torch.tensor(f, device=card)
    K.reset_launches()
    for n in (4, 6, 8):
        got, scale = K.slice_field(x, n)
        want, wscale = K.slice_field_ref(x, n)
        assert torch.equal(got, want), n
        assert float(scale) == float(wscale), n
    assert K.launches['slice_field'] == 3


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


@pytest.mark.parametrize('M', [16, 24, 32, 40, 48, 64, 96, 128, 136])
@pytest.mark.parametrize('K_,N', [(64, 64), (128, 64), (64, 24),
                                  (256, 256), (129, 9)])
def test_int8_matmul_exact_on_card(card, M, K_, N):
    """The int8 products on the card, the int64 product's values on every
    shape: cuBLASLt refuses (16, 24, 40, 48, 136) x 64 @ 64 x 64 int8
    operands, which ``int8_matmul`` pads or multiplies in float64."""
    rng = np.random.default_rng(M * K_ + N)
    a = rng.integers(-128, 128, (M, K_)).astype(np.int8)
    b = rng.integers(-128, 128, (K_, N)).astype(np.int8)
    got = oz.int8_matmul(torch.tensor(a, device=card),
                         torch.tensor(b, device=card))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


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


@pytest.mark.parametrize('M,Kd,N', [(64, 64, 96), (129, 77, 301),
                                    (1000, 1000, 1000), (512, 1531, 200)])
def test_matmul_kernel_matches_plain_version(card, M, Kd, N):
    """K6 against the float64 product, for every operand layout: at most
    4x the plain version's error and 1e-5 max|ref|; one launch a call."""
    g = torch.Generator(device=card).manual_seed(M)
    K.reset_launches()
    calls = 0
    for ta in (False, True):
        for tb in (False, True):
            A = torch.randn((Kd, M) if ta else (M, Kd), device=card,
                            generator=g)
            B = torch.randn((N, Kd) if tb else (Kd, N), device=card,
                            generator=g)
            A, B = (A.T if ta else A), (B.T if tb else B)
            got = K.matmul(A, B)
            calls += 1
            ref = A.double() @ B.double()
            err = (got.double() - ref).abs().max().item()
            plain = (K.matmul_ref(A, B).double() - ref).abs().max().item()
            assert got.shape == (M, N) and got.dtype == torch.float32
            assert err <= 4 * plain and err <= 1e-5 * ref.abs().max().item()
    assert K.launches['matmul'] == calls
    with pytest.raises(TypeError):
        K.matmul(A.double(), B.double())


def test_gemm_dcts_on_card_match_cpu(card):
    from chsimpy_tpu_torch.ops import dct as D
    x = np.random.default_rng(5).random((256, 256))
    C = D.dct_matrix(256, torch.float32)
    X = K.dct2_gemm(torch.tensor(x, dtype=torch.float32, device=card),
                    C.to(card))
    ref = D.dct2(torch.tensor(x), D.dct_matrix(256))
    assert (X.cpu().double() - ref).abs().max().item() <= 1e-4
    back = K.idct2_gemm(X, C.to(card))
    assert (back.cpu().double() - torch.tensor(x)).abs().max().item() <= 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('route', ['split', 'fft'])
def test_route_transforms_on_card_match_cpu(card, route, dtype):
    """The split (permuted, levels 3) and FFT transforms on the card
    against the CPU: float64 within 1e-12, float32 within 2e-6 max|ref|
    (cuFFT and cuBLAS sum in other orders than the CPU libraries)."""
    from chsimpy_tpu_torch.ops import dct as D
    N = 256
    x = np.random.default_rng(6).random((N, N))
    if route == 'split':
        def run(u, dev):
            t = D.split_tree(N, 3, dtype, dev)
            y = D.dct2_split_perm(u, t)
            return y, D.idct2_split_perm(y, t)
    else:
        def run(u, dev):
            y = D.dct2_fft(u)
            return y, D.idct2_fft(y)
    gy, gb = run(torch.tensor(x, dtype=dtype, device=card), card)
    cy, cb = run(torch.tensor(x, dtype=dtype), 'cpu')
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert gy.is_contiguous() and gy.dtype == dtype
    assert (gy.cpu() - cy).abs().max().item() <= tol * cy.abs().max().item()
    assert (gb.cpu() - cb).abs().max().item() <= tol * N


@pytest.mark.parametrize('route', ['split', 'fft'])
def test_route_solve_on_card_matches_cpu(card, route):
    """float64 N=64 on the split and FFT routes, card against CPU: same
    steps, E within 1e-12; the GEMM and slice kernels stay idle."""
    K.reset_launches()
    g = _solve('cuda', transform_backend=route, split_levels=3
               if route == 'split' else None)
    assert K.launches['matmul'] == K.launches['slice_field'] == 0
    assert K.launches['chemical_potential'] == 119
    c = _solve('cpu', transform_backend=route, split_levels=3
               if route == 'split' else None)
    assert (g.computed_steps, g.stop_reason) == (c.computed_steps,
                                                 c.stop_reason)
    np.testing.assert_allclose(g.timedata.E, c.timedata.E, rtol=1e-12)
    np.testing.assert_allclose(g.U.cpu().numpy(), c.U.numpy(), rtol=0,
                               atol=1e-12)


def test_bakeoff_gemm_route_launches_the_kernel(card):
    """The bake-off's gemm route runs 4 GEMM launches per round trip and
    the tf32 route leaves the solver's TF32 switch off."""
    from chsimpy_tpu_torch.benchmarks import dct_bench
    fns = dct_bench._roundtrip_fns(128, 'float32', inner=3, device=card)
    x = torch.rand((128, 128), device=card)
    K.reset_launches()
    y = fns['gemm'](x)
    assert K.launches['matmul'] == 12
    assert (y - x).abs().max().item() < 1e-4
    fns['matmul-tf32'](x)
    assert not torch.backends.cuda.matmul.allow_tf32


# ----------------------------------------------------------------------
# the grid-sharded kernels (K7, K8) and a world of ranks on the card
# ----------------------------------------------------------------------

def _halo(F, i, j, bn, bw):
    """The edge vectors of block (i, j) of F, edge-replicated at the
    global boundary, as the halo exchange delivers them."""
    N = F.shape[0]
    r0, r1, c0, c1 = i * bn, (i + 1) * bn, j * bw, (j + 1) * bw
    return (F[max(r0 - 1, 0), c0:c1].contiguous(),
            F[min(r1, N - 1), c0:c1].contiguous(),
            F[r0:r1, max(c0 - 1, 0)].contiguous(),
            F[r0:r1, min(c1, N - 1)].contiguous())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,shape', [(256, (2, 2)), (256, (1, 4)),
                                     (256, (4, 1)), (96, (3, 2))])
def test_local_band_sums_kernel_matches_plain_version(card, dtype, N,
                                                       shape):
    mx, my = shape
    bn, bw = N // mx, N // my
    U = _field(N, dtype, card)
    E = K.chemical_potential_ref(U, PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                 PHYS['A1'])
    kw = dict(N=N, delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
              threshold=PHYS['threshold'])
    K.reset_launches()
    total = torch.zeros(5, dtype=torch.float64)
    for i in range(mx):
        for j in range(my):
            Ub = U[i * bn:(i + 1) * bn, j * bw:(j + 1) * bw].contiguous()
            Eb = E[i * bn:(i + 1) * bn, j * bw:(j + 1) * bw].contiguous()
            halo = _halo(U, i, j, bn, bw)
            for e in (Eb, None):
                args = (Ub, *halo, e, PHYS['A0'], PHYS['A1'], i * bn, j * bw)
                s = K.local_band_sums(*args, **kw).cpu()
                s_ref = K.local_band_sums_ref(*args, **kw).cpu()
                assert s[3] == s_ref[3]
                torch.testing.assert_close(s, s_ref, rtol=_tol(dtype),
                                           atol=0)
            total += K.local_band_sums(Ub, *halo, Eb, PHYS['A0'],
                                       PHYS['A1'], i * bn, j * bw,
                                       **kw).cpu()
    assert K.launches['local_band_sums'] == 3 * mx * my
    whole = K.stats_sums(U, E, PHYS['A0'], PHYS['A1'], **{
        k: v for k, v in kw.items() if k != 'N'}).cpu()
    torch.testing.assert_close(total, whole, rtol=1e-13, atol=0)


def _stats_kw(N):
    return dict(N=N, delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
                threshold=PHYS['threshold'])


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [1000, 1001, 512])
def test_local_band_sums_on_the_whole_field_gives_k3s_bits(card, dtype, N):
    """K7 with the whole field as its block (offsets 0, edge-replicated
    halos) runs K3's grid in K3's order: the same bits, with E and
    without; and the same bits in repeated calls."""
    U = _field(N, dtype, card)
    E = K.chemical_potential_ref(U, PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                 PHYS['A1'])
    kw = _stats_kw(N)
    halo = _halo(U, 0, 0, N, N)
    K.reset_launches()
    for e in (E, None):
        k7 = K.local_band_sums(U, *halo, e, PHYS['A0'], PHYS['A1'], 0, 0,
                               **kw)
        k3 = K.stats_sums(U, e, PHYS['A0'], PHYS['A1'], **{
            k: v for k, v in kw.items() if k != 'N'})
        assert torch.equal(k7, k3)
    assert K.launches['local_band_sums'] == 2
    first = K.local_band_sums(U, *halo, E, PHYS['A0'], PHYS['A1'], 0, 0,
                              **kw)
    for _ in range(10):
        assert torch.equal(K.local_band_sums(U, *halo, E, PHYS['A0'],
                                             PHYS['A1'], 0, 0, **kw), first)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_local_band_sums_one_column_path(card, dtype):
    """K7's V=1 instantiation: a block whose W no vector width divides,
    and an aligned block whose up row starts 8 bytes past a 16-byte
    boundary; both against the plain version."""
    N = 97
    U = _field(N, dtype, card)
    E = K.chemical_potential_ref(U, PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                 PHYS['A1'])
    kw = _stats_kw(N)
    cases = []
    # a 64x33 block at (0, 64): W = 33
    Ub = U[:64, 64:].contiguous()
    cases.append((Ub, (U[0, 64:].contiguous(), U[64, 64:].contiguous(),
                       U[:64, 63].contiguous(), U[:64, 96].contiguous()),
                  E[:64, 64:].contiguous(), 0, 64))
    # a 32x32 block at (32, 32) whose up row is an unaligned view
    Ub = U[32:64, 32:64].contiguous()
    store = torch.empty(33, dtype=dtype, device=card)
    up = store[1:]
    up.copy_(U[31, 32:64])
    assert K.local_stats_grid(32, 32, N, 32, 32, U.element_size(),
                              up.data_ptr())[0] == 1
    cases.append((Ub, (up, U[64, 32:64].contiguous(),
                       U[32:64, 31].contiguous(), U[32:64, 64].contiguous()),
                  E[32:64, 32:64].contiguous(), 32, 32))
    for Ub, halo, Eb, r0, c0 in cases:
        assert K.local_stats_grid(*Ub.shape, N, r0, c0, U.element_size(),
                                  *(t.data_ptr() for t in (Ub, *halo[:2],
                                                           Eb)))[0] == 1
        for e in (Eb, None):
            args = (Ub, *halo, e, PHYS['A0'], PHYS['A1'], r0, c0)
            s = K.local_band_sums(*args, **kw).cpu()
            s_ref = K.local_band_sums_ref(*args, **kw).cpu()
            assert s[3] == s_ref[3]
            torch.testing.assert_close(s, s_ref, rtol=_tol(dtype), atol=0)


def test_chemical_potential_sharded_is_k1_on_the_block(card):
    U = _field(512, torch.float64, card)
    Ub = U[256:, :256].contiguous()
    K.reset_launches()
    got = K.chemical_potential_sharded(None, Ub, PHYS['RT'], PHYS['BRT'],
                                       PHYS['A0'], PHYS['A1'])
    want = K.chemical_potential(Ub, PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                PHYS['A1'])
    assert torch.equal(got, want)
    assert (K.launches['chemical_potential_sharded'],
            K.launches['chemical_potential']) == (1, 1)


def test_sharded_solve_on_card_matches_cpu(card):
    """A 2x2 world of gloo ranks sharing the card against the
    single-device solve on the CPU."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    kw = dict(N=64, ntmax=40, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA)
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cuda',
                     args=([('solve', dict(params=kw))],), timeout=600)
    c = _solve('cpu', **kw)
    for (r,) in res:
        assert 'staged through host memory' in r['mesh']
        assert r['computed_steps'] == c.computed_steps
        np.testing.assert_allclose(r['timedata'][:, 1], c.timedata.E,
                                   rtol=1e-12)
        np.testing.assert_allclose(r['U'], c.U.numpy(), rtol=0, atol=1e-12)
        assert r['launches']['local_band_sums'] == 40
        assert r['launches']['chemical_potential_sharded'] == 39
        assert np.array_equal(r['timedata'], res[0][0]['timedata'])


# ----------------------------------------------------------------------
# the Sobol jitter (K9), adaptive time stepping and jitter on the card
# ----------------------------------------------------------------------

def _sobol_tables(N, device):
    from chsimpy_tpu_torch.ops import sobol
    sv, sh = sobol.sobol_tables(N, 2023)
    return (torch.tensor(sv.astype(np.int64), device=device),
            torch.tensor(sh.astype(np.int64), device=device))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 37, 1000])
@pytest.mark.parametrize('where', ['zero', 'one_draw', 'wrap'])
def test_sobol_jitter_kernel_matches_plain_version(card, dtype, N, where):
    """K9 against its plain version to the bit: the whole field and a
    block with offsets, at base 0, N and within N rows of 2^32."""
    base = {'zero': 0, 'one_draw': N, 'wrap': 2 ** 32 - N // 2}[where]
    sv, sh = _sobol_tables(N, card)
    b = torch.tensor(base, device=card)
    U = _field(N, dtype, card)
    K.reset_launches()
    got = K.sobol_jitter(U.clone(), sv, sh, b, 0.01)
    want = K.sobol_jitter_ref(U.clone(), sv, sh, b, 0.01)
    assert torch.equal(got, want)
    h = N // 2
    blk = U[h:, 3:h + 3].contiguous()
    got = K.sobol_jitter(blk.clone(), sv, sh, b, 0.01, h, 3)
    want = K.sobol_jitter_ref(blk.clone(), sv, sh, b, 0.01, h, 3)
    assert torch.equal(got, want)
    assert K.launches['sobol_jitter'] == 2


def test_sobol_device_jitter_equals_host_stream_on_the_card(card):
    """n64_sobol_jitter_100 on the card: the device backend (K9 on every
    step) gives the host stream's U and rows to the bit."""
    kw = dict(N=64, ntmax=100, full_sim=True, generator='sobol',
              jitter=0.01)
    host = _solve('cuda', **kw)
    K.reset_launches()
    dev = _solve('cuda', jitter_backend='device', **kw)
    assert K.launches['sobol_jitter'] == 99
    assert torch.equal(dev.U, host.U)
    assert np.array_equal(dev.timedata.data(), host.timedata.data())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 37, 1000])
def test_threefry_jitter_kernel_matches_plain_version(card, dtype, N):
    """K10 against its plain version to the bit: the whole field and a
    block with offsets; the next key, and the key kept where go is
    false."""
    from chsimpy_tpu_torch.core.state import jax_prng_key
    key = torch.tensor(jax_prng_key(2023).astype(np.int64), device=card)
    U = _field(N, dtype, card)
    K.reset_launches()
    out, ref = torch.empty_like(key), torch.empty_like(key)
    got = K.threefry_jitter(U.clone(), key, out, 0.01, N)
    want = K.threefry_jitter_ref(U.clone(), key, ref, 0.01, N)
    assert torch.equal(got, want) and torch.equal(out, ref)
    h = N // 2
    blk = U[h:, 3:h + 3].contiguous()
    stay = torch.tensor(False, device=card)
    got = K.threefry_jitter(blk.clone(), key, out, 0.01, N, h, 3, stay)
    want = K.threefry_jitter_ref(blk.clone(), key, ref, 0.01, N, h, 3, stay)
    assert torch.equal(got, want) and torch.equal(out, key)
    assert K.launches['threefry_jitter'] == 2


def test_device_jitter_solve_on_card_matches_cpu(card):
    """-j 0.01 --jitter-backend device, N=64 float64, 60 steps: K10 on
    every step; the same stream as the CPU (the key to the bit), E within
    1e-12 (float64 matmul orders differ)."""
    kw = dict(N=64, ntmax=60, full_sim=True, generator='uniform',
              jitter=0.01, jitter_backend='device')
    cpu = Simulator(Parameters(device='cpu', kappa_tilde=KAPPA,
                               no_gui=True, **kw))
    c = cpu.solve()
    K.reset_launches()
    sim = Simulator(Parameters(device='cuda', kappa_tilde=KAPPA,
                               no_gui=True, **kw))
    g = sim.solve()
    assert K.launches['threefry_jitter'] == 59
    assert torch.equal(sim.solver._state.rng_key.cpu(),
                       cpu.solver._state.rng_key)
    np.testing.assert_allclose(g.timedata.data()[:, 1],
                               c.timedata.data()[:, 1], rtol=1e-12)


def test_adaptive_solve_on_card_matches_cpu(card):
    """float64 N=64 with -a over 520 steps, card against CPU: delt and E
    in the chaotic golden's class (the coefficient rebuild divides by a
    scalar as a reciprocal product on the card)."""
    kw = dict(ntmax=520, full_sim=True, adaptive_time=True, chunk_size=128)
    g = _solve('cuda', **kw)
    c = _solve('cpu', **kw)
    np.testing.assert_allclose(g.timedata.delt, c.timedata.delt, rtol=1e-9)
    np.testing.assert_allclose(g.timedata.E, c.timedata.E, rtol=1e-10)
    assert g.timedata.delt[-1] != g.timedata.delt[0]


# ----------------------------------------------------------------------
# member-batched K1-K4 (the ensemble) and the ensemble's solve
# ----------------------------------------------------------------------

def _members(N, R, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    U = torch.tensor(0.875 + 0.01 * (rng.random((R, N, N)) - 0.5),
                     dtype=dtype, device=device)
    A0s = torch.tensor([PHYS['A0'] * (1 + 0.001 * r) for r in range(R)],
                       dtype=torch.float64, device=device)
    A1s = torch.tensor([PHYS['A1'] * (1 - 0.002 * r) for r in range(R)],
                       dtype=torch.float64, device=device)
    return U, A0s, A1s


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,R', [(64, 3), (1000, 2), (1001, 2), (33, 5)])
def test_member_kernels_give_single_launch_bits(card, dtype, N, R):
    """Member r of one batched launch = the single launch on field r with
    its scalars, to the bit; and the plain versions' tolerances."""
    p = PHYS
    U, A0s, A1s = _members(N, R, dtype, card)
    K.reset_launches()
    mu = K.chemical_potential_members(U, p['RT'], p['BRT'], A0s, A1s)
    rng = np.random.default_rng(2)
    hE = torch.tensor(rng.random((R, N, N)), dtype=dtype, device=card)
    S = torch.tensor(rng.random((N, N)), dtype=dtype, device=card)
    CH = torch.tensor(1 + rng.random((R, N, N)), dtype=dtype, device=card)
    upd = K.spectral_update_members(U, hE, S, CH)
    kw = dict(delx=p['delx'], RT=p['RT'], B=p['B'],
              threshold=p['threshold'])
    sums = K.stats_sums_members(U, mu, A0s, A1s, **kw)
    mean = (sums[:, 2] / (N * N)).to(dtype)
    ps = K.absdev_sum_members(U, mean)
    assert [K.launches[k] for k in (
        'chemical_potential_members', 'spectral_update_members',
        'stats_sums_members', 'absdev_sum_members')] == [1, 1, 1, 1]
    for r in range(R):
        a0, a1 = A0s[r].item(), A1s[r].item()
        assert torch.equal(mu[r], K.chemical_potential(
            U[r].contiguous(), p['RT'], p['BRT'], a0, a1))
        assert torch.equal(upd[r], K.spectral_update(
            U[r].contiguous(), hE[r].contiguous(), S, CH[r].contiguous()))
        assert torch.equal(sums[r], K.stats_sums(
            U[r].clone(), mu[r].clone(), a0, a1, **kw))
        assert torch.equal(ps[r], K.absdev_sum(U[r].clone(), mean[r]))
    ref = K.stats_sums_members_ref(U, mu, A0s, A1s, **kw)
    torch.testing.assert_close(sums, ref, rtol=_tol(dtype), atol=0)
    torch.testing.assert_close(ps, K.absdev_sum_members_ref(U, mean),
                               rtol=_tol(dtype), atol=0)
    torch.testing.assert_close(upd, K.spectral_update_members_ref(
        U, hE, S, CH), rtol=1e-12 if dtype == torch.float64 else 1e-6,
        atol=0)


@pytest.mark.parametrize('N,R', [(64, 3), (1000, 2), (1001, 3), (33, 5),
                                 (5, 2)])
def test_slice_members_kernel_gives_single_launch_bits(card, N, R):
    """K5_members: member r's planes and scale = the single K5 launch on
    field r and the plain version, to the bit (a member 1000x smaller,
    an all-zero one; odd N takes the scalar path); one count a call."""
    U = _members(N, R, torch.float64, card)[0]
    U[1] *= 1e-3
    U[-1] = 0.0
    K.reset_launches()
    for n in range(1, 9):
        got, scale = K.slice_field_members(U, n)
        want, wscale = K.slice_field_members_ref(U, n)
        assert got.shape == (n, R, N, N) and got.dtype == torch.int8
        assert torch.equal(got, want) and torch.equal(scale, wscale), n
        for r in range(R):
            s, sc = K.slice_field(U[r].clone(), n)
            assert torch.equal(got[:, r], s) and float(scale[r]) == float(sc)
    assert K.launches['slice_field_members'] == 8
    assert float(scale[-1]) == 2.0 ** -90 and not got[:, -1].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_stats_members_at_the_canonical_batch_give_single_launch_bits(
        card, dtype):
    """K3_members at R=16 N=512 (the canonical UQ batch) on the refined
    tile: member r = the single K3 on field r to the bit, the plain
    version's tolerances, the same bits in repeated calls; K7 on the
    whole field = K3."""
    N, R = 512, 16
    p = PHYS
    U, A0s, A1s = _members(N, R, dtype, card, seed=16)
    E = K.chemical_potential_members(U, p['RT'], p['BRT'], A0s, A1s)
    kw = dict(delx=p['delx'], RT=p['RT'], B=p['B'],
              threshold=p['threshold'])
    tile = K.stats_tile(N, N, N, 0, 0, U.element_size(), U.data_ptr(),
                        E.data_ptr())
    fixed = K.fixed_stats_tile(N, N, U.element_size(), U.data_ptr(),
                               E.data_ptr())
    assert tile[2] > fixed[2]
    assert tile[2] >= K.STATS_MIN_BLOCKS or tile[1] == K.STATS_MIN_BAND
    K.reset_launches()
    sums = K.stats_sums_members(U, E, A0s, A1s, **kw)
    assert K.launches['stats_sums_members'] == 1
    for _ in range(5):
        assert torch.equal(K.stats_sums_members(U, E, A0s, A1s, **kw), sums)
    for r in range(R):
        a0, a1 = A0s[r].item(), A1s[r].item()
        single = K.stats_sums(U[r].clone(), E[r].clone(), a0, a1, **kw)
        assert torch.equal(sums[r], single), r
        k7 = K.local_band_sums(U[r].clone(), *_halo(U[r], 0, 0, N, N),
                               E[r].clone(), a0, a1, 0, 0, N=N, **kw)
        assert torch.equal(k7, single), r
    ref = K.stats_sums_members_ref(U, E, A0s, A1s, **kw)
    assert torch.equal(sums[:, 3], ref[:, 3])
    torch.testing.assert_close(sums, ref, rtol=_tol(dtype), atol=0)


def _bits(t):
    return t.reshape(-1).view(torch.int64)


@pytest.mark.parametrize('kind', ['solver', 'nan', 'ulp'])
@pytest.mark.parametrize('N,R', [(512, 16), (512, 1), (33, 3), (1000, 2)])
def test_slice_one_launch_path_gives_the_plain_bits(card, N, R, kind):
    """K5_members' one-launch path (and K5's at R=1): planes and scales
    = the plain version's and the two launches', to the bit (a NaN
    member's NaN scale too), member r = the single K5; one count a call,
    taken by the one-launch path; the same bits again (the scratch is
    back to 0)."""
    assert K.slice_one_launch(R, N * N)
    U = _members(N, R, torch.float64, card, seed=N + R)[0]
    if R > 1:
        U[1] *= 1e-3
    if kind == 'nan':
        U[0, N // 2, N // 3] = float('nan')
    elif kind == 'ulp':
        U[-1, N // 3, N // 2] = -np.nextafter(2.0 ** 8, np.inf)
    for n in (4, 6):
        K.reset_launches()
        got, scale = K.slice_field_members(U, n)
        assert K.launches['slice_field_members'] == 1
        assert K.one_launch['slice_field_members'] == 1
        want, wscale = K.slice_field_members_ref(U, n)
        two, tscale = K._slice_members_two_launches(U, n)
        assert torch.equal(got, want) and torch.equal(got, two)
        assert torch.equal(_bits(scale), _bits(wscale))
        assert torch.equal(_bits(scale), _bits(tscale))
        for r in range(R):
            s, sc = K.slice_field(U[r].clone(), n)
            assert torch.equal(got[:, r], s)
            assert torch.equal(_bits(scale[r]), _bits(sc))
        again, ascale = K.slice_field_members(U, n)
        assert torch.equal(again, got)
        assert torch.equal(_bits(ascale), _bits(scale))
    assert K.one_launch['slice_field'] == R


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,R,bn,bw', [(64, 3, 32, 32), (1000, 2, 500, 250),
                                       (66, 3, 33, 22)])
def test_local_members_kernel_gives_single_launch_bits(card, dtype, N, R,
                                                       bn, bw):
    """K7_members: member r of one launch = the single K7 launch on its
    block, halo and scalars, to the bit (an odd block takes the one-column
    path); the plain version's tolerances; one count a call."""
    p = PHYS
    F, A0s, A1s = _members(N, R, dtype, card)
    E = F * 0.5
    for i, j in ((0, 0), (1, 1)):
        r0, c0 = i * bn, j * bw
        sl = (slice(None), slice(r0, r0 + bn), slice(c0, c0 + bw))
        Ub, Eb = F[sl].contiguous(), E[sl].contiguous()
        halo = (F[:, max(r0 - 1, 0), c0:c0 + bw].contiguous(),
                F[:, min(r0 + bn, N - 1), c0:c0 + bw].contiguous(),
                F[:, r0:r0 + bn, max(c0 - 1, 0)].contiguous(),
                F[:, r0:r0 + bn, min(c0 + bw, N - 1)].contiguous())
        kw = dict(N=N, delx=p['delx'], RT=p['RT'], B=p['B'],
                  threshold=p['threshold'])
        K.reset_launches()
        got = K.local_band_sums_members(Ub, *halo, Eb, A0s, A1s, r0, c0,
                                        **kw)
        assert K.launches['local_band_sums_members'] == 1
        for r in range(R):
            one = K.local_band_sums(Ub[r].clone(), *(h[r].clone()
                                                     for h in halo),
                                    Eb[r].clone(), A0s[r].item(),
                                    A1s[r].item(), r0, c0, **kw)
            assert torch.equal(got[r], one)
        ref = K.local_band_sums_members_ref(Ub, *halo, Eb, A0s, A1s, r0,
                                            c0, **kw)
        torch.testing.assert_close(got, ref, rtol=_tol(dtype), atol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,R', [(64, 3), (1000, 5), (33, 16)])
def test_row_absdev_kernel_is_the_same_for_any_member_count(card, dtype, N,
                                                            R):
    """K11: each member's Ra within the plain version's tolerance, and
    the same bits in a launch of R members as in its launch alone."""
    U = _members(N, R, dtype, card)[0]
    K.reset_launches()
    got = K.row_absdev_members(U, N // 2 + 1)
    assert K.launches['row_absdev_members'] == 1
    for r in range(R):
        assert torch.equal(got[r:r + 1],
                           K.row_absdev_members(U[r:r + 1], N // 2 + 1))
    torch.testing.assert_close(got, K.row_absdev_members_ref(U, N // 2 + 1),
                               rtol=_tol(dtype), atol=0)


def test_nccl_refuses_two_processes_on_one_card(card):
    """A coordinator's processes bind card process_id modulo the cards;
    with more processes than cards NCCL raises naming the backend before
    any process group forms (no switch to gloo)."""
    from chsimpy_tpu_torch.parallel import distributed
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match='nccl takes one card per rank'):
        distributed.initialize('nccl', 'cuda',
                               coordinator_address='127.0.0.1:1',
                               num_processes=n, process_id=0)


def test_member_wrappers_refuse_what_the_kernels_do_not_take(card):
    U, A0s, A1s = _members(16, 2, torch.float64, card)
    with pytest.raises(ValueError, match='A0s'):
        K.chemical_potential_members(U, 1.0, 1.0, A0s.cpu(), A1s)
    with pytest.raises(ValueError, match='contiguous'):
        K.chemical_potential_members(U, 1.0, 1.0, A0s, A1s.repeat(2)[::2])
    with pytest.raises(ValueError, match='contiguous'):
        K.absdev_sum_members(U.transpose(1, 2), U.mean((1, 2)))


@pytest.mark.parametrize('transform', ['matmul', 'split', 'fft', 'ozaki'])
def test_ensemble_on_card_matches_single_runs(card, transform):
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    pairs = np.array([[PHYS['A0'] * f, PHYS['A1'] / f]
                      for f in (1.0, 1.004, 0.996)])
    kw = dict(N=64, ntmax=40, full_sim=True, generator='uniform',
              kappa_tilde=KAPPA, no_gui=True, transform_backend=transform)
    K.reset_launches()
    ens = EnsembleSolver(Parameters(device='cuda', **kw), pairs)
    ens.prepare()
    sols = ens.solve_or_resume(40)
    assert K.launches['chemical_potential_members'] == 39
    assert K.launches['stats_sums_members'] == 40
    # the ozaki route (level-1 fold): K5_members twice at entry and three
    # times a step, the single-field K5 never
    assert K.launches['slice_field_members'] == \
        (2 + 3 * 39 if transform == 'ozaki' else 0)
    assert K.launches['slice_field'] == 0
    for (A0, A1), s in zip(pairs, sols):
        ref = Simulator(Parameters(device='cuda', A0_const=float(A0),
                                   A1_const=float(A1), **kw)).solve()
        assert s.computed_steps == ref.computed_steps
        np.testing.assert_allclose(s.timedata.data()[:, 1],
                                   ref.timedata.data()[:, 1], rtol=1e-12)


# ----------------------------------------------------------------------
# the pencil layout: K5 sharded, and a pencil world of ranks on the card
# ----------------------------------------------------------------------

@pytest.mark.parametrize('layout', ['field', 'spec'])
@pytest.mark.parametrize('N,D,R', [(64, 4, 0), (1000, 4, 0), (64, 4, 3),
                                   (40, 2, 2)])
def test_slice_sharded_kernel_gives_whole_field_bits(card, layout, N, D, R):
    """K5 sharded's two launches with the max of the blocks' words taken
    on the card (the world max of D ranks): each block's planes are K5's
    on the whole field restricted to the block, the scale the whole
    field's, to the bit; the max one ulp above 2^8 in one block only."""
    rng = np.random.default_rng(N + D + R)
    x = rng.standard_normal((max(R, 1), N, N))
    x[-1, N // 3, N // D + 1] = -np.nextafter(256.0, np.inf)
    if layout == 'spec':
        x = x.transpose(0, 2, 1).copy()
    t = torch.tensor(x if R else x[0], device=card)
    whole, wscale = (K.slice_field_members(t, 6) if R
                     else K.slice_field(t, 6))
    c = N // D
    blocks = [(t[..., :, j * c:(j + 1) * c] if layout == 'field'
               else t[..., j * c:(j + 1) * c, :]).contiguous()
              for j in range(D)]
    bits = torch.stack([K._slice_max_launch(b, max(R, 1)) for b in blocks])
    world = bits.amax(dim=0)
    for j, b in enumerate(blocks):
        planes, scale = K._slice_sharded_planes_launch(
            b, world.view(torch.float64), max(R, 1), 6)
        want = (whole[..., :, j * c:(j + 1) * c] if layout == 'field'
                else whole[..., j * c:(j + 1) * c, :])
        assert torch.equal(planes, want)
        assert torch.equal(scale.reshape(wscale.shape), wscale)


def test_pencil_world_on_card_matches_cpu(card):
    """A 2x2 pencil world of gloo ranks sharing the card, split and ozaki,
    and split with the host stream, K9 and K10 jitter on the column
    blocks, against the same world on the CPU; K5 sharded once per
    transform on ozaki, K9 and K10 once a step."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    kw = dict(N=64, ntmax=30, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA)
    jitter = [dict(generator='uniform', jitter=0.01),
              dict(generator='sobol', jitter=0.01, jitter_backend='device'),
              dict(generator='uniform', jitter=0.01,
                   jitter_backend='device')]
    tasks = [('solve', dict(params=dict(kw, transform_backend=t)))
             for t in ('split', 'ozaki')] + [
        ('solve', dict(params=dict(kw, transform_backend='split', **j)))
        for j in jitter]
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cuda',
                     args=(tasks,), timeout=600)
    cpu = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=([(n, dict(params=dict(k['params'], device='cpu')))
                            for n, k in tasks],), timeout=600)
    for r in res:
        for i in range(len(tasks)):
            assert r[i]['pencil']
            assert np.array_equal(r[i]['timedata'], res[0][i]['timedata'])
            np.testing.assert_allclose(r[i]['timedata'][:, 1],
                                       cpu[0][i]['timedata'][:, 1],
                                       rtol=1e-12)
            np.testing.assert_allclose(r[i]['U'], cpu[0][i]['U'], rtol=0,
                                       atol=1e-12)
        assert r[1]['launches']['slice_field_sharded'] == 1 + 2 * 29
        assert r[1]['launches']['slice_field'] == 0
        assert r[3]['launches']['sobol_jitter'] == 29
        assert r[4]['launches']['threefry_jitter'] == 29


# ----------------------------------------------------------------------
# the grid layout where the rank count does not divide N: the block
# kernels at block sides that are no multiple of 8, the grid ozaki
# route's int8 products, a grid ozaki world, the dry run
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,shape', [(40, (2, 2)), (36, (2, 4)),
                                     (34, (2, 2)), (1002, (2, 2)),
                                     (4094, (2, 2))])
def test_block_kernels_at_grid_shapes_off_the_tile(card, dtype, N, shape):
    """K7 (with its halo), K8, K2 and K4 on every block of a grid whose
    block sides are no multiple of 8 (20, 18 x 9, 17, 501, 2047) against
    their plain versions; K8 gives K1's bits on the block; the blocks'
    K7 sums in rank order are K3's on the whole field."""
    mx, my = shape
    bn, bw = N // mx, N // my
    U = _field(N, dtype, card)
    E = K.chemical_potential_ref(U, PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                 PHYS['A1'])
    rng = np.random.default_rng(N)
    X = [torch.tensor(rng.standard_normal((N, N)), dtype=dtype, device=card)
         for _ in range(2)] + [
        torch.tensor(1.0 + rng.random((N, N)), dtype=dtype, device=card)
        for _ in range(2)]
    kw = _stats_kw(N)
    mean = (U.double().sum() / (N * N)).to(dtype)
    total = torch.zeros(5, dtype=torch.float64)
    for i in range(mx):
        for j in range(my):
            blk = (slice(i * bn, (i + 1) * bn), slice(j * bw, (j + 1) * bw))
            Ub, Eb = U[blk].contiguous(), E[blk].contiguous()
            args = (Ub, *_halo(U, i, j, bn, bw), Eb, PHYS['A0'],
                    PHYS['A1'], i * bn, j * bw)
            s = K.local_band_sums(*args, **kw).cpu()
            s_ref = K.local_band_sums_ref(*args, **kw).cpu()
            assert s[3] == s_ref[3]
            torch.testing.assert_close(s, s_ref, rtol=_tol(dtype), atol=0)
            total += s
            b8 = K.chemical_potential_sharded(None, Ub, PHYS['RT'],
                                              PHYS['BRT'], PHYS['A0'],
                                              PHYS['A1'])
            assert torch.equal(b8, K.chemical_potential(
                Ub, PHYS['RT'], PHYS['BRT'], PHYS['A0'], PHYS['A1']))
            torch.testing.assert_close(b8, Eb, rtol=_tol(dtype), atol=0)
            torch.testing.assert_close(
                K.absdev_sum(Ub, mean), K.absdev_sum_ref(Ub, mean),
                rtol=_tol(dtype), atol=0)
            Xb = [x[blk].contiguous() for x in X]
            torch.testing.assert_close(K.spectral_update(*Xb),
                                       K.spectral_update_ref(*Xb),
                                       rtol=_tol(dtype), atol=0)
    whole = K.stats_sums(U, E, PHYS['A0'], PHYS['A1'], **{
        k: v for k, v in kw.items() if k != 'N'}).cpu()
    torch.testing.assert_close(total, whole, rtol=1e-12, atol=0)


@pytest.mark.parametrize('M,Kd,N', [(2047, 4094, 2047), (2047, 3 * 4094, 2047),
                                    (4094, 4094, 2047), (501, 2 * 1002, 501),
                                    (1002, 1002, 501), (17, 34, 17),
                                    (17, 2 * 34, 34), (18, 36, 9)])
def test_int8_matmul_exact_at_the_grid_ozaki_shapes(card, M, Kd, N):
    """The grid ozaki route's products: a rank's rows of C against a
    gathered column strip (inner N, or a slice group's n*N), and the
    renormalized row strip against C's columns; 2047, 501 and 17 rows
    and columns, which cuBLASLt may refuse unpadded."""
    g = torch.Generator().manual_seed(M + Kd + N)
    a = torch.randint(-64, 65, (M, Kd), generator=g, dtype=torch.int8)
    b = torch.randint(-64, 65, (Kd, N), generator=g, dtype=torch.int8)
    got = oz.int8_matmul(a.to(card), b.to(card)).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got, (a.double() @ b.double()).to(torch.int32))


def test_grid_ozaki_world_on_card_matches_cpu(card):
    """A 2x2 grid world of gloo ranks sharing the card at N=34 (4 does not
    divide it): the grid ozaki transforms, each rank's block the
    one-device unfolded transform's to the bit given the world's mean,
    and a solve against the same world on the CPU; K5 sharded on the
    forward's column strip and the inverse's block, never K5."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    N, steps = 34, 20
    x = 0.8 + 0.3 * np.random.default_rng(N).standard_normal((N, N))
    kw = dict(N=N, ntmax=steps, full_sim=True, generator='lcg',
              kappa_tilde=KAPPA, transform_backend='ozaki')
    tasks = [('ozaki_grid', dict(x=x)), ('solve', dict(params=kw))]
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cuda',
                     args=(tasks,), timeout=600)
    cpu = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=([tasks[0], ('solve', dict(params=dict(
                         kw, device='cpu')))],), timeout=600)
    got = res[0][0]
    U = torch.tensor(x, device=card)
    m = torch.tensor(got['mean'], device=card)
    Cs, CsT, sc = oz.dct_slices(N, card)
    want = oz._transform2d(U - m, Cs, CsT, sc, s1=3, s2=5)
    want[0, 0] += m * N
    assert np.array_equal(got['dct2'], want.cpu().numpy())
    assert np.array_equal(got['idct2'],
                          oz.idct2_ozaki(U, Cs, CsT, sc).cpu().numpy())
    np.testing.assert_allclose(got['mean'], cpu[0][0]['mean'], rtol=1e-15)
    for r in res:
        s = r[1]
        assert not s['pencil'] and s['block_shapes']['U'] == (17, 17)
        assert np.array_equal(s['timedata'], res[0][1]['timedata'])
        np.testing.assert_allclose(s['timedata'][:, 1],
                                   cpu[0][1]['timedata'][:, 1], rtol=1e-12)
        np.testing.assert_allclose(s['U'], cpu[0][1]['U'], rtol=0,
                                   atol=1e-12)
        assert s['launches']['slice_field_sharded'] == 1 + 2 * (steps - 1)
        assert s['launches']['slice_field'] == 0


def test_dryrun_on_four_ranks_sharing_the_card(card):
    """``parallel/dryrun.py`` on 4 gloo ranks sharing the card: stage 1
    on an ('ens' 2, 1, 2) mesh, the flagship routes on 2x2 across the
    energy stop at 534, ens-only."""
    from chsimpy_tpu_torch.parallel.dryrun import dryrun_multichip
    lines = dryrun_multichip(4, device='cuda', backend='gloo', timeout=900)
    assert lines[0].startswith('dryrun stage 1 ok')
    assert sum('PASS (mesh (2, 2)' in ln for ln in lines) == 4
    assert lines[-1].startswith('ens-only f64: PASS (ens=4')


# ----------------------------------------------------------------------
# the float32 knobs: K12, K3's fold mode, K6's member axis and the solve
# at each precision
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 1000, 1001])
def test_update_otf_kernel_matches_plain_version(card, dtype, N):
    """K12 and K12_members give their plain versions' bits (the plain
    versions divide by delx2 as a tensor: PyTorch would take a Python
    number's reciprocal), on the field, a block and each member."""
    from chsimpy_tpu_torch.ops.coeffs import eigenvalue_axis
    g = torch.Generator(device=card).manual_seed(N)
    e = torch.tensor(eigenvalue_axis(N), dtype=dtype, device=card)
    hU = torch.randn((N, N), dtype=dtype, device=card, generator=g)
    hE = torch.randn((N, N), dtype=dtype, device=card, generator=g)
    delt = torch.tensor(3e-8, dtype=torch.float64, device=card)
    args = (e, delt, KAPPA, 1.6e-5)
    K.reset_launches()
    got = K.update_otf(hU, hE, *args)
    assert torch.equal(got, K.update_otf_ref(hU, hE, *args))
    h = N // 2
    assert torch.equal(K.update_otf(hU[h:, :h].contiguous(),
                                    hE[h:, :h].contiguous(), *args, h, 0),
                       got[h:, :h])
    kap = KAPPA * (1 + 0.01 * torch.arange(3, dtype=torch.float64,
                                           device=card))
    dts = 3e-8 * (1 + 0.02 * torch.arange(3, dtype=torch.float64,
                                          device=card))
    st = torch.stack([hU, hE, hU + hE])
    m = K.update_otf_members(st, st.flip(0), e, dts, kap, 1.6e-5)
    assert torch.equal(m, K.update_otf_ref(st, st.flip(0), e, dts, kap,
                                           1.6e-5))
    for r in range(3):
        assert torch.equal(m[r], K.update_otf(st[r], st.flip(0)[r], e,
                                              dts[r], kap[r].item(), 1.6e-5))
    assert K.launches['update_otf'] == 5
    assert K.launches['update_otf_members'] == 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 1000, 1002])
def test_stats_fold_mode_is_natural_k3(card, dtype, N):
    """K3's fold mode on the folded field: K3's tolerances against its
    plain version, the count exact, and K3's bits on the natural field
    where the fold keeps K3's vector width."""
    from chsimpy_tpu_torch.ops.dct import fold1
    p = PHYS
    U = _field(N, dtype, card)
    E = K.chemical_potential(U, p['RT'], p['BRT'], p['A0'], p['A1'])
    skw = dict(delx=p['delx'], RT=p['RT'], B=p['B'],
               threshold=p['threshold'])
    V, EV = fold1(U), fold1(E)
    got = K.stats_sums(V, EV, p['A0'], p['A1'], fold=True, **skw)
    want = K.stats_sums_ref(V, EV, p['A0'], p['A1'], fold=True, **skw)
    assert bool(((got - want).abs() <= _tol(dtype) * want.abs()).all())
    assert got[3].item() == want[3].item()
    same = K.stats_grid(N, U.element_size(), U.data_ptr(), E.data_ptr()) \
        == K.stats_grid(N, V.element_size(), V.data_ptr(), EV.data_ptr(),
                        fold=True)
    if same:
        assert torch.equal(got, K.stats_sums(U, E, p['A0'], p['A1'], **skw))
    a0 = torch.full((2,), p['A0'], dtype=torch.float64, device=card)
    a1 = torch.full((2,), p['A1'], dtype=torch.float64, device=card)
    Us, Es = torch.stack([U, U]), torch.stack([E, 2 * E])
    mgot = K.stats_sums_members(fold1(Us), fold1(Es), a0, a1, fold=True,
                                **skw)
    assert torch.equal(mgot[0], got)


def test_matmul_kernel_member_axis(card):
    """K6 over a member axis (either operand, or both; a shared operand
    stride 0): each member the one launch's bits on it."""
    g = torch.Generator(device=card).manual_seed(9)
    A = torch.randn((3, 200, 130), device=card, generator=g)
    B = torch.randn((130, 70), device=card, generator=g)
    C = torch.randn((3, 130, 70), device=card, generator=g)
    for a, b in ((A, B), (B.T, C), (A, C),
                 (A.transpose(-1, -2).contiguous().transpose(-1, -2), C)):
        got = K.matmul(a, b)
        for r in range(got.shape[0]):
            ar = a[r] if a.dim() == 3 else a
            br = b[r] if b.dim() == 3 else b
            assert torch.equal(got[r], K.matmul(ar, br))
        ref = torch.matmul(a.double(), b.double())
        plain = (K.matmul_ref(a, b).double() - ref).abs().max().item()
        err = (got.double() - ref).abs().max().item()
        assert err <= 4 * plain and err <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize('route', ['matmul', 'split'])
@pytest.mark.parametrize('knobs', [
    {'matmul_precision': 'high'},
    {'matmul_precision': 'default'},
    {'fwd_matmul_precision': 'default', 'inv_band': 16, 'otf_coeffs': 1},
], ids=['high', 'default', 'fwd-band-otf'])
def test_knob_solve_on_card_matches_cpu(card, route, knobs):
    """A float32 run under the knobs on the card against the same run on
    the CPU (where 'high' is the float32 product and 'default' rounds the
    operands to TF32): E within the float32 class, 1e-5."""
    out = {}
    for dev in ('cpu', 'cuda'):
        p = Parameters(N=64, ntmax=60, full_sim=True, no_gui=True,
                       precision='float32', kappa_tilde=KAPPA,
                       transform_backend=route, device=dev, **knobs)
        s = Simulator(p)
        K.reset_launches()
        out[dev] = np.asarray(s.solve().timedata.E)
        if dev == 'cuda' and 'high' in knobs.values():
            assert K.launches['matmul'] >= 59
        if dev == 'cuda' and knobs.get('otf_coeffs'):
            assert K.launches['update_otf'] >= 59
    assert np.max(np.abs(out['cuda'] / out['cpu'] - 1)) <= 1e-5


def test_folded_solve_on_card_is_the_natural_solve(card):
    """--fold-field on the card at pinned split levels: U the natural
    run's to the bit, E and E2 too (K3's fold mode)."""
    out = {}
    for fold in (False, True):
        p = Parameters(N=256, ntmax=80, full_sim=True, no_gui=True,
                       precision='float32', kappa_tilde=KAPPA,
                       transform_backend='split', split_levels=3,
                       fold_field=fold, device='cuda')
        sol = Simulator(p).solve()
        out[fold] = (sol.U, sol.timedata.data())
    assert torch.equal(out[True][0], out[False][0])
    assert np.array_equal(out[True][1][:, 1:3], out[False][1][:, 1:3])


# ----------------------------------------------------------------------
# the statistics kernel's body against its parent body, K11 in K4's
# second pass, the body's division by the constants, the CUDA graph
# ----------------------------------------------------------------------

def _stats_case(kind, N, dtype, card, delx=PHYS['delx']):
    """(body, parent body) of one statistics launch on the card: K3 on
    the field, K3's fold mode on the folded field, K7 on block (1, 0) of
    a 2x2 mesh, K3_members and K7_members (R=3)."""
    from chsimpy_tpu_torch.ops import dct as dct_ops
    kw = dict(delx=delx, RT=PHYS['RT'], B=PHYS['B'],
              threshold=PHYS['threshold'])
    A0, A1 = PHYS['A0'], PHYS['A1']
    U = _field(N, dtype, card, seed=N)
    E = K.chemical_potential_ref(U, PHYS['RT'], PHYS['BRT'], A0, A1)
    if kind in ('K3', 'fold'):
        fold = kind == 'fold'
        if fold:
            U, E = dct_ops.fold1(U), dct_ops.fold1(E)
        tile = K.stats_tile(N, N, N, 0, 0, U.element_size(), U.data_ptr(),
                            E.data_ptr(), fold=fold)
        return (lambda: K.stats_sums(U, E, A0, A1, fold=fold, **kw),
                lambda: K._stats_sums_launch(U, E, A0, A1, tile, fold=fold,
                                             prev=True, **kw))
    R = 3
    Us = torch.stack([U, 1.0 - 0.5 * U, U * 0.999])
    Es = torch.stack([E, 2.0 * E, E])
    a0 = torch.full((R,), A0, dtype=torch.float64, device=card)
    a1 = torch.full((R,), A1, dtype=torch.float64, device=card)
    if kind == 'K3_members':
        tile = K.stats_tile(N, N, N, 0, 0, U.element_size(), Us.data_ptr(),
                            Es.data_ptr())
        return (lambda: K.stats_sums_members(Us, Es, a0, a1, **kw),
                lambda: K._stats_sums_members_launch(Us, Es, a0, a1, tile,
                                                     prev=True, **kw))
    bn = N // 2
    r0, c0 = bn, 0
    blk = (slice(None), slice(r0, r0 + bn), slice(c0, c0 + bn))
    halo = (Us[:, r0 - 1, :bn], Us[:, min(r0 + bn, N - 1), :bn],
            Us[:, r0:r0 + bn, 0], Us[:, r0:r0 + bn, bn])
    halo = tuple(h.contiguous() for h in halo)
    Ub, Eb = Us[blk].contiguous(), Es[blk].contiguous()
    tile = K.stats_tile(bn, bn, N, r0, c0, U.element_size(),
                        *(t.data_ptr() for t in (Ub, *halo[:2], Eb)))
    if kind == 'K7':
        one = (Ub[0], *(h[0] for h in halo), Eb[0], A0, A1, r0, c0)
        return (lambda: K.local_band_sums(*one, N=N, **kw),
                lambda: K._local_band_sums_launch(*one, tile, N=N,
                                                  prev=True, **kw))
    args = (Ub, *halo, Eb, a0, a1, r0, c0)
    return (lambda: K.local_band_sums_members(*args, N=N, **kw),
            lambda: K._local_band_sums_members_launch(*args, tile, N=N,
                                                      prev=True, **kw))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 66, 1000, 1001])
@pytest.mark.parametrize('kind', ['K3', 'fold', 'K7', 'K3_members',
                                  'K7_members'])
def test_stats_body_gives_the_parent_body_bits(card, kind, N, dtype):
    """The body (edges out of the interior, cdiv for the divisions by h
    and 2h) against the parent body on the same launch: the five sums of
    every form to the bit (the fold of an odd N/2: its one-column
    grid)."""
    if kind == 'fold' and N % 2:
        pytest.skip('the fold needs an even N')
    body, parent = _stats_case(kind, N, dtype, card)
    assert torch.equal(body().view(torch.int64),
                       parent().view(torch.int64))


@pytest.mark.parametrize('dtype,delx', [(torch.float32, 2.0),
                                        (torch.float32, 3.0),
                                        (torch.float64, 2.0 ** -30),
                                        (torch.float64, 2.0 ** 30 + 1)])
@pytest.mark.parametrize('kind', ['K3', 'fold', 'K7', 'K3_members',
                                  'K7_members'])
def test_stats_body_outside_cdiv_range_gives_the_parent_body_bits(
        card, kind, dtype, delx):
    """An h outside cdiv's range (h >= 2 in float32, outside [2^-29,
    2^29] in float64): the body takes the true division, the parent
    body's bits."""
    body, parent = _stats_case(kind, 66, dtype, card, delx=delx)
    assert torch.equal(body().view(torch.int64),
                       parent().view(torch.int64))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('R,N', [(1, 64), (3, 1000), (16, 512)])
def test_fused_ra_pass_is_k4_and_k11_on_the_card(card, R, N, dtype):
    """K4_members with Ra in its second pass: the sums and Ra of
    K4_members and K11 launched apart, to the bit, with the natural row
    and a (R, 1, N) stack of mid rows; one count, as K4_members."""
    g = torch.Generator(device=card).manual_seed(R + N)
    U = 0.875 + 0.01 * torch.rand((R, N, N), generator=g, dtype=dtype,
                                  device=card)
    mean = (U.double().sum((1, 2)) / (N * N)).to(dtype)
    mid = U[:, N // 2 + 1].contiguous().unsqueeze(1)
    for rows, row in ((U, N // 2 + 1), (mid, 0)):
        K.reset_launches()
        ps, ra = K.absdev_ra_members(U, mean, rows, row)
        assert K.launches['absdev_sum_members'] == 1
        assert K.launches['row_absdev_members'] == 0
        assert torch.equal(ps, K.absdev_sum_members(U, mean))
        assert torch.equal(ra, K.row_absdev_members(rows, row))
        ref_ps, ref_ra = K.absdev_ra_members_ref(U, mean, rows, row)
        torch.testing.assert_close(ps, ref_ps, rtol=_tol(dtype), atol=0)
        torch.testing.assert_close(ra, ref_ra, rtol=_tol(dtype), atol=0)


@pytest.mark.parametrize('N', [512, 1024, 4096])
def test_cdiv_gives_the_true_quotient_on_the_card(card, N):
    """The body's division by h and 2h: float32 on every finite float,
    float64 on 1e8 draws and the edges; no bit differs."""
    delx = Derived.from_params(Parameters(N=N, kappa_tilde=KAPPA)).delx
    r32 = K.cdiv_check(delx, torch.float32)
    assert r32['checked'] == 2 ** 32 - 2 ** 24
    r64 = K.cdiv_check(delx, torch.float64, n=100_000_000, seed=N,
                       edges=[0.0, -0.0, 5e-324, 2.0 ** -900, 2.0 ** 901,
                              1.7976931348623157e308, delx])
    assert r64['checked'] > 99_000_000
    assert (r32['h'], r32['h2'], r64['h'], r64['h2']) == (0, 0, 0, 0)


def _graph_solver(p):
    """A Solver whose chunks replay each STOP_POLL steps as a ChunkGraph."""
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.core.stepper import (STOP_POLL, ChunkGraph,
                                                run_chunk)

    class GraphSolver(Solver):
        graph = None

        def _run_chunk(self, state, k):
            if self.graph is None and k >= STOP_POLL:
                self.graph = ChunkGraph(self.cfg, self._consts, state)
            return run_chunk(self.cfg, self._consts, state, k,
                             graph=self.graph)
    return GraphSolver(p)


def _graph_case_params(transform):
    return Parameters(N=64, ntmax=300, kappa_tilde=KAPPA, no_gui=True,
                      device='cuda', transform_backend=transform,
                      chunk_size=100)


@pytest.mark.parametrize('transform', ['matmul', 'ozaki'])
def test_cuda_graph_run_is_the_eager_run(card, transform):
    """A ChunkGraph replays STOP_POLL steps a graph: the rows, the stop
    and the field of the eager run, to the bit."""
    from chsimpy_tpu_torch.core.solver import Solver
    sols = []
    for make in (Solver, _graph_solver):
        s = make(_graph_case_params(transform))
        s.prepare()
        sols.append(s.solve_or_resume())
    a, b = sols
    assert a.computed_steps == b.computed_steps == 300
    assert np.array_equal(a.timedata.data(), b.timedata.data())
    assert torch.equal(a.U, b.U)


def test_concurrent_cuda_graph_runs_share_no_scratch(card):
    """24 graph runs in threads side by side, each on a stream of its own
    and capturing there; then 40 more pooled streams (past the 32 that
    torch hands out round-robin, so the runs' handles come back) each
    take larger tickets and one-launch scratch, replacing and freeing the
    buffers keyed by their handles, and fill the freed memory; then the
    24 runs go on, replaying their graphs side by side.  Each graph holds
    its own tickets and scratch: every run gives the eager run's rows and
    field to the bit."""
    import threading
    from chsimpy_tpu_torch.core.solver import Solver

    def params():
        # chunks of two graphs: every step but the first replayed, so the
        # 24 runs share the host for their captures only
        p = _graph_case_params('ozaki')
        p.ntmax, p.chunk_size = 257, 128
        return p
    s = Solver(params())
    s.prepare()
    s.solve_or_resume()
    ref = s.solve_or_resume(256)
    streams = [torch.cuda.Stream() for _ in range(24)]
    runs, out, errors = {}, {}, []

    def run(i, steps):
        try:
            with torch.cuda.stream(streams[i]):
                if i not in runs:
                    runs[i] = _graph_solver(params())
                    runs[i].prepare()
                sol = runs[i].solve_or_resume(steps)
                torch.cuda.current_stream().synchronize()
                out[i] = (sol.computed_steps, sol.timedata.data(),
                          sol.U.cpu())
        except BaseException as e:      # raised again below
            errors.append(e)

    def side_by_side(steps):
        threads = [threading.Thread(target=run, args=(i, steps))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[0]
    side_by_side(None)
    assert all(r.graph is not None for r in runs.values())
    for _ in range(40):
        with torch.cuda.stream(torch.cuda.Stream()):
            K._ticket(card, 64)
            K._slice_scratch(card, 64)
            torch.full((4096,), 7, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    side_by_side(256)
    assert sorted(out) == list(range(24))
    for steps, rows, U in out.values():
        assert steps == ref.computed_steps > 257
        assert np.array_equal(rows, ref.timedata.data())
        assert torch.equal(U, ref.U.cpu())


def _grown(fn):
    """What ``fn()`` adds to ``launches`` and ``one_launch``: two dicts of
    the counts that moved."""
    before = (dict(K.launches), dict(K.one_launch))
    fn()
    torch.cuda.synchronize()
    return [{k: c[k] - b[k] for k in c if c[k] != b[k]}
            for c, b in zip((K.launches, K.one_launch), before)]


@pytest.mark.parametrize('transform', ['matmul', 'ozaki'])
def test_a_replayed_chunk_counts_the_launches_of_an_eager_chunk(
        card, transform):
    """The kernels' launch counts grow by the same over STOP_POLL eager
    steps and over one replay of their ChunkGraph; the capture, which
    advances no step, adds nothing."""
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.core.stepper import (STOP_POLL, ChunkGraph,
                                                run_chunk)
    grown = _grown
    s = Solver(_graph_case_params(transform))
    s.prepare()
    s.solve_or_resume(2)
    state, graphs = s._state, []
    eager = grown(lambda: run_chunk(s.cfg, s._consts, state, STOP_POLL))
    capture = grown(lambda: graphs.append(
        ChunkGraph(s.cfg, s._consts, state)))
    replay = grown(lambda: run_chunk(s.cfg, s._consts, state, STOP_POLL,
                                     graph=graphs[0]))
    assert eager[0]['chemical_potential'] == STOP_POLL
    assert replay == eager
    assert capture == [{}, {}]


def test_a_capture_counts_its_own_thread_s_launches_only(card):
    """A ChunkGraph captured while another thread replays a graph and
    steps eagerly: the capture counts its own steps' launches, no more,
    and the counters grow by the other thread's replays and steps only
    (the capture's eager first step advances no step and counts
    nothing)."""
    import threading
    import time

    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.core.stepper import (STOP_POLL, ChunkGraph,
                                                run_chunk)
    s = Solver(_graph_case_params('ozaki'))
    s.prepare()
    s.solve_or_resume(2)
    state = s._state
    eager = _grown(lambda: run_chunk(s.cfg, s._consts, state, STOP_POLL))
    first = ChunkGraph(s.cfg, s._consts, state)
    capturing, done, errors = threading.Event(), threading.Event(), []
    rounds = {'before': 0, 'all': 0}

    def replaying():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                while not done.is_set():
                    run_chunk(s.cfg, s._consts, state, STOP_POLL,
                              graph=first)
                    run_chunk(s.cfg, s._consts, state, 1)
                    rounds['all'] += 1
                    if not capturing.is_set():
                        rounds['before'] += 1
                torch.cuda.current_stream().synchronize()
        except BaseException as e:      # raised again below
            errors.append(e)

    def capture_beside():
        t = threading.Thread(target=replaying)
        t.start()
        while rounds['all'] < 2 and t.is_alive():
            time.sleep(1e-3)
        capturing.set()
        graphs.append(ChunkGraph(s.cfg, s._consts, state))
        seen.append(rounds['all'])
        done.set()
        t.join(timeout=300)
        assert not t.is_alive() and not errors, errors[:1]
    graphs, seen = [], []
    total = _grown(capture_beside)
    one_step = [{k: n // STOP_POLL for k, n in c.items()} for c in eager]
    assert [dict(c) for c in first._launched] == eager
    assert [dict(c) for c in graphs[0]._launched] == eager
    assert seen[0] > rounds['before'], 'no replay during the capture'
    n = rounds['all']
    assert total == [{k: n * (eager[i].get(k, 0) + one_step[i].get(k, 0))
                      for k in set(eager[i]) | set(one_step[i])}
                     for i in range(2)]


def test_spans_on_the_card_are_host_events_only(card):
    """Under a kineto session on the card the port's spans are host
    events, none a device-side event or a user annotation, and the
    ensemble's ``ch.step`` spans are K1_members' launches (the chunk of
    100 steps replays a graph of STOP_POLL steps, whose capture holds
    their spans and whose eager first step is one more span, and no
    launch counted)."""
    from chsimpy_tpu_torch import material, tracing
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    p = Parameters(N=64, device='cuda', no_gui=True, kappa_tilde=KAPPA,
                   full_sim=True, chunk_size=100)
    A0, A1 = material.A0(923.15), material.A1(923.15)
    e = EnsembleSolver(p, np.array([[A0, A1], [A0 * 1.004, A1 * 0.997]]),
                       kappas=[KAPPA, KAPPA])
    e.prepare()
    before = K.launches['chemical_potential_members']
    torch.cuda.synchronize()
    with torch.autograd.profiler.profile(use_kineto=True,
                                         use_device='cuda') as prof:
        tracing.reset()
        e.solve_or_resume(151)
    got = tracing.summary()
    tracing.reset()
    steps = K.launches['chemical_potential_members'] - before
    assert got['ch.step']['count'] == steps + 1 == 151
    assert got['ch.capture']['count'] == got['ch.replay']['count'] == 1
    named = [ev for ev in prof.kineto_results.events()
             if ev.name().startswith('ch.')]
    assert named and all(
        ev.device_type() == torch.autograd.DeviceType.CPU
        and not ev.is_user_annotation() for ev in named)
    assert {ev.name() for ev in named} == set(got)


# ----------------------------------------------------------------------
# the ensemble's chunks replayed as CUDA graphs (EnsembleSolver on the
# card without jitter or a mesh)
# ----------------------------------------------------------------------

def _uq_batch(R, **kw):
    """A float64 matmul batch at N=64 whose members, their A-factors
    spread over [0.995, 1.005], stop between steps ~160 and ~260."""
    from chsimpy_tpu_torch import material
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    A0, A1 = material.A0(923.15), material.A1(923.15)
    pairs = np.array([[A0 * f, A1 / f] for f in np.linspace(0.995, 1.005, R)])
    p = Parameters(N=64, ntmax=600, no_gui=True, kappa_tilde=KAPPA,
                   device='cuda', delt=1e-6, XXX=0.875, threshold=0.875,
                   generator='uniform', chunk_size=128)
    for k, v in kw.items():
        setattr(p, k, v)
    return EnsembleSolver(p, pairs, kappas=[KAPPA] * R)


def _eager(monkeypatch):
    """Every EnsembleSolver made from here on launches each step."""
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    monkeypatch.setattr(EnsembleSolver, '_replays', lambda self: False)


def _batch_run(R, **kw):
    """The solutions of a prepared ``_uq_batch`` run to its end, and the
    solver."""
    e = _uq_batch(R, **kw)
    e.prepare()
    return e.solve_or_resume(), e


def _same_members(a, b):
    for x, y in zip(a, b):
        assert (x.computed_steps, x.tau0, x.t0, x.stop_reason) == \
            (y.computed_steps, y.tau0, y.t0, y.stop_reason)
        assert np.array_equal(x.timedata.data(), y.timedata.data())
        assert torch.equal(x.U, y.U)


@pytest.mark.parametrize('R,chunk', [(5, 100), (10, 128)])
def test_a_replayed_ensemble_is_the_eager_ensemble(card, monkeypatch, R,
                                                   chunk):
    """A float64 matmul batch replaying a ChunkGraph of STOP_POLL
    member steps gives the eager batch's rows, stops, tau0, step counts
    and fields to the bit, through its members' stops (chunks of 100:
    one replay and 36 eager steps; of 128: two replays with a poll
    between)."""
    replayed, e = _batch_run(R, chunk_size=chunk)
    assert e._graph is not None
    _eager(monkeypatch)
    eager, e = _batch_run(R, chunk_size=chunk)
    assert e._graph is None
    stops = [s.computed_steps for s in eager]
    assert all(s.stop_reason == 'energy' for s in eager)
    assert min(stops) > 128 and len(set(stops)) > 1
    _same_members(replayed, eager)


@pytest.mark.parametrize('kw', [
    dict(transform_backend='ozaki'),
    dict(precision='float32', transform_backend='split'),
    dict(precision='float32', transform_backend='split', fold_field=True),
    dict(precision='float32', transform_backend='fft'),
    dict(precision='float32', matmul_precision='high'),
    dict(precision='float32', otf_coeffs=True),
    dict(precision='float32', inv_band=16),
    dict(adaptive_time=True, full_sim=True, ntmax=700),
    dict(time_max=146.0, full_sim=True)], ids=str)
def test_replayed_batches_on_the_other_paths_are_eager(card, monkeypatch,
                                                       kw):
    """The routes and knobs an EnsembleSolver on the card replays
    besides the float64 matmul route (the adaptive step past step 500,
    the time limit at step 150): the eager batch's bits."""
    replayed, e = _batch_run(3, **kw)
    assert e._graph is not None
    _eager(monkeypatch)
    eager, _ = _batch_run(3, **kw)
    _same_members(replayed, eager)


def test_a_replayed_members_chunk_counts_the_launches_of_an_eager_chunk(
        card):
    """The kernels' launch counts grow by the same over STOP_POLL eager
    member steps and over one replay of their ChunkGraph; the capture,
    which advances no step, adds nothing."""
    from chsimpy_tpu_torch.core.stepper import (STOP_POLL, ChunkGraph,
                                                run_members_chunk)
    e = _uq_batch(5)
    e.prepare()
    e.solve_or_resume(2)
    state, graphs = e._states, []
    eager = _grown(lambda: run_members_chunk(e.cfg, e._consts, state,
                                             STOP_POLL))
    capture = _grown(lambda: graphs.append(
        ChunkGraph(e.cfg, e._consts, state, members=True)))
    replay = _grown(lambda: run_members_chunk(e.cfg, e._consts, state,
                                              STOP_POLL, graph=graphs[0]))
    assert eager[0]['chemical_potential_members'] == STOP_POLL
    assert replay == eager
    assert capture == [{}, {}]


def test_a_replayed_ensemble_under_the_profiler(card, monkeypatch):
    """Under a kineto session (the spans on) a replayed batch gives the
    eager batch's bits; the spans count one capture and a replay for
    each whole STOP_POLL steps of its chunks (300 steps in chunks of
    128, 128 and 44: four), and its ``ch.step`` spans the capture's
    steps, its eager first step and the 44 eager ones."""
    from chsimpy_tpu_torch import tracing
    from chsimpy_tpu_torch.core.stepper import STOP_POLL
    kw = dict(full_sim=True, ntmax=301)
    e = _uq_batch(5, **kw)
    e.prepare()
    k1 = K.launches['chemical_potential_members']
    torch.cuda.synchronize()
    with torch.autograd.profiler.profile(use_kineto=True,
                                         use_device='cuda'):
        tracing.reset()
        traced = e.solve_or_resume()
    got = tracing.summary()
    tracing.reset()
    assert got['ch.capture']['count'] == 1
    assert got['ch.replay']['count'] == 4
    assert got['ch.step']['count'] == 1 + STOP_POLL + 44
    assert K.launches['chemical_potential_members'] - k1 == 300
    _eager(monkeypatch)
    eager, _ = _batch_run(5, **kw)
    _same_members(traced, eager)


def test_a_batch_s_graph_goes_with_its_solver(card):
    """The memory a batch's graph holds goes with its solver: after each
    of several replayed batches is dropped (no collection of cycles
    between, as in the benchmark's window), the allocator holds what it
    held before the first."""
    import gc
    for R in (10, 5):           # the widths' tickets, once
        e = _uq_batch(R, full_sim=True, ntmax=130)
        e.prepare()
        e.solve_or_resume()
        del e
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    for R in (5, 10, 5, 10):
        e = _uq_batch(R, full_sim=True, ntmax=130)
        e.prepare()
        e.solve_or_resume()
        assert e._graph is not None
        del e
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(card) == base


def test_batches_in_threads_capture_on_streams_of_their_own(card,
                                                             monkeypatch):
    """Threads on the default stream capture on a stream of their own,
    one a thread kept for its later captures: four threads replaying
    batches side by side give the eager batch's bits, and none captured
    on another's stream."""
    import threading
    from chsimpy_tpu_torch.core import stepper
    kw = dict(full_sim=True, ntmax=260)
    runs, errors = {}, []

    def run(i):
        try:
            sols = []
            for _ in range(2):
                e = _uq_batch(5, **kw)
                e.prepare()
                sols.append(e.solve_or_resume())
                sols.append(e._graph._stream)
            runs[i] = sols
        except BaseException as exc:    # raised again below
            errors.append(exc)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:1]
    streams = [runs[i][1] for i in range(4)]
    assert all(runs[i][3] is runs[i][1] for i in range(4))
    assert len({s.cuda_stream for s in streams}) == 4
    assert stepper._capture_stream(card) not in streams
    _eager(monkeypatch)
    eager, _ = _batch_run(5, **kw)
    for i in range(4):
        _same_members(runs[i][0], eager)
        _same_members(runs[i][2], eager)
