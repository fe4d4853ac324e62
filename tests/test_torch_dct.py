"""The port's split and FFT transforms (chsimpy_tpu_torch/ops/dct.py) and the
plain version of its GEMM kernel (ops/kernels.py matmul) against the JAX
package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages; JAX's
Pallas matmul runs in interpret mode.  Bounds: float64 transforms within
1e-12 absolute of JAX and of scipy (the JAX suite's own bound,
tests/test_transform.py); float32 transforms within 2e-6 max|ref| (a few
float32 ulps of the output scale: pocketfft and the block products sum in
other orders than XLA); the GEMM within 1e-5 relative (tests/
test_pallas_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.fftpack import dctn, idctn

from chsimpy_tpu.ops import dct as jdct
from chsimpy_tpu.ops import pallas_kernels as pk

from chsimpy_tpu_torch import convert
from chsimpy_tpu_torch.ops import dct as tdct
from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

# the (N, levels) pairs of tests/test_transform.py
SPLIT_CASES = [(8, 1), (64, 2), (64, 3), (256, 2), (130, 1)]
FFT_SIZES = [8, 64, 130, 256]


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _x(N, seed=1):
    return np.random.default_rng(seed).random((N, N))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _tree_pair(N, levels, dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return tdct.split_tree(N, levels, dtype), jdct.split_tree(N, levels, jdt)


@pytest.mark.parametrize('N,levels', SPLIT_CASES)
def test_split_natural_matches_jax_and_scipy(N, levels):
    x = _x(N)
    tt, jt = _tree_pair(N, levels)
    ref = dctn(x, norm='ortho')
    got = tdct.dct2_split(torch.from_numpy(x), tt)
    assert got.is_contiguous()
    _close(got, jdct.dct2_split(jnp.asarray(x), jt), 1e-12)
    _close(got, ref, 1e-12)
    back = tdct.idct2_split(torch.from_numpy(ref), tt)
    _close(back, jdct.idct2_split(jnp.asarray(ref), jt), 1e-12)
    _close(back, x, 1e-12)


@pytest.mark.parametrize('N,levels', SPLIT_CASES)
def test_split_permuted_matches_jax_and_scipy(N, levels):
    """The permuted forms against JAX, and the permuted basis as the
    conjugation of the natural one by split_permute_grid."""
    x = _x(N, 2)
    tt, jt = _tree_pair(N, levels)
    got = tdct.dct2_split_perm(torch.from_numpy(x), tt)
    _close(got, jdct.dct2_split_perm(jnp.asarray(x), jt), 1e-12)
    _close(got, tdct.split_permute_grid(dctn(x, norm='ortho'), N, levels),
           1e-12)
    _close(got, jdct.split_permute_grid(dctn(x, norm='ortho'), N, levels),
           1e-12)
    back = tdct.idct2_split_perm(got, tt)
    _close(back, jdct.idct2_split_perm(jnp.asarray(got.numpy()), jt), 1e-12)
    _close(back, x, 1e-12)
    # the solver's spectral grids permute through the same order
    p = tdct._split_permutation_np(N, levels)
    assert np.array_equal(p, jdct._split_permutation_np(N, levels))
    G = _x(N, 3)
    assert np.array_equal(tdct.split_permute_axis(np.arange(N), N, levels), p)
    assert np.array_equal(tdct.split_permute_grid(G, N, levels),
                          jdct.split_permute_grid(G, N, levels))


@pytest.mark.parametrize('N,levels', [(8, 1), (64, 2), (64, 3), (256, 2),
                                      (130, 1)])
def test_split_folded_equals_fold1_of_the_natural_forms(N, levels):
    """The folded pair is pure layout: the same bits as the natural pair
    with fold1 around it."""
    x = torch.from_numpy(_x(N, 4))
    tt, jt = _tree_pair(N, levels)
    V = tdct.fold1(x)
    assert torch.equal(tdct.fold1(V), x)
    assert np.array_equal(V.numpy(), np.asarray(jdct.fold1(jnp.asarray(x))))
    X = tdct.dct2_split_perm_folded(V, tt)
    assert torch.equal(X, tdct.dct2_split_perm(x, tt))
    _close(X, jdct.dct2_split_perm_folded(jnp.asarray(V.numpy()), jt), 1e-12)
    W = tdct.idct2_split_perm_folded(X, tt)
    assert torch.equal(W, tdct.fold1(tdct.idct2_split_perm(X, tt)))
    _close(W, jdct.idct2_split_perm_folded(jnp.asarray(X.numpy()), jt),
           1e-12)
    _close(W, V, 1e-12)


def test_folded_variants_need_a_fold():
    x = torch.from_numpy(_x(8))
    leaf = tdct.split_tree(8, 0)
    with pytest.raises(ValueError, match='levels >= 1'):
        tdct.dct2_split_perm_folded(x, leaf)
    with pytest.raises(ValueError, match='levels >= 1'):
        tdct.idct2_split_perm_folded(x, leaf)


@pytest.mark.parametrize('N', FFT_SIZES)
def test_fft_route_matches_jax_and_scipy(N):
    x = _x(N, 5)
    ref = dctn(x, norm='ortho')
    got = tdct.dct2_fft(torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.is_contiguous()
    _close(got, jdct.dct2_fft(jnp.asarray(x)), 1e-12)
    _close(got, ref, 1e-12)
    back = tdct.idct2_fft(torch.from_numpy(ref))
    _close(back, jdct.idct2_fft(jnp.asarray(ref)), 1e-12)
    _close(back, idctn(ref, norm='ortho'), 1e-12)
    _close(back, x, 1e-12)
    # the 1-D forms along the last axis
    _close(tdct.dct1d_fft(torch.from_numpy(x)),
           jdct.dct1d_fft(jnp.asarray(x)), 1e-12)
    _close(tdct.idct1d_fft(torch.from_numpy(x)),
           jdct.idct1d_fft(jnp.asarray(x)), 1e-12)


def test_fft_route_needs_even_n():
    x = torch.from_numpy(_x(7))
    with pytest.raises(ValueError, match='even N'):
        tdct.dct2_fft(x)
    with pytest.raises(ValueError, match='even N'):
        tdct.idct1d_fft(x)


@pytest.mark.parametrize('route', ['fft', 'split', 'split_perm'])
@pytest.mark.parametrize('N', [64, 130])
def test_float32_transforms_match_jax(route, N):
    """float32 (complex64 FFTs, float32 block products) against JAX's
    float32 forms and scipy in float64, within 2e-6 max|ref|."""
    x = _x(N, 6).astype(np.float32)
    ref = dctn(x.astype(np.float64), norm='ortho')
    L = 1 if N == 130 else 2
    tt, jt = _tree_pair(N, L, torch.float32)
    fwd = {'fft': (lambda u: tdct.dct2_fft(u), lambda u: jdct.dct2_fft(u)),
           'split': (lambda u: tdct.dct2_split(u, tt),
                     lambda u: jdct.dct2_split(u, jt)),
           'split_perm': (lambda u: tdct.dct2_split_perm(u, tt),
                          lambda u: jdct.dct2_split_perm(u, jt))}[route]
    got = fwd[0](torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(fwd[1](jnp.asarray(x)))
    bound = 2e-6 * np.abs(ref).max()
    _close(got, want, bound)
    if route == 'split_perm':
        ref = tdct.split_permute_grid(ref, N, L)
    _close(got, ref, bound)


@pytest.mark.parametrize('N,levels', [(64, 3), (130, 1), (256, 4)])
def test_split_tree_from_jax_is_the_ports_tree(N, levels):
    def flat(t):
        return [b for s in t for b in flat(s)] if isinstance(t, tuple) \
            else [t]
    for tdt, jdt in ((torch.float64, jnp.float64),
                     (torch.float32, jnp.float32)):
        jt = jdct.split_tree(N, levels, jdt)
        numpy_tree = jax_tree_to_numpy(jt)
        got = convert.split_tree_from_jax(numpy_tree)
        want = tdct.split_tree(N, levels, tdt)
        assert len(flat(got)) == len(flat(want)) == levels + 1
        for a, b in zip(flat(got), flat(want)):
            assert a.dtype == b.dtype == tdt
            assert torch.equal(a, b)
    assert convert.split_tree_from_jax(()) == ()


def jax_tree_to_numpy(t):
    if isinstance(t, tuple):
        return tuple(jax_tree_to_numpy(s) for s in t)
    return np.asarray(t)


# ----------------------------------------------------------------------
# the GEMM kernel's plain version against JAX pk.matmul (interpret mode)
# ----------------------------------------------------------------------

@pytest.mark.parametrize('shape,n', [((64, 64), 96), ((128, 256), 96),
                                     ((130, 70), 33)])
def test_matmul_ref_matches_pallas_matmul(shape, n):
    rng = np.random.default_rng(2)
    A = rng.random(shape).astype(np.float32)
    B = rng.random((shape[1], n)).astype(np.float32)
    pallas = np.asarray(pk.matmul(jnp.asarray(A), jnp.asarray(B)))
    K.reset_launches()
    got = K.matmul(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.float32 and K.launches['matmul'] == 0
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5)
    np.testing.assert_allclose(K.matmul_ref(torch.from_numpy(A),
                                            torch.from_numpy(B)).numpy(),
                               A.astype(np.float64) @ B, rtol=1e-5)
    # a transposed operand is a view, taken as it is
    got_t = K.matmul(torch.from_numpy(np.ascontiguousarray(A.T)).T,
                     torch.from_numpy(B))
    np.testing.assert_allclose(got_t.numpy(), pallas, rtol=1e-5)


def test_gemm_dcts_match_pallas_and_scipy():
    rng = np.random.default_rng(3)
    U = rng.random((64, 64)).astype(np.float32)
    C = tdct.dct_matrix(64, torch.float32)
    X = K.dct2_gemm(torch.from_numpy(U), C)
    ref = dctn(U.astype(np.float64), norm='ortho')
    np.testing.assert_allclose(X.numpy(), ref, rtol=0, atol=1e-4)
    jC = jdct.dct_matrix(64, jnp.float32)
    np.testing.assert_allclose(
        X.numpy(), np.asarray(pk.dct2_pallas(jnp.asarray(U), jC)),
        rtol=0, atol=1e-4)
    back = K.idct2_gemm(X, C)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(pk.idct2_pallas(jnp.asarray(X.numpy()),
                                                 jC)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), U, rtol=0, atol=1e-5)


def test_matmul_refuses_what_the_kernel_does_not_take():
    A = torch.ones((4, 6))
    with pytest.raises(ValueError, match='non-empty'):
        K.matmul(A, torch.ones((5, 3)))
    with pytest.raises(ValueError, match='non-empty'):
        K.matmul(torch.ones((0, 6)), torch.ones((6, 3)))
    with pytest.raises(TypeError):
        K.matmul(A, torch.ones((6, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match='no kernel'):
        K.matmul(A.to('meta'), torch.ones((6, 3), device='meta'))
    with pytest.raises(ValueError, match='row-major'):
        K._gemm_operand(torch.ones((6, 6))[:, ::2])
    assert K._gemm_operand(torch.ones((6, 5))) == (0, 5)
    assert K._gemm_operand(torch.ones((6, 5)).T) == (1, 5)
    assert K._gemm_operand(torch.ones((6, 8))[:, :5]) == (0, 8)


def test_matmul_ref_restores_the_tf32_switch():
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        K.matmul_ref(torch.ones((2, 2)), torch.ones((2, 2)))
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32 = prev
