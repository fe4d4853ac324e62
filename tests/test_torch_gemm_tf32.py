"""The arithmetic of the GEMM kernel (``csrc/gemm_sm90.cu``), emulated in
plain PyTorch on the CPU: 3xTF32, the float32-class product on Hopper's
tensor cores.

    x_hi = tf32_rna(x),  x_lo = tf32_rna(x - x_hi)
    A @ B ~ A_lo @ B_hi + A_hi @ B_lo + A_hi @ B_hi    (float32 sums)

TF32 keeps 10 mantissa bits; round to nearest, ties away from zero, is
emulated by adding half of the 13 dropped bits and masking them.  The
emulation lives here only: the port runs the kernel on the card and
``matmul_ref`` (TF32 off) on the CPU.

Bounds (``chip_smoke.py`` GEMM_TOL, ROUNDTRIP_BOUND): against the float64
product, at most 4x the error of a float32 product and 1e-5 max|ref|; the
DCT round trip (4 chained forward+inverse transforms of a [0, 1) field)
within 1e-4.  One TF32 pass misses that bound, so the test tells the two
apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chsimpy_tpu.ops import pallas_kernels as pk

from chsimpy_tpu_torch.ops import dct as tdct

torch.set_num_threads(2)

ROUNDTRIP_BOUND = 1e-4          # float32 routes, 4 round trips
ROUNDTRIPS = 4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(A, B):
    (a_hi, a_lo), (b_hi, b_lo) = split(A), split(B)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_1xtf32(A, B):
    return tf32_rna(A) @ tf32_rna(B)


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _err(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    got = tf32_rna(x)
    # ties go away from zero; below half an ulp (2^-11) rounds down
    assert got[:5].tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                -(1.0 + 2.0 ** -10), 1.0]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    hi, lo = split(x)
    # hi + lo holds 22 significant bits of x
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize('M,K,N', [(512, 512, 512), (1000, 1531, 777)])
def test_3xtf32_is_in_the_float32_class(M, K, N):
    A, B = _operands(M, K, N, M + K)
    ref = A.astype(np.float64) @ B.astype(np.float64)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    emu = matmul_3xtf32(At, Bt).numpy()
    plain = _err((At @ Bt).numpy(), ref)
    err = _err(emu, ref)
    bound = 1e-5 * np.max(np.abs(ref))
    assert err <= 4 * plain and err <= bound, (err, plain, bound)
    # the JAX package's GEMM: its Pallas kernel in interpret mode where it
    # tiles the shape; at K=1531 (prime) its tiles would be one element
    # deep, so the kernel body's own contraction stands in for it
    if (M, K, N) == (512, 512, 512):
        jax_out = pk.matmul(jnp.asarray(A), jnp.asarray(B))
    else:
        jax_out = jnp.dot(jnp.asarray(A), jnp.asarray(B),
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    jax_out = np.asarray(jax_out)
    assert err <= 4 * _err(jax_out, ref)
    assert _err(emu, jax_out.astype(np.float64)) <= bound
    # one TF32 pass is out of that class
    assert _err(matmul_1xtf32(At, Bt).numpy(), ref) > bound


@pytest.fixture
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _roundtrip_err(mm, N=512):
    """Max |x' - x| after ROUNDTRIPS chained DCT-II / DCT-III pairs of a
    [0, 1) field, every product through ``mm`` (the bake-off's gemm
    route: C @ U @ C^T, then C^T @ X @ C)."""
    x = torch.from_numpy(np.random.default_rng(0).random((N, N))
                         .astype(np.float32))
    C = tdct.dct_matrix(N, torch.float32)
    y = x
    for _ in range(ROUNDTRIPS):
        X = mm(mm(C, y), C.T)
        y = mm(mm(C.T, X), C)
    return float((y.double() - x.double()).abs().max())


def test_3xtf32_dct_roundtrip_holds_the_float32_bound():
    assert _roundtrip_err(matmul_3xtf32) <= ROUNDTRIP_BOUND


def test_one_tf32_pass_misses_the_roundtrip_bound():
    assert _roundtrip_err(matmul_1xtf32) > ROUNDTRIP_BOUND


def test_3xtf32_dct_matches_the_pallas_dct(interpret_mode):
    """One forward DCT at N=256 through the emulation against the JAX
    package's dct2_pallas (interpret mode): within 1e-5 max|X|."""
    N = 256
    U = np.random.default_rng(4).random((N, N)).astype(np.float32)
    C = tdct.dct_matrix(N, torch.float32)
    X = matmul_3xtf32(matmul_3xtf32(C, torch.from_numpy(U)), C.T).numpy()
    jC = jnp.asarray(C.numpy())
    ref = np.asarray(pk.dct2_pallas(jnp.asarray(U), jC))
    assert np.max(np.abs(X - ref)) <= 1e-5 * np.max(np.abs(ref))
