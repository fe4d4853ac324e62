"""What the port decides on the host around its redesigned kernels, on the
CPU: the statistics kernel's grid on a block (K7, and K3 as the whole field
taken as one block), the plain K7 on the whole field against the plain K3,
and the slice scale (K5) at a field whose max|x| lies one ulp above a power
of two, against the JAX package.

Inputs are made by numpy from a seed.  The plain versions must agree to the
bit: the kernels on the card are held to the same equalities
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 6 (a) and 8 (a)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chsimpy_tpu.ops import ozaki as jo
from chsimpy_tpu.ops import pallas_kernels as pk

from chsimpy_tpu_torch import Parameters
from chsimpy_tpu_torch.derived import Derived
from chsimpy_tpu_torch.ops import kernels as K

from test_torch_ozaki import _assert_scale

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


# ----------------------------------------------------------------------
# K7's grid: (vector width, blocks) from the block's shape, the element
# size and the alignment of its rows
# ----------------------------------------------------------------------

@pytest.mark.parametrize('bn,W,N,off,itemsize,addr,want', [
    (2048, 2048, 4096, (0, 2048), 4, 0, (4, 2 * 128)),   # 2x2 of N=4096
    (2048, 2048, 4096, (2048, 0), 8, 0, (2, 4 * 64)),
    (4096, 1024, 4096, (0, 3072), 4, 0, (4, 1 * 256)),   # 1x4
    (1024, 4096, 4096, (1024, 0), 8, 0, (2, 8 * 32)),    # 4x1
    (256, 256, 512, (256, 256), 4, 0, (1, 1 * 64)),      # refined: 4-row bands
    (64, 33, 97, (0, 64), 4, 0, (1, 1 * 16)),            # odd W: V=1
    (64, 33, 97, (0, 64), 8, 0, (1, 1 * 16)),
    (10, 6, 12, (2, 6), 4, 0, (1, 3)),                   # 6 % 4 != 0
    (10, 6, 12, (2, 6), 8, 0, (1, 3)),                   # V=1 spans W
    (2048, 2048, 4096, (0, 0), 4, 8, (1, 8 * 32)),       # unaligned halo row
    (2048, 2048, 4096, (0, 0), 8, 8, (1, 8 * 32)),
])
def test_local_stats_grid_choices(bn, W, N, off, itemsize, addr, want):
    """V = 16 / itemsize where W and every address allow it, else 1; the
    blocks cover W in STATS_THREADS * V columns and bn in
    STATS_ROWS_X_VEC / V rows where that gives STATS_MIN_BLOCKS blocks;
    below it the vector narrows while a narrower block still spans W and
    the band halves down to STATS_MIN_BAND rows."""
    aligned = 1 << 20
    got = K.local_stats_grid(bn, W, N, *off, itemsize, aligned,
                             aligned + addr, aligned + 16 * W)
    assert got == want


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [4096, 1000, 1001, 512, 2])
def test_local_stats_grid_is_k3s_on_the_whole_field(N, itemsize):
    """The whole field as one block takes K3's grid, so K7 there sums
    K3's partials in K3's order; the grid does not move with the block's
    offsets."""
    assert K.local_stats_grid(N, N, N, 0, 0, itemsize, 0, 16 * N) == \
        K.stats_grid(N, itemsize, 0, 16 * N)
    if N >= 4:
        h = N // 2
        grids = {K.local_stats_grid(h, h, N, r, c, itemsize, 0)
                 for r in (0, N - h) for c in (0, N - h)}
        assert len(grids) == 1


@pytest.mark.parametrize('bn,W,N,row_off,col_off', [
    (8, 4, 16, 12, 0),           # rows 12..19 of 16
    (8, 4, 16, 0, 13),           # columns 13..16
    (8, 4, 16, -1, 0),
    (8, 4, 16, 0, -4),
    (0, 4, 16, 0, 0),            # an empty block
    (8, 0, 16, 0, 0),
    (1, 1, 1, 0, 0),             # a field needs N >= 2
])
def test_local_stats_grid_refuses_a_block_outside_the_field(bn, W, N,
                                                            row_off,
                                                            col_off):
    with pytest.raises(ValueError, match='does not lie'):
        K.local_stats_grid(bn, W, N, row_off, col_off, 8, 0)


# ----------------------------------------------------------------------
# the plain K7 on the whole field is the plain K3, to the bit
# ----------------------------------------------------------------------

def _physics(N):
    p = Parameters(N=N, kappa_tilde=KAPPA)
    d = Derived.from_params(p)
    return d, p


@pytest.mark.parametrize('with_e', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N', [64, 33, 2])
def test_local_band_sums_ref_on_the_whole_field_is_stats_sums_ref(N, dtype,
                                                                  with_e):
    """Offsets 0 and edge-replicated halos (the global edges take the
    one-sided differences, so the halo values are never read): the same
    five sums, bit for bit."""
    d, p = _physics(N)
    rng = np.random.default_rng(N)
    U = torch.tensor(0.875 + 0.01 * (rng.random((N, N)) - 0.5), dtype=dtype)
    E = K.chemical_potential_ref(U, d.RT, d.BRT, d.A0, d.A1) if with_e \
        else None
    kw = dict(delx=d.delx, RT=d.RT, B=p.B, threshold=p.threshold)
    whole = K.stats_sums_ref(U, E, d.A0, d.A1, **kw)
    block = K.local_band_sums_ref(U, U[0], U[-1], U[:, 0], U[:, -1], E,
                                  d.A0, d.A1, 0, 0, N=N, **kw)
    assert torch.equal(block, whole)
    # and through the wrapper, which takes the plain version on the CPU
    got = K.local_band_sums(U, U[0].contiguous(), U[-1].contiguous(),
                            U[:, 0].contiguous(), U[:, -1].contiguous(), E,
                            d.A0, d.A1, 0, 0, N=N, **kw)
    assert torch.equal(got, whole)
    assert K.launches['local_band_sums'] == 0


# ----------------------------------------------------------------------
# K5's scale at max|x| one ulp above a power of two
# ----------------------------------------------------------------------

AMAX_EXP = 8     # torch's and XLA's log2 both give 8.0 at 2^8 (1 + 2^-52)


def ulp_field(shape, seed):
    """Normal values within 2^(AMAX_EXP - 1) and one element at
    -(2^AMAX_EXP + 1 ulp): ceil(log2(max|x| + 1e-30)) is AMAX_EXP, where
    frexp's exponent would give AMAX_EXP + 1."""
    rng = np.random.default_rng(seed)
    f = np.clip(rng.standard_normal(shape) * 20.0, -120.0, 120.0)
    f[shape[0] // 3, shape[1] // 2] = -np.nextafter(2.0 ** AMAX_EXP, np.inf)
    return f


@pytest.mark.parametrize('n_slices', [4, 6, 8])
@pytest.mark.parametrize('shape', [(64, 64), (33, 47)])
def test_slice_field_ref_one_ulp_above_a_power_of_two(shape, n_slices):
    x = ulp_field(shape, 17)
    assert np.frexp(np.abs(x).max())[1] + 2 == AMAX_EXP + 3
    got, scale = K.slice_field_ref(torch.tensor(x), n_slices)
    assert float(scale) == 2.0 ** (AMAX_EXP + 2)
    for fn in (jo.slice_field, jo.slice_field_pallas):
        want, jscale = fn(jnp.asarray(x), n_slices)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_scale(scale, jscale)
