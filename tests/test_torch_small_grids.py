"""What the port decides on the host for its kernels on small fields, on
the CPU: the statistics kernel's refined tile (K3, K3_members, K7,
K7_members on fields and blocks whose fixed tile has fewer than
STATS_MIN_BLOCKS blocks) and the path K5 and K5_members take (one launch
where the fields fit in L2, else the max and slice passes).

The tile depends on the block's shape, the element size and the vector
width alone, so a member of a batched launch sums in the single launch's
order and K7 on the whole field in K3's; every grid of at least
STATS_MIN_BLOCKS blocks keeps the fixed tile (and its bits).  The kernels
themselves are held to the same equalities on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3, 6 (a), 10 (a),
12 (a) and 14 (a)).  The wrappers take the plain versions here, against the
JAX package on inputs made by numpy from a seed.
"""

import jax
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
ALIGNED = 1 << 20


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _fixed(bn, W, itemsize, *addresses):
    return K.fixed_stats_tile(bn, W, itemsize, *addresses)


def _tile(bn, W, itemsize, *addresses):
    return K.stats_tile(bn, W, max(bn, W), 0, 0, itemsize, *addresses)


# ----------------------------------------------------------------------
# the statistics kernel's tile
# ----------------------------------------------------------------------

SHAPES = [(512, 512), (1024, 1024), (2048, 2048), (4096, 4096), (256, 256),
          (1000, 1000), (1001, 1001), (500, 250), (33, 47), (2, 2),
          (4096, 512), (512, 4096), (2047, 2047)]


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('bn,W', SHAPES)
def test_tile_is_a_function_of_the_shape_alone(bn, W, itemsize):
    """Wherever the block lies in a field and wherever (16-byte aligned)
    its rows start, the tile is the same."""
    N = 2 * max(bn, W)
    tiles = {K.stats_tile(bn, W, N, r, c, itemsize, ALIGNED + 16 * k,
                          ALIGNED + 16 * (k + 5 * W))
             for r in (0, N - bn) for c in (0, N - W) for k in (0, 3)}
    assert len(tiles) == 1
    vec, band, blocks = tiles.pop()
    assert blocks == -(-W // (K.STATS_THREADS * vec)) * -(-bn // band)


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [512, 1024, 1000, 1001, 33])
def test_a_members_tile_is_the_single_fields(N, itemsize):
    """Member r of a contiguous (R, N, N) stack starts r N^2 elements
    after the first (16-byte aligned where the vector fits N): the tile
    of K3_members is the single launch's on a fresh field."""
    single = _tile(N, N, itemsize, ALIGNED, ALIGNED + 2 ** 24)
    for R in (1, 4, 16):
        stride = N * N * itemsize
        for r in range(R):
            assert _tile(N, N, itemsize, ALIGNED + r * stride,
                         ALIGNED + 2 ** 24 + r * stride) == single


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [4096, 2048, 1024, 512, 1000, 1001, 64])
def test_k7_on_the_whole_field_takes_k3s_tile(N, itemsize):
    """K7 with the whole field as its block sums in K3's order, and the
    blocks of a 2x2 mesh all take one tile."""
    assert K.local_stats_grid(N, N, N, 0, 0, itemsize, ALIGNED) == \
        K.stats_grid(N, itemsize, ALIGNED)
    h = N // 2
    assert len({K.stats_tile(h, h, N, r, c, itemsize, ALIGNED)
                for r in (0, N - h) for c in (0, N - h)}) == 1


MESH_BLOCKS = [(N // mx, N // my) for N in (2048, 4096)
               for mx, my in ((1, 1), (2, 2), (1, 4), (4, 1), (2, 4),
                              (4, 2), (1, 8), (8, 1))]


@pytest.mark.parametrize('addr', [0, 8])
@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('bn,W', MESH_BLOCKS + SHAPES)
def test_grids_of_256_blocks_keep_the_fixed_tile(bn, W, itemsize, addr):
    """Where the fixed tile (STATS_THREADS V columns, STATS_ROWS_X_VEC / V
    rows) already has STATS_MIN_BLOCKS blocks the tile is the fixed one,
    so those grids keep their summation order and their bits: every
    N >= 2048 field and every block of N=4096 on 2x2, 1x4 and 4x1."""
    fixed = _fixed(bn, W, itemsize, ALIGNED + addr)
    tile = _tile(bn, W, itemsize, ALIGNED + addr)
    if fixed[2] >= K.STATS_MIN_BLOCKS:
        assert tile == fixed
    else:
        assert tile[2] >= fixed[2]
    if (bn, W) in ((2048, 2048), (4096, 4096), (4096, 1024),
                   (1024, 4096)) and addr == 0:
        assert fixed[2] >= K.STATS_MIN_BLOCKS


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [512, 1024])
def test_small_fields_get_no_block_wider_than_the_field(N, itemsize):
    """At N=512 and 1024 no block has more columns than the field: the
    float4 (float32) block of 1024 columns narrows to a float2 one on a
    512-wide field; and the grid has STATS_MIN_BLOCKS blocks or the
    shortest band, where the fixed tile had 16-64."""
    vec, band, blocks = _tile(N, N, itemsize, ALIGNED)
    assert K.STATS_THREADS * vec <= N
    assert blocks >= K.STATS_MIN_BLOCKS or band == K.STATS_MIN_BAND
    assert _fixed(N, N, itemsize, ALIGNED)[2] <= 64 < blocks
    assert band >= K.STATS_MIN_BAND and vec * itemsize <= 16


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [512, 1024, 2048, 4096, 1000, 1002, 64])
def test_the_fold_mode_takes_the_natural_tile_where_the_vector_fits(
        N, itemsize):
    """K3's fold mode gives the natural field's bits where N/2 allows the
    vector: it takes the natural tile there; elsewhere the one-column
    tile of the same rule."""
    natural = _tile(N, N, itemsize, ALIGNED)
    folded = K.stats_tile(N, N, N, 0, 0, itemsize, ALIGNED, fold=True)
    if (N // 2) % natural[0] == 0:
        assert folded == natural
    else:
        assert folded[0] == 1 and folded == _tile(N, N, itemsize,
                                                  ALIGNED + 4)


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('bn,W', SHAPES)
def test_the_fixed_tile_is_the_widest_vector_and_64_over_v_rows(
        bn, W, itemsize):
    """The fixed tile, which the launches are timed beside on the card:
    stats_tile's widest vector (the same one wherever the refinement
    narrows it) and STATS_ROWS_X_VEC / V rows; at N=512 float64 16
    blocks of 32 rows against the refined tile's 128 of 4."""
    for addr in (0, 8):
        vec, band, blocks = _fixed(bn, W, itemsize, ALIGNED + addr)
        widest = 16 // itemsize if W % (16 // itemsize) == 0 and not addr \
            else 1
        assert (vec, band) == (widest, K.STATS_ROWS_X_VEC // widest)
        assert blocks == -(-W // (K.STATS_THREADS * vec)) * -(-bn // band)
        assert _tile(bn, W, itemsize, ALIGNED + addr)[0] <= vec
    if (bn, W, itemsize) == (512, 512, 8):
        assert _fixed(bn, W, itemsize, ALIGNED) == (2, 32, 16)
        assert _tile(bn, W, itemsize, ALIGNED) == (2, 4, 128)


# ----------------------------------------------------------------------
# K5's path
# ----------------------------------------------------------------------

@pytest.mark.parametrize('R,N,one', [
    (16, 512, True),      # the canonical UQ batch: 32 MiB
    (1, 512, True),       # the canonical single run's field
    (4, 4096, False),     # R=4 N=4096 keeps the two launches
    (1, 4096, False),
    (17, 512, True),      # 34 MiB
    (24, 512, True),      # 48 MiB, the limit
    (25, 512, False),     # one member past it
    (6, 1024, True),      # 48 MiB
    (1, 2560, False),     # 50 MiB
    (4, 1000, True),
    (1, 2048, True),      # 32 MiB
    (2, 2048, False),     # 64 MiB
])
def test_k5_path_is_chosen_from_the_shape(R, N, one):
    assert K.slice_one_launch(R, N * N) is one
    assert (R * N * N * 8 <= K.SLICE_ONE_LAUNCH_BYTES) is one


def _physics(N):
    p = Parameters(N=N, kappa_tilde=KAPPA)
    return Derived.from_params(p), p


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_batched_stats_on_the_cpu_match_jax_and_count_nothing(dtype):
    """K3_members' wrapper on CPU tensors is its plain version: against
    the JAX ensemble's vmap of stats_band_sums at R=16, member r the
    single wrapper's bits, and no launch counted."""
    R, N = 16, 16
    d, p = _physics(N)
    rng = np.random.default_rng(16)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    U = (0.875 + 0.01 * (rng.random((R, N, N)) - 0.5)).astype(npdt)
    A0s = d.A0 * (1 + 0.004 * (rng.random(R) - 0.5))
    A1s = d.A1 * (1 + 0.004 * (rng.random(R) - 0.5))
    tU = torch.from_numpy(U)
    tA0, tA1 = torch.tensor(A0s), torch.tensor(A1s)
    E = K.chemical_potential_members_ref(tU, d.RT, d.BRT, tA0, tA1)
    kw = dict(delx=d.delx, RT=d.RT, B=p.B, threshold=p.threshold)
    K.reset_launches()
    sums = K.stats_sums_members(tU, E, tA0, tA1, **kw)
    assert K.launches['stats_sums_members'] == 0
    jsums = jax.vmap(lambda u, e, a0, a1: pk.stats_band_sums(
        u, e, a0, a1, **kw))(jnp.asarray(U), jnp.asarray(E.numpy()),
                             jnp.asarray(A0s), jnp.asarray(A1s))
    jsums = np.asarray(jsums)[:, 0, :5].astype(np.float64)
    np.testing.assert_allclose(sums.numpy(), jsums,
                               rtol=1e-12 if dtype == torch.float64
                               else 1e-5)
    assert np.array_equal(sums.numpy()[:, 3], jsums[:, 3])
    for r in range(R):
        assert torch.equal(sums[r], K.stats_sums(
            tU[r], E[r], float(A0s[r]), float(A1s[r]), **kw))


@pytest.mark.parametrize('n_slices', [4, 6])
def test_batched_slices_on_the_cpu_match_jax_and_count_nothing(n_slices):
    """K5_members' wrapper on CPU tensors at R=16 (a shape of the
    one-launch path): the JAX ensemble's vmap of slice_field to the bit,
    each member its own scale, no launch and no one-launch call
    counted."""
    R, N = 16, 32
    rng = np.random.default_rng(32)
    x = 0.875 + 0.01 * (rng.random((R, N, N)) - 0.5)
    x[1] *= 1e-3
    x[-1] = 0.0
    K.reset_launches()
    got, scale = K.slice_field_members(torch.from_numpy(x), n_slices)
    assert K.launches['slice_field_members'] == 0
    assert K.one_launch['slice_field_members'] == 0
    want, jscale = jax.vmap(lambda m: jo.slice_field(m, n_slices))(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(
        1, 0, 2, 3))
    for r in range(R):
        _assert_scale(scale[r], jscale[r])
    assert float(scale[-1]) == 2.0 ** -90


# ----------------------------------------------------------------------
# the card's probes (benchmarks/stats_sass.py, benchmarks/slice_paths.py)
# ----------------------------------------------------------------------

def _sass(lines):
    """(address, text) of SASS lines 16 bytes apart."""
    return [(16 * i, t) for i, t in enumerate(lines)]


@pytest.mark.parametrize('vec,copies', [(1, 2), (1, 3), (2, 4), (2, 6)])
def test_stats_sass_counts_the_longest_loop_per_element(vec, copies):
    """stats_sass.loop_counts: the longest backward branch's body, its
    static counts by pipe, and per element the body less the division
    copies beyond 2 V, over V."""
    from chsimpy_tpu_torch.benchmarks import stats_sass as ss
    div = ['MUFU.RCP64H R2, R3', 'DFMA R4, R2, R4, R6',
           '@P0 CALL.REL.NOINC 0x1000', 'BSYNC B0']
    head = ['IMAD R0, R1, R2, R3', 'BRA 0x10']      # a short loop first
    body = (['DADD R4, R4, R6', 'FSETP.GT P0, PT, R1, R2, PT', 'I2F R5, R6']
            + div * copies + ['DMUL R8, R8, R4', 'ISETP.NE P1, R0, R9'])
    lines = head + body + [f'@P1 BRA 0x{16 * len(head):x}', 'EXIT']
    per, static = ss.loop_counts(_sass(lines), vec)
    assert static == {'fp64': 2 + 1 * copies, 'fp32': 1, 'mufu': copies,
                      'conversion': 1, 'all': len(body) + 1}
    extra = copies - 2 * vec
    assert per['fp64'] == pytest.approx((2 + copies - extra) / vec)
    assert per['mufu'] == pytest.approx((copies - extra) / vec)
    assert per['all'] == pytest.approx((len(body) + 1 - 4 * extra) / vec)


def test_slice_paths_needs_the_card():
    """benchmarks/slice_paths.py times the card: without CUDA it exits
    with a message and prints nothing."""
    from chsimpy_tpu_torch.benchmarks import slice_paths
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(SystemExit, match='no CUDA device'):
        slice_paths.main(['--shapes', '1x32'])
