"""What the port decides on the host for two kernels, on the CPU: the
grid K3's fold mode takes (``stats_tile`` with ``fold=True``), and the
launches K5 sharded issues (``slice_field_sharded``,
``slice_field_members_sharded``).

K3's fold mode walks the natural rows of a field stored in the level-1
folded layout.  Where N/2 allows K3's vector it takes K3's tile, so its
sums are the natural field's to the bit (held on the card by
``chip_smoke.py`` phase 16 (a)); where the fixed tile stays (N >= 2048),
no band and no block's columns straddle N/2, so every band but the one
that ends at N/2 walks its stored rows by one signed step a row.

K5 sharded is two launches (the max pass, then the slice pass, which
forms the scale from the world max itself) around one all-reduce MAX, or
one launch where the caller gives the world max.  Its wrapper is run here
with the launches and the collective stubbed, so the sequence it issues
is read without a card; the planes themselves are held to the plain
version and the whole-field K5 on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 15 (a), (j)).
"""

import numpy as np
import pytest
import torch

from chsimpy_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

ALIGNED = 1 << 20
FOLD_NS = [512, 1000, 1002, 1024, 2048, 4096]


# ----------------------------------------------------------------------
# K3's fold mode: its grid
# ----------------------------------------------------------------------

def _natural(N, itemsize, *addresses):
    return K.stats_tile(N, N, N, 0, 0, itemsize, *addresses)


def _folded(N, itemsize, *addresses):
    return K.stats_tile(N, N, N, 0, 0, itemsize, *addresses, fold=True)


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', FOLD_NS)
def test_the_fold_keeps_k3s_grid_where_the_bits_must_match(N, itemsize):
    """The fold's (V, band, blocks) is natural K3's wherever N/2 is a
    multiple of K3's vector width (the sums are then the natural field's
    to the bit); elsewhere the one-column grid (N=1002: N/2 odd)."""
    natural = _natural(N, itemsize, ALIGNED)
    folded = _folded(N, itemsize, ALIGNED)
    if (N // 2) % natural[0] == 0:
        assert folded == natural
    else:
        assert N == 1002 and folded[0] == 1
        assert folded == _natural(N, itemsize, ALIGNED + 4)
    assert K.stats_grid(N, itemsize, ALIGNED, fold=True) == (folded[0],
                                                             folded[2])


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', FOLD_NS)
def test_a_folded_members_grid_is_the_single_folded_fields(N, itemsize):
    """K3_members' fold mode takes the single field's fold grid: a
    contiguous stack's members start N^2 * itemsize bytes apart, so the
    stack's address gives the vector a fresh field gets."""
    single = _folded(N, itemsize, ALIGNED)
    for R in (2, 4, 16):
        stack_addresses = [ALIGNED + r * N * N * itemsize for r in range(R)]
        assert all(_folded(N, itemsize, a) == single
                   for a in stack_addresses)


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('N', [2048, 4096])
def test_where_the_fixed_tile_stays_no_block_straddles_the_fold(N,
                                                                itemsize):
    """At N >= 2048 the fold keeps the fixed tile: every band of rows and
    every block's columns lie on one side of N/2, so only the band that
    ends at N/2 (its look-ahead row is stored at N-1) maps its rows one
    by one; every other band steps through its stored rows."""
    vec, band, blocks = _folded(N, itemsize, ALIGNED)
    assert (vec, band) == K.fixed_stats_tile(N, N, itemsize, ALIGNED)[:2]
    half = N // 2
    cols = K.STATS_THREADS * vec
    assert half % cols == 0 and half % band == 0
    bands = [(r0, min(r0 + band, N)) for r0 in range(0, N, band)]
    stepped = [b for b in bands if b[0] >= half or b[1] < half]
    assert len(bands) - len(stepped) == 1
    assert blocks == len(bands) * (N // cols)


# ----------------------------------------------------------------------
# K5 sharded: the launches its wrapper issues
# ----------------------------------------------------------------------

class _Mesh:
    """Stands for a grid of two ranks: the stubbed all-reduce returns
    what it is given."""
    size = 2


@pytest.fixture
def stubbed(monkeypatch):
    """K5 sharded's wrapper with its launches recorded, not made: a CPU
    tensor taken for a card's, and the all-reduce MAX recorded and
    returned as given."""
    calls, reduces = [], []

    def call(name, dtype, *args):
        calls.append((name, args))

    def world_max(mesh, t):
        reduces.append(t)
        return t

    monkeypatch.setattr(K, '_call', call)
    monkeypatch.setattr(K, '_on_card', lambda *tensors: True)
    monkeypatch.setattr(K, '_stream', lambda: 0)
    monkeypatch.setattr(K, '_TICKETS', {})
    monkeypatch.setattr(K.coll, 'world_max', world_max)
    K.reset_launches()
    yield calls, reduces
    K.reset_launches()


def _names(calls):
    return [name for name, _ in calls]


@pytest.mark.parametrize('R', [0, 3])
def test_k5_sharded_is_the_max_pass_the_all_reduce_and_the_slice_pass(
        stubbed, R):
    """Without a given max: the max pass (max-only mode), one all-reduce
    MAX of its words, then the slice pass at the reduced words, which
    writes the scale itself; one count a call."""
    calls, reduces = stubbed
    shape = (R, 32, 8) if R else (32, 8)
    x = torch.ones(shape, dtype=torch.float64)
    f = K.slice_field_members_sharded if R else K.slice_field_sharded
    planes, scale = f(x, _Mesh(), 5)
    assert _names(calls) == ['ch_slice_max', 'ch_slice_sharded']
    members = max(R, 1)
    n = x.numel() // members
    (_, mx), (_, sl) = calls
    # x, n, R, partials, max blocks, tickets, the words, stream
    assert mx[0] == x.data_ptr() and mx[1:3] == (n, members)
    assert mx[4] == K.SLICE_SHARDED_MAX_BLOCKS and len(mx) == 8
    assert len(reduces) == 1 and reduces[0].numel() == members
    assert reduces[0].dtype == torch.float64
    assert reduces[0].data_ptr() == mx[6]
    # x, the world max's words, the scales, the planes, n, R, slices
    assert sl[0] == x.data_ptr() and sl[1] == reduces[0].data_ptr()
    assert sl[2] == scale.data_ptr() and sl[3] == planes.data_ptr()
    assert sl[4:7] == (n, members, 5)
    assert planes.shape == (5,) + shape and planes.dtype == torch.int8
    assert scale.shape == ((R,) if R else ())
    key = 'slice_field_members_sharded' if R else 'slice_field_sharded'
    assert K.launches[key] == 1
    assert sum(K.launches.values()) == 1


@pytest.mark.parametrize('R', [0, 2])
def test_a_given_max_leaves_out_the_max_pass_and_the_collective(stubbed,
                                                                 R):
    """With the world max given (the forward's column strip): the slice
    pass alone, at the given values' bits, and no all-reduce."""
    calls, reduces = stubbed
    shape = (R, 16, 6) if R else (16, 6)
    x = torch.ones(shape, dtype=torch.float64)
    amax = (torch.full((R,), 3.0, dtype=torch.float64) if R
            else torch.tensor(3.0, dtype=torch.float64))
    f = K.slice_field_members_sharded if R else K.slice_field_sharded
    planes, scale = f(x, _Mesh(), 4, amax=amax)
    assert _names(calls) == ['ch_slice_sharded'] and reduces == []
    (_, sl), = calls
    assert sl[1] == amax.data_ptr()
    assert sl[4:7] == (x.numel() // max(R, 1), max(R, 1), 4)
    assert planes.shape == (4,) + shape


def test_also_max_rides_the_one_all_reduce(stubbed):
    """``also_max`` (the inverse's DC term) joins the max's words in the
    same all-reduce; the slice pass reads the words' part of it."""
    calls, reduces = stubbed
    x = torch.ones((16, 8), dtype=torch.float64)
    also = torch.tensor([1.5, -2.0], dtype=torch.float64)
    _, _, got = K.slice_field_sharded(x, _Mesh(), 4, also_max=also)
    assert _names(calls) == ['ch_slice_max', 'ch_slice_sharded']
    assert len(reduces) == 1 and reduces[0].numel() == 3
    assert calls[1][1][1] == reduces[0].data_ptr()
    assert torch.equal(got, also)


@pytest.mark.parametrize('blocks', [K.SLICE_SHARDED_MAX_BLOCKS,
                                    K.SLICE_MAX_BLOCKS])
def test_slice_paths_times_the_max_pass_on_the_grid_it_is_given(stubbed,
                                                                blocks):
    """benchmarks/slice_paths.py --sharded sets the max pass on the
    wrapper's grid beside a whole field's: its ``max_pass`` issues the
    wrapper's launch on ``blocks`` blocks, with partials to match, and
    counts nothing."""
    from chsimpy_tpu_torch.benchmarks import slice_paths
    calls, reduces = stubbed
    x = torch.ones((3, 16, 6), dtype=torch.float64)
    bits = slice_paths.max_pass(x, 3, blocks)
    (name, mx), = calls
    assert name == 'ch_slice_max' and mx[1:3] == (16 * 6, 3)
    assert mx[4] == blocks and mx[6] == bits.data_ptr()
    assert bits.shape == (3,) and reduces == []
    assert sum(K.launches.values()) == 0


@pytest.mark.parametrize('numel,n_slices', [(4096 * 1024, 4),
                                            (2047 * 2047, 6),
                                            (4 * 512 * 128, 4)])
def test_k5_sharded_bound_is_one_read_and_the_planes(numel, n_slices):
    """roofline.slice_bound, which chip_smoke.py and slice_paths.py both
    take: the block read once and its planes written once at the card's
    memory rate (K5's operations take less time at the float64 rate)."""
    from chsimpy_tpu_torch.benchmarks import roofline
    got = roofline.slice_bound(numel, n_slices)
    assert got['bound_by'] == 'bytes'
    assert got['bound_ms'] == (numel * (8 + n_slices)
                               / roofline.HBM_BYTES_PER_S * 1e3)


def test_on_the_cpu_k5_sharded_is_the_plain_version_and_counts_nothing():
    """With no stubs, a CPU block takes the plain version at the world
    max (a one-rank grid: its own), to the bit of slice_field_ref."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.standard_normal((24, 10)))

    class One:
        size = 1

    K.reset_launches()
    planes, scale = K.slice_field_sharded(x, One(), 6)
    want, wscale = K.slice_field_ref(x, 6)
    assert torch.equal(planes, want) and torch.equal(scale, wscale)
    assert sum(K.launches.values()) == 0


# ----------------------------------------------------------------------
# benchmarks/stats_sass.py: the fold's two row loops beside the natural
# loop
# ----------------------------------------------------------------------

def test_stats_sass_finds_both_row_loops_and_the_registers():
    """row_loops: the longest loop and every loop at least half its
    length, in address order (a short loop is left out); registers:
    cuobjdump -res-usage's REG per function; fold_beside_natural pairs
    each fold instantiation with the natural one of its type and
    width."""
    from chsimpy_tpu_torch.benchmarks import stats_sass as ss
    div = ['MUFU.RCP64H R2, R3', '@P0 CALL.REL.NOINC 0x1000', 'BSYNC B0']
    lines = ['IMAD R0', 'BRA 0x0']                          # 2: short
    first = ['DADD R1'] * 3 + div * 2
    lines += first + [f'@P0 BRA 0x{16 * 2:x}']             # 10 long
    second = ['DADD R2'] + div * 2
    lines += second + [f'@P1 BRA 0x{16 * 12:x}', 'EXIT']    # 8 long
    ins = [(16 * i, t) for i, t in enumerate(lines)]
    assert ss.row_loops(ins) == [(2, 11), (12, 19)]
    per, static = ss.loop_counts(ins, 1, (12, 19))
    assert static['fp64'] == 1 and static['mufu'] == 2
    assert static['all'] == 8 and per['all'] == 8
    text = ('Resource usage:\n Function _Z3fooPf:\n  REG:68 STACK:0 '
            'SHARED:336\n Function _Z3barPd:\n  REG:64 STACK:0\n')
    assert ss.registers(text) == {'_Z3fooPf': 68, '_Z3barPd': 64}
    rows = [dict(dtype='float32', V=4, halo=h, fold=f, registers=r,
                 row_loops_all_per_element=a)
            for h, f, r, a in ((False, False, 64, [144.6]),
                               (True, False, 64, [154.4]),
                               (False, True, 66, [146.0, 149.0]))]
    assert ss.fold_beside_natural(rows) == [{
        'fold_beside_natural': 'float32 V=4',
        'all_per_element': {'natural': [144.6], 'fold': [146.0, 149.0]},
        'registers': {'natural': 64, 'fold': 66}}]
