"""The grid-sharded kernels of chsimpy_tpu_torch (K7 ``local_band_sums``,
K8 ``chemical_potential_sharded``, ``fused_stats_sharded``) and the grid
DCTs against the JAX package, on the CPU.

K7's plain version is held to the Pallas kernel it stands beside
(``_local_band_sums``, interpret mode) on the blocks of 2x2, 1x4 and 4x1
meshes with numpy-built halos.  The rest runs in one 2x2 world of gloo
ranks (``spawn_grid``) against the JAX functions on a 2x2 mesh of the
virtual CPU devices.  Bounds: float64 1e-13 relative for the block sums
and the transforms (only the summation order differs), 1e-12 for the
finalized statistics; float32 1e-5 (the Pallas kernel sums each band in
float32, the port in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chsimpy_tpu as ct
from chsimpy_tpu.derived import Derived as JDerived
from chsimpy_tpu.ops import pallas_kernels as pk
from chsimpy_tpu.parallel.mesh import make_grid_mesh
from chsimpy_tpu.parallel.sharding import grid_sharding

from chsimpy_tpu_torch import Parameters
from chsimpy_tpu_torch.core import stepper as tst
from chsimpy_tpu_torch.derived import Derived
from chsimpy_tpu_torch.ops import dct as dct_ops
from chsimpy_tpu_torch.ops import kernels as K
from chsimpy_tpu_torch.parallel.distributed import spawn_grid
from chsimpy_tpu_torch.parallel.workers import run_tasks

torch.set_num_threads(2)

KAPPA = 0.00029891134208698706
N = 64
NPDT = {'float32': np.float32, 'float64': np.float64}
TDT = {'float32': torch.float32, 'float64': torch.float64}


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _phys():
    p = ct.Parameters()
    p.N = N
    p.kappa_tilde = KAPPA
    d = JDerived.from_params(p)
    return dict(RT=d.RT, BRT=d.BRT, A0=d.A0, A1=d.A1, delx=d.delx, B=p.B,
                threshold=p.threshold, Amr=d.Amr, L=p.L,
                kappa_tilde=d.kappa_tilde)


PHYS = _phys()


def _fields(dtype, seed=5):
    rng = np.random.default_rng(seed)
    U = (0.875 + 0.01 * (rng.random((N, N)) - 0.5)).astype(NPDT[dtype])
    Uinv = 1 - U
    E = (PHYS['RT'] * np.log(U / Uinv) - PHYS['BRT']
         + (PHYS['A0'] + PHYS['A1'] * (Uinv - U)) * (Uinv - U)
         - 2 * PHYS['A1'] * U * Uinv).astype(NPDT[dtype])
    return U, E


def _halo_np(F, i, j, bn, bw):
    """The edge vectors of block (i, j), edge-replicated at the global
    boundary (``_neighbor_views``)."""
    r0, r1, c0, c1 = i * bn, (i + 1) * bn, j * bw, (j + 1) * bw
    up = F[r0 - 1 if r0 > 0 else r0, c0:c1]
    dn = F[r1 if r1 < N else r1 - 1, c0:c1]
    lf = F[r0:r1, c0 - 1 if c0 > 0 else c0]
    rt = F[r0:r1, c1 if c1 < N else c1 - 1]
    return up, dn, lf, rt


def _shifted(Ub, up, dn, lf, rt):
    """The four shifted (bn, W) views the Pallas kernel takes."""
    return (np.concatenate([up[None], Ub[:-1]], 0),
            np.concatenate([Ub[1:], dn[None]], 0),
            np.concatenate([lf[:, None], Ub[:, :-1]], 1),
            np.concatenate([Ub[:, 1:], rt[:, None]], 1))


def _kw():
    return dict(delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'],
                threshold=PHYS['threshold'])


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('shape', [(2, 2), (1, 4), (4, 1)])
def test_local_band_sums_ref_matches_pallas(shape, dtype):
    mx, my = shape
    bn, bw = N // mx, N // my
    U, E = _fields(dtype)
    rtol = 1e-13 if dtype == 'float64' else 1e-5
    total = np.zeros(5)
    for i in range(mx):
        for j in range(my):
            Ub = U[i * bn:(i + 1) * bn, j * bw:(j + 1) * bw]
            Eb = E[i * bn:(i + 1) * bn, j * bw:(j + 1) * bw]
            halo = _halo_np(U, i, j, bn, bw)
            want = np.asarray(pk._local_band_sums(
                N, jnp.asarray(Ub), *map(jnp.asarray, _shifted(Ub, *halo)),
                jnp.asarray(Eb), PHYS['A0'], PHYS['A1'], i * bn, j * bw,
                **_kw()))[0, :5].astype(np.float64)
            got = K.local_band_sums(
                torch.tensor(Ub), *map(torch.tensor, halo), torch.tensor(Eb),
                PHYS['A0'], PHYS['A1'], i * bn, j * bw, N=N,
                **_kw()).numpy()
            assert got[3] == want[3], (i, j)          # the count, exact
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
            total += got
    # the blocks' sums add up to K3's plain version on the whole field
    whole = K.stats_sums(torch.tensor(U), torch.tensor(E), PHYS['A0'],
                         PHYS['A1'], **_kw()).numpy()
    np.testing.assert_allclose(total, whole, rtol=1e-13 if dtype ==
                               'float64' else 1e-12, atol=0)


def test_local_band_sums_checks_its_halo():
    U = torch.ones((8, 4), dtype=torch.float64) * 0.875
    row, col = torch.ones(4, dtype=torch.float64), \
        torch.ones(8, dtype=torch.float64)
    with pytest.raises(ValueError, match='up_row'):
        K.local_band_sums(U, col, row, col, col, None, 0.0, 0.0, 0, 0, N=16,
                          **_kw())
    with pytest.raises(ValueError, match='does not lie'):
        K.local_band_sums(U, row, row, col, col, None, 0.0, 0.0, 12, 0,
                          N=16, **_kw())


# ----------------------------------------------------------------------
# one 2x2 world for the rest of the module
# ----------------------------------------------------------------------

def _tasks():
    phys = {k: PHYS[k] for k in ('RT', 'BRT', 'A0', 'A1', 'delx', 'B',
                                 'threshold', 'Amr', 'L', 'kappa_tilde')}
    tasks = []
    for dtype in ('float64', 'float32'):
        U, E = _fields(dtype)
        tasks += [('fused_stats', dict(U=U, E=E, dtype=dtype, phys=phys)),
                  ('fused_stats', dict(U=U, E=None, dtype=dtype,
                                       phys=phys)),
                  ('chemical_potential', dict(U=U, dtype=dtype, phys=phys)),
                  ('dcts', dict(U=U, dtype=dtype))]
    return tasks


@pytest.fixture(scope='module')
def world():
    res = spawn_grid(run_tasks, (2, 2), backend='gloo', device='cpu',
                     args=(_tasks(),), threads=1, timeout=300)
    out = {}
    for k, dtype in enumerate(('float64', 'float32')):
        per_rank = [r[4 * k:4 * k + 4] for r in res]
        out[dtype] = {'stats': [r[0] for r in per_rank],
                      'stats_prepare': [r[1] for r in per_rank],
                      'mu': [r[2] for r in per_rank],
                      'dcts': [r[3] for r in per_rank]}
    return out


def _jax_mesh_inputs(dtype):
    mesh = make_grid_mesh((2, 2))
    U, E = _fields(dtype)
    sh = grid_sharding(mesh)
    return mesh, jax.device_put(jnp.asarray(U), sh), \
        jax.device_put(jnp.asarray(E), sh)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_fused_stats_sharded_matches_jax(world, dtype):
    mesh, U, E = _jax_mesh_inputs(dtype)
    want = [float(v) for v in pk.fused_stats_sharded(
        mesh, U, E, PHYS['A0'], PHYS['A1'], PHYS['kappa_tilde'],
        delx=PHYS['delx'], RT=PHYS['RT'], B=PHYS['B'], Amr=PHYS['Amr'],
        L=PHYS['L'], threshold=PHYS['threshold'])]
    ranks = world[dtype]['stats']
    # every rank holds the same bits
    assert all(r == ranks[0] for r in ranks)
    got = ranks[0]
    rtol = 1e-12 if dtype == 'float64' else 1e-5
    assert got[5] == want[5]                                 # SA
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_fused_stats_sharded_prepare_path_matches_single_device(world,
                                                               dtype):
    """E None (the prepare path: L2 = 0) against the port's own
    single-device statistics (the JAX package's prepare path runs no
    Pallas kernel)."""
    p = Parameters(N=N, kappa_tilde=KAPPA)
    d = Derived.from_params(p)
    cfg = tst.StepConfig(N=N, dtype=dtype, RT=PHYS['RT'], BRT=PHYS['BRT'],
                         B=PHYS['B'], Amr=PHYS['Amr'], L=PHYS['L'],
                         delx=PHYS['delx'], delx2=d.delx2, M_tilde=p.M_tilde,
                         threshold=PHYS['threshold'], A0=PHYS['A0'],
                         A1=PHYS['A1'], kappa_tilde=PHYS['kappa_tilde'])
    consts = tst.make_consts(cfg, p.delt)
    U, _ = _fields(dtype)
    want = [t.item() for t in tst._stats(cfg, consts, torch.tensor(U))]
    ranks = world[dtype]['stats_prepare']
    assert all(r == ranks[0] for r in ranks)
    assert ranks[0][3] == 0.0                                # L2
    np.testing.assert_allclose(ranks[0], want,
                               rtol=1e-13 if dtype == 'float64' else 1e-12,
                               atol=0)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_chemical_potential_sharded_matches_jax(world, dtype):
    mesh, U, _ = _jax_mesh_inputs(dtype)
    want = np.asarray(pk.chemical_potential_sharded(
        mesh, U, PHYS['RT'], PHYS['BRT'], PHYS['A0'], PHYS['A1']))
    for got in world[dtype]['mu']:
        assert got.shape == (N, N)
        if dtype == 'float64':
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
        else:
            # the chain cancels ~1e2 terms down to O(1): ~100 eps absolute
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and K1's plain version on the whole field, to the bit: the block
    # computes what the whole field computes
    whole = K.chemical_potential_ref(torch.tensor(_fields(dtype)[0]),
                                     PHYS['RT'], PHYS['BRT'], PHYS['A0'],
                                     PHYS['A1']).numpy()
    assert np.array_equal(world[dtype]['mu'][0], whole)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_grid_dcts_match_single_device(world, dtype):
    U, _ = _fields(dtype)
    C = dct_ops.dct_matrix(N, TDT[dtype])
    want_f = dct_ops.dct2(torch.tensor(U), C).numpy()
    want_i = dct_ops.idct2(torch.tensor(U), C).numpy()
    tol = 1e-13 if dtype == 'float64' else 1e-5
    for got_f, got_i in world[dtype]['dcts']:
        np.testing.assert_allclose(got_f, want_f, rtol=0,
                                   atol=tol * np.abs(want_f).max())
        np.testing.assert_allclose(got_i, want_i, rtol=0,
                                   atol=tol * np.abs(want_i).max())
