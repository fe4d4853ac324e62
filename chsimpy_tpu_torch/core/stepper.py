"""The Cahn-Hilliard time step and the chunk runner.

Port of ``chsimpy_tpu/core/stepper.py`` for the slices the port runs: fixed
or adaptive ``delt``, per-step jitter, the matmul, split and FFT DCT routes
and the float64 ozaki route on one device, the matmul and ozaki routes on
a grid mesh of ranks (``mesh``: each rank steps its block of the field),
the split and ozaki routes on the pencil layout of a mesh (``cfg.pencil``:
each rank holds a column block of the field and a row block of the
spectral image, ``parallel/mesh.py``), ``full_sim`` and the energy early
stop, the ``time_max`` limit and the NaN guard, with the JAX package's
float32 knobs: the product precision of the transforms (``matmul_precision``
and ``fwd_matmul_precision``: full float32, 3xTF32 by the GEMM kernel K6,
or one TF32 pass, ``ops/dct.py``), the banded inverse (``inv_band``), the
coefficients rebuilt in the update (``otf_coeffs``: kernel K12) and the
level-1 folded field of the split route (``fold_field``: K3's fold mode).
One step does, in order:

  nonlinear term (kernel K1)
  -> adaptive delt and coefficient grids rebuilt (``adaptive_time``)
  -> forward 2-D DCT -> semi-implicit spectral update (K2; K12 under
     ``otf_coeffs``)
  -> inverse 2-D DCT -> jitter (the Sobol points by K9, the threefry
     stream by K10 on the card)
  -> field sums (K3) and Σ|U − mean| (K4), finalized in float64
  -> timedata row and early-stop predicate.

The DCTs are ``torch.matmul`` products on the matmul route, folded block
products in the permuted spectral basis on the split route, real FFTs
(``torch.fft``) on the FFT route (``ops/dct.py``), and exact int8 products
on the ozaki route (``ops/ozaki.py``, slicing kernel K5).

The JAX package runs a chunk of steps in a ``lax.while_loop`` that exits at
the stop.  Here a chunk is a Python loop of steps that waits for the host
only every ``STOP_POLL`` steps, to leave the chunk once the run has stopped
(every member of a batch): every per-step scalar is a 0-d device tensor.
The stop is made exact by a device flag; the exit only saves steps.
``active`` (no stop yet) and ``go`` (active and inside the time limit)
are 0-d booleans; every carried field is selected by them
(``torch.where``), and the step and row counters advance by ``go``.
After the trigger the steps to the next poll compute results that are
thrown away, leaving ``U``, ``hat_U``, the counters, the bookkeeping and
the rows unchanged.  The row buffer is
written in place at index ``rows`` on every step; a discarded step's row
lands beyond the rows the host reads.  A discarded step still takes its
jitter slab (the host drew the chunk's slabs before it ran, as the JAX
package does); in the ``device`` mode it keeps its key (K10 writes the
key back unsplit where ``go`` is false), so the stream advances only on
the steps the JAX package's loop runs.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import coeffs as coeffs_ops
from ..ops import dct as dct_ops
from ..ops import kernels as K
from ..ops import ozaki as ozaki_ops
from ..ops.sobol import MASK32
from ..parallel import collectives as coll
from ..parallel.sharding import block_slices
from ..tracing import span, spanned
from .state import (STOP_ENERGY, STOP_NAN, STOP_NONE, STOP_TIME_LIMIT,
                    SolverState)

_DTYPES = {'float32': torch.float32, 'float64': torch.float64}

ADAPT_ALPHA = 500.0 / 2 ** 3  # chsimpy/solver.py:182 of the reference
# none | stream (host, reference-exact) | static (simplex) | device
# (K10, the JAX package's threefry stream, not reference-exact) |
# device_sobol (K9, bit-equal to stream)
JITTER_MODES = ('none', 'stream', 'static', 'device', 'device_sobol')
# steps between the chunk runners' looks at the stop flag (a host sync): a
# run that stops early runs to the next multiple of it in its chunk, not
# to the chunk's end
STOP_POLL = 64


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of the step (the fields of the JAX
    ``StepConfig`` that the slice uses)."""
    N: int
    dtype: str                  # 'float64' | 'float32'
    RT: float
    BRT: float
    B: float
    Amr: float
    L: float
    delx: float
    delx2: float
    M_tilde: float
    threshold: float
    A0: float = 0.0
    A1: float = 0.0
    kappa_tilde: float = 0.0
    # stepping: params.delt is the floor of the adaptive delt
    delt_base: float = 3e-8
    delt_max: float = 9e-8
    adaptive_time: bool = False
    time_limit: Optional[float] = None  # seconds of simulated time
    full_sim: bool = False
    # per-step jitter amplitude (None: off) and its source (JITTER_MODES)
    jitter: Optional[float] = None
    jitter_mode: str = 'none'
    # 'matmul' | 'split' | 'fft' | 'ozaki' (float64)
    transform_backend: str = 'matmul'
    # fold depth of the split route; None resolves by size
    # (split_levels_resolved)
    split_levels: Optional[int] = None
    # the split route's field kept level-1 folded between the transforms
    # (one device): the four level-1 reversals of a step go, K3 reads the
    # field through the fold map (its sums the natural field's to the
    # bit), and at equal split_levels U is the natural run's to the bit
    fold_field: bool = False
    # float32 product precision of the transforms ('highest', 'high',
    # 'default': ops/dct.py), of the forward alone (None: the same), and
    # the banded inverse's first tail index (None: uniform); float64
    # products ignore them
    matmul_precision: str = 'highest'
    fwd_matmul_precision: Optional[str] = None
    inv_band: Optional[int] = None
    # the update's coefficients rebuilt from the eigenvalue axis on every
    # step (K12) in place of the stored grids
    otf_coeffs: bool = False
    # ozaki route layout, resolved by the solver as in the JAX package:
    # level-1 fold in natural layout (N < 1024), or the recursive fold in
    # the permuted basis (levels > 0, N >= 1024; overrides ozaki_fold)
    ozaki_fold: bool = False
    ozaki_rfold_levels: int = 0
    # (stage 1, stage 2) pair cutoffs of the forward transform and of the
    # rfold inverse; None = the untrimmed (5, 7).  The level-1 fold and the
    # unfolded inverses always keep (5, 7)
    ozaki_fwd_pairs: Optional[tuple] = None
    ozaki_inv_pairs: Optional[tuple] = None
    # the split or ozaki route on the pencil layout of the mesh (the field
    # in column blocks, the spectral image in row blocks); False on one
    # device and on the grid layout
    pencil: bool = False

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def fwd_precision(self) -> str:
        return self.fwd_matmul_precision or self.matmul_precision

    @property
    def band_frac(self) -> Optional[float]:
        """``inv_band`` as a fraction of N (the split blocks' cut)."""
        return self.inv_band / self.N if self.inv_band else None

    @property
    def split_levels_resolved(self) -> int:
        """The JAX package's depth table (``chsimpy_tpu/core/stepper.py:
        146-158``): 5 at N >= 4096 under the folded layout, 4 at N >=
        4096, 3 at N >= 2048, else 2 (divisibility allowing)."""
        if self.split_levels is not None:
            return self.split_levels
        if self.N >= 4096 and self.N % 32 == 0 and self.fold_field:
            return 5
        if self.N >= 4096 and self.N % 16 == 0:
            return 4
        if self.N >= 2048 and self.N % 8 == 0:
            return 3
        return 2

    @property
    def spectral_levels(self) -> int:
        """Depth of the permuted spectral basis (0: natural order)."""
        if self.transform_backend == 'split':
            return self.split_levels_resolved
        if self.transform_backend == 'ozaki':
            return self.ozaki_rfold_levels
        return 0


_FOLD_KEYS = ('CeS', 'CoS', 'CeTS', 'CoTS')


def make_consts(cfg: StepConfig, delt: float, device='cpu') -> dict:
    """DCT matrix (or, on the ozaki route, its int8 slice stacks), the
    split route's block tree, eigenvalue grid and axis, update coefficient
    grids, and the physics scalars.  Built on the CPU with the JAX
    package's operations and order (float64 bit-identical to its
    ``make_consts``, the same keys), then moved to ``device``.  The split
    and ozaki rfold routes work in the permuted basis, so leig and eaxis
    are permuted before the grids are made."""
    dtype = cfg.tdtype
    kt = cfg.kappa_tilde
    N = cfg.N
    z8 = torch.zeros((0,), dtype=torch.int8)
    host = {'C': torch.zeros((0,), dtype=dtype), 'Cs': z8, 'CsT': z8,
            **{k: z8 for k in _FOLD_KEYS}}
    rf = tree = ()
    ozaki = cfg.transform_backend == 'ozaki'
    L = cfg.spectral_levels
    if not ozaki:
        host['C'] = dct_ops.dct_matrix(N, dtype)
        if cfg.transform_backend == 'split':
            tree = dct_ops.split_tree(N, L, dtype, device)
    elif L:
        rf = ozaki_ops.dct_rfold_slices(N, L, device)[0]
    elif cfg.ozaki_fold:
        fs = ozaki_ops.dct_fold_slices(N, device)
        host.update({k: fs[k] for k in _FOLD_KEYS})
    else:
        host['Cs'], host['CsT'], _ = ozaki_ops.dct_slices(N, device)
    leig = coeffs_ops.eigenvalues(N, dtype)
    eaxis = coeffs_ops.eigenvalue_axis(N)
    if L:
        leig = torch.as_tensor(dct_ops.split_permute_grid(
            leig.numpy(), N, L)).to(dtype)
        eaxis = dct_ops.split_permute_axis(eaxis, N, L)
    CHeig, Seig = coeffs_ops.get_coefficients(
        leig, torch.tensor(kt, dtype=dtype), torch.tensor(delt, dtype=dtype),
        cfg.delx2)
    host.update(leig=leig, eaxis=torch.tensor(eaxis, dtype=dtype),
                CHeig=CHeig, Seig=Seig)
    consts = {k: v.to(device) for k, v in host.items()}
    consts.update(A0=float(cfg.A0), A1=float(cfg.A1), kappa_tilde=float(kt),
                  rf=rf, tree=tree)
    return consts


def _pairs(pairs) -> tuple:
    return tuple(pairs or (ozaki_ops.STAGE1_PAIR, ozaki_ops.STAGE2_PAIR))


def _fold_stacks(cfg: StepConfig, consts) -> dict:
    fs = {k: consts[k] for k in _FOLD_KEYS}
    fs['scale'] = ozaki_ops.dct_fold_scale(cfg.N)
    return fs


def field_mesh(cfg: StepConfig, mesh):
    """The layout of the field on ``mesh``: the grid's own, or on the
    pencil layout its column blocks (``field_view``).  The solvers and
    the step read the layout here alone."""
    return mesh.field_view if mesh is not None and cfg.pencil else mesh


@spanned('ch.dct2')
def dct2_route(cfg: StepConfig, consts, U, pairs=None, mesh=None,
               precision=None):
    """Forward 2-D DCT of the configured route (the ozaki routes with the
    pair cutoffs ``pairs``; None = untrimmed), its float32 products at
    ``precision`` (None: full float32, as the JAX package's entry
    transform).  On a grid mesh U is this rank's block and the route
    matmul or ozaki; on the pencil layout U is a column block and the
    result a row block (split or ozaki); under ``fold_field`` U is
    level-1 folded."""
    tb = cfg.transform_backend
    if mesh is not None and cfg.pencil:
        if tb == 'split':
            return dct_ops.dct2_split_perm_pencil(U, consts['tree'], mesh,
                                                  precision)
        s1, s2 = _pairs(pairs)
        return ozaki_ops.dct2_ozaki_pencil(
            U, consts['Cs'], consts['CsT'], ozaki_ops.dct_scale(cfg.N),
            mesh, s1=s1, s2=s2)
    if mesh is not None and tb == 'ozaki':
        s1, s2 = _pairs(pairs)
        return ozaki_ops.dct2_ozaki_grid(
            U, consts['ozaki_grid'], ozaki_ops.dct_scale(cfg.N), mesh,
            s1=s1, s2=s2)
    if mesh is not None:
        return dct_ops.dct2_grid(U, consts['C'], mesh, precision)
    if tb == 'split':
        if cfg.fold_field:
            return dct_ops.dct2_split_perm_folded(U, consts['tree'],
                                                  precision)
        return dct_ops.dct2_split_perm(U, consts['tree'], precision)
    if tb == 'fft':
        return dct_ops.dct2_fft(U)
    if tb != 'ozaki':
        return dct_ops.dct2(U, consts['C'], precision)
    s1, s2 = _pairs(pairs)
    N, L = cfg.N, cfg.ozaki_rfold_levels
    if L:
        return ozaki_ops.dct2_ozaki_rfold(
            U, consts['rf'], ozaki_ops.dct_rfold_scale(N, L), L, s1=s1, s2=s2)
    if cfg.ozaki_fold:
        return ozaki_ops.dct2_ozaki_fold(U, _fold_stacks(cfg, consts),
                                         s1=s1, s2=s2)
    return ozaki_ops.dct2_ozaki(U, consts['Cs'], consts['CsT'],
                                ozaki_ops.dct_scale(N), s1=s1, s2=s2)


@spanned('ch.idct2')
def idct2_route(cfg: StepConfig, consts, X, mesh=None):
    """Inverse 2-D DCT of the configured route (on the pencil layout from
    a row block to a column block; the ozaki inverse untrimmed, as the
    JAX package's unfolded inverse), its float32 products at the run's
    precision, banded by ``inv_band``, folded under ``fold_field``."""
    tb = cfg.transform_backend
    prec = cfg.matmul_precision
    if mesh is not None and cfg.pencil:
        if tb == 'split':
            return dct_ops.idct2_split_perm_pencil(X, consts['tree'], mesh,
                                                   prec, cfg.band_frac)
        return ozaki_ops.idct2_ozaki_pencil(
            X, consts['Cs'], consts['CsT'], ozaki_ops.dct_scale(cfg.N), mesh)
    if mesh is not None and tb == 'ozaki':
        return ozaki_ops.idct2_ozaki_grid(
            X, consts['ozaki_grid'], ozaki_ops.dct_scale(cfg.N), mesh)
    if mesh is not None:
        return dct_ops.idct2_grid(X, consts['C'], mesh, prec, cfg.inv_band)
    if tb == 'split':
        if cfg.fold_field:
            return dct_ops.idct2_split_perm_folded(X, consts['tree'], prec,
                                                   cfg.band_frac)
        return dct_ops.idct2_split_perm(X, consts['tree'], prec,
                                        cfg.band_frac)
    if tb == 'fft':
        return dct_ops.idct2_fft(X)
    if tb != 'ozaki':
        if cfg.inv_band:
            return dct_ops.idct2_banded(X, consts['C'], cfg.inv_band, prec)
        return dct_ops.idct2(X, consts['C'], prec)
    N, L = cfg.N, cfg.ozaki_rfold_levels
    if L:
        s1, s2 = _pairs(cfg.ozaki_inv_pairs)
        return ozaki_ops.idct2_ozaki_rfold(
            X, consts['rf'], ozaki_ops.dct_rfold_scale(N, L), L, s1=s1, s2=s2)
    if cfg.ozaki_fold:
        return ozaki_ops.idct2_ozaki_fold(X, _fold_stacks(cfg, consts))
    return ozaki_ops.idct2_ozaki(X, consts['Cs'], consts['CsT'],
                                 ozaki_ops.dct_scale(N))


@spanned('ch.mu')
def _nonlinear_term(cfg: StepConfig, consts, U, mesh=None):
    """Shifted nonlinear chemical potential EnergieEut (kernel K1; K8 on
    a grid mesh's block)."""
    if mesh is not None:
        return K.chemical_potential_sharded(mesh, U, cfg.RT, cfg.BRT,
                                            consts['A0'], consts['A1'])
    return K.chemical_potential(U, cfg.RT, cfg.BRT, consts['A0'],
                                consts['A1'])


@spanned('ch.stats')
def _stats(cfg: StepConfig, consts, U, EnergieEut=None, mesh=None):
    """Energy functionals and field statistics from the five kernel sums
    (K3) and Σ|U − mean| (K4), finalized in float64 on the device as in
    ``_stats_fast``.  Returns (E, E2, PS, L2, Ra, SA), 0-d float64 tensors;
    ``EnergieEut=None`` (prepare path) gives L2 = 0.  On a grid mesh U is
    this rank's block: K7 and K4 per block, the same values on every rank
    (``fused_stats_sharded``; on the pencil layout K7 on the column block
    with left and right halos only)."""
    mesh = field_mesh(cfg, mesh)
    if mesh is not None:
        return K.fused_stats_sharded(
            mesh, U, EnergieEut, consts['A0'], consts['A1'],
            consts['kappa_tilde'], delx=cfg.delx, RT=cfg.RT, B=cfg.B,
            Amr=cfg.Amr, L=cfg.L, threshold=cfg.threshold)
    N = cfg.N
    n2 = float(N * N)
    Lsq = cfg.L ** 2
    f64 = torch.float64
    sums = K.stats_sums(U, EnergieEut, consts['A0'], consts['A1'],
                        delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                        threshold=cfg.threshold, fold=cfg.fold_field)
    E2 = 0.5 * cfg.Amr * consts['kappa_tilde'] * Lsq * (sums[1] / n2)
    E = cfg.Amr * Lsq * (sums[0] / n2) + E2
    SA = sums[3] / n2
    L2 = torch.sqrt(sums[4]) / n2
    meanU = (sums[2] / n2).to(U.dtype)
    PS = K.absdev_sum(U, meanU) / n2
    # Ra: one mid row, O(N) — plain torch, as in the JAX package
    mid = _mid_row(cfg, U)
    Ra = torch.mean(torch.abs(mid - torch.mean(mid))).to(f64)
    return E, E2, PS, L2, Ra, SA


def _mid_row(cfg: StepConfig, U):
    """Row N/2+1 of the field (of each member of a stack) in the natural
    column order.  Under ``fold_field`` it is stored at row N-2
    (``chsimpy_tpu/core/stepper.py:419``), its right half reversed:
    unfolded here (O(N)), so Ra is the natural run's to the bit."""
    N = cfg.N
    if cfg.fold_field:
        return dct_ops.fold_cols(U[..., N - 2, :])
    return U[..., N // 2 + 1, :]


def prepare_row0(cfg: StepConfig, consts, U, mesh=None):
    """Step-0 energies for prepare(): (E, E2, Ra, PS) as 0-d f64 tensors."""
    E, E2, PS, _, Ra, _ = _stats(cfg, consts, U, None, mesh)
    return E, E2, Ra, PS


def entry_dct2(cfg: StepConfig, consts, U, mesh=None):
    """Spectral image of U, recomputed at every solve entry, in the
    route's spectral layout (the ozaki routes untrimmed, the float32
    products full float32: once per entry, accuracy is free here)."""
    return dct2_route(cfg, consts, U, mesh=mesh)


def adapted_delt(cfg: StepConfig, s: SolverState, EnergieEut, mesh=None):
    """The adaptive time step (``chsimpy_tpu/core/stepper.py:538-566``), a
    0-d float64 tensor: after step 500, on even steps, the smallest column
    sum of delt_max / sqrt(1 + α·|E|²) (the matrix ord=-1 norm of the
    reference), at least ``delt_base``, and blended 3:1 with the old delt
    where it would grow by more than 15%; otherwise the old delt.  The
    column sums run in the field's type.  On a grid mesh each rank sums
    its block's columns, the column strip's partials are added in rank
    order and the minimum is taken over every rank: the same bits on all
    of them (not the single device's summation order).  On the pencil
    layout each column is whole on its rank: only the minimum crosses."""
    mesh = field_mesh(cfg, mesh)
    a = EnergieEut.abs()
    x = _natural_rows(cfg, cfg.delt_max / torch.sqrt(1.0 + ADAPT_ALPHA
                                                     * (a * a)))
    colsum = torch.sum(x, dim=0)
    if mesh is not None:
        colsum = coll.rank_sum(coll.gather_x(mesh, colsum.reshape(1, -1)))
    low = torch.min(colsum)
    if mesh is not None:
        low = torch.min(coll.gather_world(mesh, low))
    delt_new = torch.clamp(low.to(torch.float64), min=cfg.delt_base)
    delt = s.delt
    blended = torch.where(delt_new / delt > 1.15,
                          0.75 * delt + 0.25 * delt_new, delt_new)
    do_adapt = (s.computed_steps > 500) & (s.computed_steps % 2 == 0)
    return torch.where(do_adapt, blended, delt)


def _natural_rows(cfg: StepConfig, x):
    """x with its rows in the natural order: under ``fold_field`` the
    bottom half un-reversed (``chsimpy_tpu/core/stepper.py:546-556``), so
    each column sum adds the natural run's terms in its order; the
    columns may stay permuted (only their minimum is taken)."""
    if not cfg.fold_field:
        return x
    n = x.shape[-2]
    return torch.cat([x[..., :n // 2, :],
                      torch.flip(x[..., n // 2:, :], (-2,))], dim=-2)


def spectral_offsets(cfg: StepConfig, mesh=None):
    """(row, column) of this rank's block of the spectral image: (0, 0)
    on one device, the grid block's on a grid mesh, the row block's on
    the pencil layout."""
    if mesh is None:
        return 0, 0
    spec = mesh.spec_view if cfg.pencil else mesh
    rows, cols = block_slices(spec, cfg.N)
    return rows.start or 0, cols.start or 0


def rebuilt_coefficients(cfg: StepConfig, consts, delt):
    """(CHeig, Seig) at ``delt`` from ``consts['leig']`` as stored (already
    permuted on the split and rfold routes; this rank's block on a mesh),
    in the field's type, on the device."""
    return coeffs_ops.get_coefficients(
        consts['leig'], K._cast(consts['kappa_tilde'], cfg.tdtype),
        delt.to(cfg.tdtype), cfg.delx2)


def _jitter(cfg: StepConfig, consts, s: SolverState, U, slab, go,
            key_out=None, mesh=None):
    """(U plus the step's jitter, the next key): jitter·(2r − 1) with r
    from the mode's source (``chsimpy_tpu/core/stepper.py:731-757``): the
    chunk's host slab (``stream``; ``static``: the one simplex slab), the
    Sobol points of the draws consumed before this step (``device_sobol``:
    K9, in place), or the threefry stream of ``s.rng_key`` (``device``:
    K10, in place, the next key into ``key_out``, kept where ``go`` is
    false; on a mesh each rank draws its block)."""
    mode = cfg.jitter_mode
    if mode == 'none':
        return U, s.rng_key
    if mode in ('stream', 'static'):
        # under fold_field the solver folded the slabs
        return U + cfg.jitter * (2.0 * slab - 1.0), s.rng_key
    if cfg.fold_field:
        # the draws land on the natural cells: the kernels add them to the
        # unfolded field, which folds back (a permutation: no rounding)
        U, key = _jitter(_natural_cfg(cfg), consts, s, dct_ops.fold1(U),
                         slab, go, key_out, mesh)
        return dct_ops.fold1(U), key
    mesh = field_mesh(cfg, mesh)
    rows, cols = ((slice(None), slice(None)) if mesh is None
                  else block_slices(mesh, cfg.N))
    if mode == 'device_sobol':
        base = (consts['sobol_base'] + (s.computed_steps - 1) * cfg.N) \
            & MASK32
        return K.sobol_jitter(U.contiguous(), consts['sobol_sv'],
                              consts['sobol_shift'], base, cfg.jitter,
                              rows.start or 0, cols.start or 0), s.rng_key
    if key_out is None:
        key_out = torch.empty_like(s.rng_key)
    U = K.threefry_jitter(U.contiguous(), s.rng_key, key_out, cfg.jitter,
                          cfg.N, rows.start or 0, cols.start or 0, go)
    return U, key_out


def _natural_cfg(cfg: StepConfig) -> StepConfig:
    return dataclasses.replace(cfg, fold_field=False)


@spanned('ch.update')
def _update(cfg: StepConfig, consts, hat_U, hat_E, Seig, CHeig, delt,
            mesh=None):
    """The spectral update: K2 with the stored (or rebuilt) grids, or K12
    with the coefficients formed from the eigenvalue axis at ``delt``
    (``otf_coeffs``) on this rank's block of the spectral image."""
    if not cfg.otf_coeffs:
        return K.spectral_update(hat_U, hat_E, Seig, CHeig)
    r0, c0 = spectral_offsets(cfg, mesh)
    return K.update_otf(hat_U, hat_E, consts['eaxis'], delt,
                        consts['kappa_tilde'], cfg.delx2, r0, c0)


@spanned('ch.step')
def _step(cfg: StepConfig, consts, s: SolverState, mesh=None, slab=None,
          key_out=None) -> SolverState:
    """One step.  ``slab``: this step's host jitter slab (``stream`` and
    ``static`` modes); ``key_out``: the ``device`` mode's buffer for the
    next key (another than ``s.rng_key``; None: a new one).  On a grid
    mesh ``s.U`` and ``s.hat_U`` are this rank's blocks, every scalar
    holds the same bits on every rank, and every collective runs on every
    step (also after the stop), so all ranks issue the same sequence."""
    f64 = torch.float64
    active = s.stop_reason == STOP_NONE
    EnergieEut = _nonlinear_term(cfg, consts, s.U, mesh)

    if cfg.adaptive_time:
        # rebuilt on every step, as the JAX step does (in the update
        # itself under otf_coeffs)
        delt = adapted_delt(cfg, s, EnergieEut, mesh)
        CHeig, Seig = ((None, None) if cfg.otf_coeffs
                       else rebuilt_coefficients(cfg, consts, delt))
    else:
        delt = s.delt
        CHeig, Seig = consts['CHeig'], consts['Seig']

    # time accumulation; the limit stops BEFORE the field update.  XLA
    # turns the JAX step's division by the static M_tilde into a product
    # with its reciprocal: the port does the same, for the same t0 bits
    tds = s.time_delta_sum + delt
    time_passed = tds * (1.0 / cfg.M_tilde)
    if cfg.time_limit is None:
        over = None
        go = active
    else:
        over = time_passed > cfg.time_limit
        go = active & ~over

    # semi-implicit spectral update, eq. (12) of Ghiass et al. (2016)
    # the forward transform of the nonlinear term rides the semi-implicit
    # damping, so the ozaki routes may trim its pair cutoffs
    hat_E = dct2_route(cfg, consts, EnergieEut, cfg.ozaki_fwd_pairs, mesh,
                       cfg.fwd_precision)
    hat_U = _update(cfg, consts, s.hat_U, hat_E, Seig, CHeig, delt, mesh)
    U = idct2_route(cfg, consts, hat_U, mesh)
    U, rng_key = _jitter(cfg, consts, s, U, slab, go, key_out, mesh)

    E, E2, PS, L2, Ra, SA = _stats(cfg, consts, U, EnergieEut, mesh)
    domtime = time_passed ** (1.0 / 3.0)
    it = s.computed_steps  # the row stores the pre-increment count
    row = torch.stack([it.to(f64), E, E2, SA, domtime, Ra, L2, PS, delt])
    s.rowbuf.index_copy_(0, s.rows.view(1), row.view(1, 9))
    steps_new = it + 1

    # NaN health guard
    has_nan = torch.isnan(row).any()

    # early-stop predicate E2[it-1] > E2[it] > E2[0]
    falls = (s.E2_prev > E2) & (E2 > s.E2_first)
    trigger = falls & ~s.skip_check
    fire = go & trigger
    if cfg.full_sim:
        skip_check = s.skip_check | fire
        stop = torch.full_like(s.stop_reason, STOP_NONE)
    else:
        skip_check = s.skip_check
        stop = torch.where(trigger, STOP_ENERGY, STOP_NONE)
    stop = torch.where(has_nan, STOP_NAN, stop)
    stop = torch.where(go, stop, s.stop_reason)
    if over is not None:
        stop = torch.where(active & over, STOP_TIME_LIMIT, stop)

    return s.replace(
        U=torch.where(go, U, s.U),
        hat_U=torch.where(go, hat_U, s.hat_U),
        # the time-limited step keeps its delt, as JAX's abort does
        delt=(torch.where(active, delt, s.delt) if cfg.adaptive_time
              else s.delt),
        time_delta_sum=torch.where(active, tds, s.time_delta_sum),
        computed_steps=s.computed_steps + go,
        skip_check=skip_check,
        stop_reason=stop.to(s.stop_reason.dtype),
        tau0=torch.where(fire, steps_new.to(f64), s.tau0),
        t0=torch.where(fire, time_passed, s.t0),
        E2_prev=torch.where(go, E2, s.E2_prev),
        rows=s.rows + go,
        rng_key=rng_key)


@spanned('ch.poll')
def _stopped(state: SolverState) -> bool:
    """True when the run (every member) has stopped: a host sync.  Every
    rank of a mesh holds the same flags, so all leave at the same step."""
    return bool((state.stop_reason != STOP_NONE).all())


@spanned('ch.chunk')
def run_chunk(cfg: StepConfig, consts, state: SolverState,
              n_iters: int, mesh=None, jitter_buf=None,
              graph: Optional['ChunkGraph'] = None) -> SolverState:
    """Up to ``n_iters`` steps, left every ``STOP_POLL`` steps once the
    run has stopped; steps after a stop leave the state unchanged (see
    the module docstring).  ``jitter_buf``: the
    ``stream`` mode's (n_iters, ...) slabs, step i taking slab i, or the
    ``static`` mode's one slab (``chsimpy_tpu/core/stepper.py:808-825``).
    The ``device`` mode's keys alternate between the two rows of a buffer
    of the chunk by step parity: a step reads one and writes the other.
    ``graph``: a :class:`ChunkGraph` of this run, which replays each whole
    ``STOP_POLL`` steps of the chunk (the rest run as they are)."""
    state, i, stopped = _replayed(graph, state, n_iters)
    if stopped:
        return state
    keys = (torch.empty((2, 2), dtype=torch.int64,
                        device=state.rng_key.device)
            if cfg.jitter_mode == 'device' else None)
    for i in range(i, n_iters):
        slab = (jitter_buf[i] if cfg.jitter_mode == 'stream'
                else jitter_buf)
        state = _step(cfg, consts, state, mesh, slab,
                      None if keys is None else keys[i % 2])
        if (i + 1) % STOP_POLL == 0 and i + 1 < n_iters and _stopped(state):
            break
    return state


def _replayed(graph: Optional['ChunkGraph'], state: SolverState,
              n_iters: int):
    """The whole ``STOP_POLL`` blocks of a chunk of ``n_iters`` steps,
    each one replay of ``graph`` (None: none) followed by the poll the
    step loop makes there: (state, steps run, True where the run has
    stopped and the chunk is left)."""
    i = 0
    while graph is not None and n_iters - i >= STOP_POLL:
        state = graph.replay(state)
        i += STOP_POLL
        if i < n_iters and _stopped(state):
            return state, i, True
    return state, i, False


_CAPTURE_LOCK = threading.Lock()
# .by_device: the stream this thread's captures run on where its current
# stream is the default stream (no graph is captured there), one a device:
# cuBLAS keeps a workspace of its own (32 MiB on the H100) for each stream
# it runs on, so a new stream a graph would hold that much more memory
_CAPTURE_STREAMS = threading.local()


def _capture_stream(dev: torch.device):
    streams = getattr(_CAPTURE_STREAMS, 'by_device', None)
    if streams is None:
        streams = _CAPTURE_STREAMS.by_device = {}
    if dev.index not in streams:
        streams[dev.index] = torch.cuda.Stream(device=dev)
    return streams[dev.index]


def graph_fits(cfg: StepConfig, device: torch.device) -> bool:
    """True where :class:`ChunkGraph` takes a run: fields on the card and
    no jitter (host slabs, the device streams' key buffers)."""
    return device.type == 'cuda' and cfg.jitter_mode == 'none'


class ChunkGraph:
    """``STOP_POLL`` steps of one run on one device, captured once as a
    CUDA graph and replayed: the steps are :func:`_step` (a single run)
    or, with ``members``, :func:`_members_step` (every member of a
    batch).  The steps' launches (~52 device operations a step of a
    float64 matmul batch, a few hundred on the ozaki route at N=512) cost
    the host one replay, so a run the host held back runs at the card's
    pace.  The kernels, their order and their inputs are the steps' own:
    a replay gives the bits of ``STOP_POLL`` steps run one by one.  The
    constants (``consts``: a batch's CHeig, A0, A1 and kappas among them)
    are read where they lie at the capture, so a graph serves the solver
    that holds them.  The
    graph reads and writes its own copy of the state; :meth:`replay`
    copies the state in and returns fresh copies of the result, on the
    current stream: runs on streams of their own (one a thread) replay
    side by side on the card.  The capture runs on the caller's stream
    (the thread's capture stream where that is the default stream), and
    the kernels' tickets and scratch in the graph are its own
    (``kernels.own_scratch``), kept as long as the graph: torch hands out
    pooled streams round-robin, so counters keyed by a stream could be
    shared with whatever later gets its handle.  One capture at a time in
    a process, each confined to its thread (other threads may go on
    launching and waiting on their own streams).  Runs that
    :func:`graph_fits` refuses, and runs on a mesh (collectives through
    the host), are not captured.  The kernels' launch counts
    (``ops/kernels.launches``, ``one_launch``) grow at each replay by
    what the capture counted, as ``STOP_POLL`` eager steps grow them; the
    capture counts in its own dicts (``kernels.own_counts``, this
    thread's), so other threads' launches and replays meanwhile count as
    ever; the eager first step before the capture advances no step and
    counts nothing.  The spans ``ch.capture`` and ``ch.replay`` time the
    construction and each replay.  ``ensemble.EnsembleSolver`` replays
    one a batch; the single run's ``Solver`` steps eagerly."""

    @spanned('ch.capture')
    def __init__(self, cfg: StepConfig, consts, state: SolverState,
                 members: bool = False):
        if not graph_fits(cfg, state.U.device):
            raise ValueError(f"a CUDA graph takes a run on the card without "
                             f"jitter, got {state.U.device}, jitter mode "
                             f"{cfg.jitter_mode!r}")
        step = _members_step if members else _step
        dev = state.U.device
        self._fields = [f.name for f in dataclasses.fields(SolverState)]
        self._in = self._copy(state)
        self._scratch: dict = {}
        here = torch.cuda.current_stream(dev)
        self._stream = (_capture_stream(dev)
                        if here == torch.cuda.default_stream(dev) else here)
        self._stream.wait_stream(here)
        # a first step as the capture will run: the graph's own tickets
        # and scratch and the libraries' handles are made here, outside it
        # (its launches counted apart and dropped: it advances no step)
        with K.own_scratch(self._scratch), K.own_counts(), \
                torch.cuda.stream(self._stream):
            step(cfg, consts, self._copy(state))
        self._graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, K.own_scratch(self._scratch), \
                K.own_counts() as self._launched, torch.cuda.graph(
                    self._graph, stream=self._stream,
                    capture_error_mode='thread_local'):
            out = self._in
            for _ in range(STOP_POLL):
                out = step(cfg, consts, out)
        self._out = out
        here.wait_stream(self._stream)

    def _copy(self, state: SolverState) -> SolverState:
        return SolverState(**{f: getattr(state, f).clone()
                              for f in self._fields})

    @spanned('ch.replay')
    def replay(self, state: SolverState) -> SolverState:
        for f in self._fields:
            getattr(self._in, f).copy_(getattr(state, f))
        self._graph.replay()
        K.add_counts(self._launched)
        return self._copy(self._out)


# ----------------------------------------------------------------------
# the member-batched step of the ensemble: the counterpart of
# make_ensemble_runner / make_ensemble_prepare
# (chsimpy_tpu/core/stepper.py:847-923), which vmap the chunk over a
# leading member axis with A0, A1, kappa_tilde and CHeig batched and the
# transform operands, Seig and the jitter stream shared.  Here every field
# is an (R, N, N) stack and every counter an (R,) tensor; each kernel is
# launched once per step for all members (K1-K4 ``*_members``), the DCTs
# are batched products (or FFTs) over the member axis.  A member that has
# stopped is frozen by the per-member selects, as the vmapped while_loop's
# predicate select freezes it; the chunk runs while any member is active
# (the host loop in ensemble.py).  With grid-sharded member fields
# (``mesh``, the grid of this rank's ens slot) the fields are the members'
# blocks (R, bn, bw): K1, K2 and K4 take them as they are, the statistics
# run K7_members (``fused_stats_sharded_members``), the DCTs are the grid
# products of the stacked blocks (on the pencil layout: the members'
# column blocks (R, N, N/D), the pencil transforms of the stack, K5_members
# sharded on ozaki), and every scalar is the same on every rank of the
# grid, as in the single grid run.  On an ens-only mesh the
# members stay local and the step runs without a mesh.
# ----------------------------------------------------------------------

def make_members_consts(cfg: StepConfig, delt: float, A0s, A1s, kappas,
                        device='cpu') -> dict:
    """:func:`make_consts` with the member scalars as (R,) float64 tensors
    ('A0', 'A1', 'kappa_tilde') and CHeig (R, N, N) from each member's
    kappa; the transform operands, leig and Seig are shared.  CHeig is
    built on the CPU with make_consts' operations and order, so member r's
    grid is the single run's with kappa r, to the bit.  Under
    ``otf_coeffs`` no (R, N, N) grid is built: K12 forms each member's
    coefficients from its kappa."""
    consts = make_consts(cfg, delt, device=device)
    dtype = cfg.tdtype
    f64 = torch.float64
    kt = torch.as_tensor(kappas, dtype=f64)
    if cfg.otf_coeffs:
        CHeig = consts['CHeig'].cpu()
    else:
        CHeig, _ = coeffs_ops.get_coefficients(
            consts['leig'].cpu(), kt.to(dtype).reshape(-1, 1, 1),
            torch.tensor(delt, dtype=dtype), cfg.delx2)
    consts.update(
        CHeig=CHeig.to(device),
        A0=torch.as_tensor(A0s, dtype=f64).to(device),
        A1=torch.as_tensor(A1s, dtype=f64).to(device),
        kappa_tilde=kt.to(device),
        members=torch.arange(kt.shape[0], device=device))
    return consts


@spanned('ch.stats')
def _members_stats(cfg: StepConfig, consts, U, EnergieEut=None,
                   mesh=None):
    """:func:`_stats` of every member, each an (R,) float64 tensor, from
    the batched K3 sums and the batched K4 with each member's mean; the
    float64 finish in the single run's operations and order; Ra by K11's
    body in K4_members' second pass (the same bits for a member whatever
    the batch holds).  On a grid
    mesh U holds the members' blocks (K7_members and K4_members, the same
    values on every rank; on the pencil layout their column blocks)."""
    mesh = field_mesh(cfg, mesh)
    if mesh is not None:
        return K.fused_stats_sharded_members(
            mesh, U, EnergieEut, consts['A0'], consts['A1'],
            consts['kappa_tilde'], delx=cfg.delx, RT=cfg.RT, B=cfg.B,
            Amr=cfg.Amr, L=cfg.L, threshold=cfg.threshold)
    N = cfg.N
    n2 = float(N * N)
    Lsq = cfg.L ** 2
    sums = K.stats_sums_members(U, EnergieEut, consts['A0'], consts['A1'],
                                delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                                threshold=cfg.threshold,
                                fold=cfg.fold_field)
    E2 = 0.5 * cfg.Amr * consts['kappa_tilde'] * Lsq * (sums[:, 1] / n2)
    E = cfg.Amr * Lsq * (sums[:, 0] / n2) + E2
    SA = sums[:, 3] / n2
    L2 = torch.sqrt(sums[:, 4]) / n2
    meanU = (sums[:, 2] / n2).to(U.dtype)
    if cfg.fold_field:
        ps, Ra = K.absdev_ra_members(U, meanU,
                                     _mid_row(cfg, U).unsqueeze(1), 0)
    else:
        ps, Ra = K.absdev_ra_members(U, meanU, U, N // 2 + 1)
    return E, E2, ps / n2, L2, Ra, SA


def prepare_members_row0(cfg: StepConfig, consts, U, mesh=None):
    """Step-0 (E, E2, Ra, PS) of every member, (R,) float64 tensors."""
    E, E2, PS, _, Ra, _ = _members_stats(cfg, consts, U, None, mesh)
    return E, E2, Ra, PS


def adapted_members_delt(cfg: StepConfig, s: SolverState, EnergieEut,
                         mesh=None):
    """:func:`adapted_delt` of every member from its own field: its
    column sums' minimum, the blend with its own delt, (R,) float64.  On
    a grid mesh each member's block columns are summed, the column
    strip's partials added in rank order and the minimum taken over every
    rank of the grid, as :func:`adapted_delt` does for one field."""
    mesh = field_mesh(cfg, mesh)
    a = EnergieEut.abs()
    x = _natural_rows(cfg, cfg.delt_max / torch.sqrt(1.0 + ADAPT_ALPHA
                                                     * (a * a)))
    colsum = torch.sum(x, dim=-2)                       # (R, bw)
    if mesh is not None:
        R = colsum.shape[0]
        colsum = coll.rank_sum(
            coll.gather_x(mesh, colsum).reshape(mesh.shape[0], R, -1))
    low = torch.amin(colsum, dim=-1)
    if mesh is not None:
        low = torch.amin(coll.gather_world(mesh, low), dim=0)
    delt_new = torch.clamp(low.to(torch.float64), min=cfg.delt_base)
    delt = s.delt
    blended = torch.where(delt_new / delt > 1.15,
                          0.75 * delt + 0.25 * delt_new, delt_new)
    do_adapt = (s.computed_steps > 500) & (s.computed_steps % 2 == 0)
    return torch.where(do_adapt, blended, delt)


def rebuilt_members_coefficients(cfg: StepConfig, consts, delt):
    """(CHeig, Seig), each (R, N, N), of every member at its own delt and
    kappa: :func:`rebuilt_coefficients` member by member."""
    dtype = cfg.tdtype
    return coeffs_ops.get_coefficients(
        consts['leig'], consts['kappa_tilde'].to(dtype).reshape(-1, 1, 1),
        delt.to(dtype).reshape(-1, 1, 1), cfg.delx2)


@spanned('ch.step')
def _members_step(cfg: StepConfig, consts, s: SolverState,
                  slab=None, mesh=None) -> SolverState:
    """One step of every member; ``slab`` is the step's host jitter slab
    (``stream``; ``static``: the one simplex slab), shared by all members
    as the JAX ensemble shares its jitter stream (on a grid mesh: this
    rank's block of it).  On a grid mesh ``s.U`` and ``s.hat_U`` hold the
    members' blocks and every collective runs on every step, also after
    the stop."""
    f64 = torch.float64
    active = s.stop_reason == STOP_NONE
    with span('ch.mu'):
        EnergieEut = K.chemical_potential_members(s.U, cfg.RT, cfg.BRT,
                                                  consts['A0'], consts['A1'])
    if cfg.adaptive_time:
        delt = adapted_members_delt(cfg, s, EnergieEut, mesh)
        CHeig, Seig = ((None, None) if cfg.otf_coeffs
                       else rebuilt_members_coefficients(cfg, consts, delt))
    else:
        delt = s.delt
        CHeig, Seig = consts['CHeig'], consts['Seig']

    tds = s.time_delta_sum + delt
    time_passed = tds * (1.0 / cfg.M_tilde)     # as in _step
    if cfg.time_limit is None:
        over = None
        go = active
    else:
        over = time_passed > cfg.time_limit
        go = active & ~over

    hat_E = dct2_route(cfg, consts, EnergieEut, cfg.ozaki_fwd_pairs, mesh,
                       cfg.fwd_precision)
    with span('ch.update'):
        if cfg.otf_coeffs:
            r0, c0 = spectral_offsets(cfg, mesh)
            hat_U = K.update_otf_members(s.hat_U, hat_E, consts['eaxis'],
                                         delt, consts['kappa_tilde'],
                                         cfg.delx2, r0, c0)
        else:
            hat_U = K.spectral_update_members(s.hat_U, hat_E, Seig, CHeig)
    U = idct2_route(cfg, consts, hat_U, mesh)
    if cfg.jitter_mode in ('stream', 'static'):
        U = U + cfg.jitter * (2.0 * slab - 1.0)

    E, E2, PS, L2, Ra, SA = _members_stats(cfg, consts, U, EnergieEut,
                                           mesh)
    domtime = time_passed ** (1.0 / 3.0)
    it = s.computed_steps
    row = torch.stack([it.to(f64), E, E2, SA, domtime, Ra, L2, PS, delt],
                      dim=-1)
    s.rowbuf[consts['members'], s.rows] = row
    steps_new = it + 1
    has_nan = torch.isnan(row).any(dim=-1)

    falls = (s.E2_prev > E2) & (E2 > s.E2_first)
    trigger = falls & ~s.skip_check
    fire = go & trigger
    if cfg.full_sim:
        skip_check = s.skip_check | fire
        stop = torch.full_like(s.stop_reason, STOP_NONE)
    else:
        skip_check = s.skip_check
        stop = torch.where(trigger, STOP_ENERGY, STOP_NONE)
    stop = torch.where(has_nan, STOP_NAN, stop)
    stop = torch.where(go, stop, s.stop_reason)
    if over is not None:
        stop = torch.where(active & over, STOP_TIME_LIMIT, stop)

    go3 = go.reshape(-1, 1, 1)
    return s.replace(
        U=torch.where(go3, U, s.U),
        hat_U=torch.where(go3, hat_U, s.hat_U),
        delt=(torch.where(active, delt, s.delt) if cfg.adaptive_time
              else s.delt),
        time_delta_sum=torch.where(active, tds, s.time_delta_sum),
        computed_steps=s.computed_steps + go,
        skip_check=skip_check,
        stop_reason=stop.to(s.stop_reason.dtype),
        tau0=torch.where(fire, steps_new.to(f64), s.tau0),
        t0=torch.where(fire, time_passed, s.t0),
        E2_prev=torch.where(go, E2, s.E2_prev),
        rows=s.rows + go)


@spanned('ch.chunk')
def run_members_chunk(cfg: StepConfig, consts, state: SolverState,
                      n_iters: int, jitter_buf=None, mesh=None,
                      graph: Optional[ChunkGraph] = None) -> SolverState:
    """Up to ``n_iters`` member-batched steps, left as :func:`run_chunk`
    leaves once every member has stopped (``jitter_buf`` as there;
    ``mesh``: the grid of grid-sharded member fields, or None;
    ``graph``: a :class:`ChunkGraph` of :func:`_members_step` on this
    batch, which replays each whole ``STOP_POLL`` steps of the chunk, the
    rest run as they are)."""
    state, i, stopped = _replayed(graph, state, n_iters)
    if stopped:
        return state
    for i in range(i, n_iters):
        slab = (jitter_buf[i] if cfg.jitter_mode == 'stream'
                else jitter_buf)
        state = _members_step(cfg, consts, state, slab, mesh)
        if (i + 1) % STOP_POLL == 0 and i + 1 < n_iters and _stopped(state):
            break
    return state
