"""Host loop of the Cahn-Hilliard integrator.

Port of ``chsimpy_tpu/core/solver.py`` for the slice: ``prepare()`` then
``solve_or_resume(nsteps)``.  Time stepping runs in chunks of
``chunk_size`` steps on the device (core/stepper.py, which leaves a chunk
at its first look at the stop flag after a stop); the host syncs once per
chunk: it reads the chunk's timedata rows and the scalar state, and maps
the stop code.  The reference's iteration-count semantics hold:

* a fresh solve (computed_steps == 1) runs ``nsteps - 1`` iterations, a
  resume runs ``nsteps``;
* ``hat_U`` is recomputed from U at every API entry, and carried across
  the internal chunks (so the chunk size never shows in the results);
* ``prepare()`` resets what the reference resets, and NOT time_delta_sum,
  delt or skip_check.

With ``mesh_shape`` the solve is sharded over the ranks of a
``torch.distributed`` process group (one rank per mesh device): every rank
builds the same initial field on the host and keeps its block; every rank
holds the same scalars and rows, so each syncs, stops and returns the same
solution (``solution.U`` is the gathered field).  The matmul route tiles
the field over the grid (as the JAX package's ``--mesh MxN``: K8, the grid
DCTs, K2 and K7 on the block); the split and ozaki routes take the pencil
layout when the rank count D divides N (as the JAX package resolves
``pencil``): the field in column blocks, the spectral image and its grids
in row blocks, one transpose all-to-all per 2-D transform, K5 sharded on
the ozaki route.  The ozaki route with N not divisible by D tiles the
grid as the matmul route does (the grid ozaki route: strip gathers of the
field and of the int8 slice stacks, K5 sharded).

With ``checkpoint_file`` and ``checkpoint_every`` the solve saves a
checkpoint (``checkpoint.py``) at the first chunk boundary at least
``checkpoint_every`` steps after the last save, a cadence that survives
re-entry; ``checkpoint.restore_solver`` rebuilds a prepared solver from
one.  Under a mesh every rank gathers the field at that boundary and rank
0 writes it.

Per-step jitter (``0 < jitter < 0.1``) takes its mode from the generator
and ``jitter_backend`` as in the JAX package: ``static`` for simplex,
``device_sobol`` (kernel K9, bit-equal to the host stream) for sobol on
the device backend, ``device`` (kernel K10: the JAX package's threefry
stream from ``jax.random.PRNGKey(seed)``, the key carried in the state;
not reference-exact) for uniform on the device backend, else ``stream``:
the chunk's slabs drawn from the host generator before it runs, at most
64 MB of them (``chunk_size`` shrinks to fit).  On a mesh every rank
draws its block of what one device would.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..derived import Derived
from ..device import resolve_device
from ..ops import dct as dct_ops
from ..ops import sobol as sobol_ops
from ..params import Parameters, check_solver_scope
from ..parallel.distributed import resolve_backend
from ..parallel.mesh import GridMesh
from ..parallel.sharding import (block_slices, gather_field, shard_consts,
                                 shard_field)
from ..rng import FieldGenerator
from ..solution import Solution
from ..timedata import TimeData
from ..tracing import spanned
from . import state as state_mod
from .state import STOP_NAN, STOP_NONE, STOP_STRINGS, SolverState
from .stepper import (StepConfig, entry_dct2, field_mesh, make_consts,
                      prepare_row0, run_chunk)

_JITTER_BUF_BYTES = 64 << 20  # cap on the per-chunk host jitter pre-draw


def resolve_jitter_mode(params: Parameters, has_U_init: bool = False) -> str:
    """The jitter mode of ``params`` (``core/stepper.py`` JITTER_MODES):
    'none' unless 0 < jitter < 0.1 (the reference applies it only there);
    the 'lcg' generator has no stream, so jitter with it raises unless U
    came from the caller (``chsimpy_tpu/core/solver.py:384-405``)."""
    if params.jitter is None or not 0.0 < params.jitter < 0.1:
        return 'none'
    if params.generator == 'lcg' and not has_U_init:
        raise ValueError("jitter requires a sample stream; the 'lcg' "
                         "generator has none (matches reference)")
    if params.generator == 'simplex':
        return 'static'
    if params.jitter_backend == 'device':
        if params.generator == 'sobol':
            return 'device_sobol'
        if params.generator == 'uniform':
            return 'device'
    return 'stream'


FFT_UNDER_MESH = ("--transform fft does not shard under --mesh; the "
                  "distributed transforms are the split (pencil layout), "
                  "matmul and ozaki routes")


# transform='auto' on one device: for each precision, (smallest N, route)
# rows, the first row whose N the run reaches wins (see auto_route).
# steps/s on the card (chip_smoke.py phase 16 (d), three runs; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6), each route at the product
# precision a run takes by default (N <= 2048 host-bound: 10-30% run to
# run):
#   float32  N=512   matmul 763-918   split 449-593  fft 463-554
#            N=1024  matmul 860-1083  split 383-432  fft 450-771
#            N=2048  matmul 698-723   split 324-425  fft 490-652
#            N=4096  matmul 184-186   split 254-263  fft 337-339
#   float64  N=512   matmul 848-1057  split 473-609  fft 512-801
#            N=1024  matmul 763-909   split 534-662  fft 503-671
#            N=2048  matmul 582-643   split 413-561  fft 514-639
#            N=4096  matmul 89-91     split 156-157  fft 198
#   (ozaki 23-98 at every N: never the fastest on the card)
# Each route keeps the float32 class there (the N=512/1024/2048 stops in
# their bands, E within 1e-5 of float64 at every step; phase 16 (b)) and
# float64 its contract (the stop goldens on every route, phase 7 (e);
# fft at N=4096 within 1e-10 of matmul, phase 16 (d)).  Between 2048 and
# 4096 the crossover was not measured.
AUTO_ROUTES = {'float32': ((4096, 'fft'), (0, 'matmul')),
               'float64': ((4096, 'fft'), (0, 'matmul'))}


def auto_route(N: int, precision: str, D: Optional[int] = None) -> str:
    """The route ``transform='auto'`` takes for an N x N run in
    ``precision`` on one device (``D`` None) or tiled over D ranks, from
    steps/s measured on the card (AUTO_ROUTES; PERF.md §6).  The
    same table holds on the CPU, so the CPU tests run the card's route.
    Under a mesh the routes that shard are matmul (grid) and split and
    ozaki (pencil): split where a single device takes it and D divides N,
    else matmul."""
    route = next(r for n, r in AUTO_ROUTES[precision] if N >= n)
    if route in ('split', 'fft') and N % 2:
        route = 'matmul'
    if D is not None and (route not in ('split', 'ozaki') or N % D):
        route = 'matmul'
    return route


def resolve_transform(params: Parameters) -> str:
    """The concrete DCT route: 'matmul', 'split', 'fft' or 'ozaki', with
    the JAX package's single-device guards; 'auto' is :func:`auto_route`
    of (N, precision, ranks), not the JAX package's TPU choices (split for
    float32 at N >= 1024, ozaki for float64).  JAX's float64-FFT guard
    holds on a TPU only (no complex128 there): float64 FFT runs on the
    card."""
    tb = params.transform_backend or 'auto'
    if tb == 'fft' and params.mesh_shape is not None:
        raise ValueError(FFT_UNDER_MESH)
    if tb == 'auto':
        return auto_route(params.N, params.precision, mesh_ranks(params))
    if tb in ('fft', 'split') and params.N % 2:
        raise ValueError(f"--transform {tb} requires even N "
                         f"(got {params.N})")
    if tb == 'ozaki' and params.precision != 'float64':
        raise ValueError(
            "--transform ozaki is the float64 transform (int8 slice "
            "decomposition of the double-single representation); float32 "
            "runs use --transform split or matmul")
    return tb


def check_split_levels(params: Parameters) -> None:
    """``split_levels`` is the split route's fold depth: at least 1, and N
    divisible by 2^levels (the JAX Solver's guard)."""
    sl = params.split_levels
    if sl is not None and not (1 <= sl and params.N % (2 ** sl) == 0):
        raise ValueError(
            f"--split-levels {sl} needs N divisible by 2^levels "
            f"(got N={params.N})")


def _resolve_rfold_levels(params: Parameters,
                          grid_sharded: Optional[bool] = None) -> int:
    """Fold depth of the recursive permuted ozaki route (0 = the level-1
    natural fold, or the unfolded route for odd N), as the JAX package
    resolves it: N >= 1024 folds to depth 2 (1 above N=4096), clamped by
    divisibility and by the int32 group bound 65*65*8*N*2^L < 2^31
    (ops/ozaki.py).  The depth changes the bits, so the port keeps it.
    A field sharded over ranks (``grid_sharded``; by default: a mesh)
    takes the unfolded pencil route (0)."""
    if grid_sharded is None:
        grid_sharded = params.mesh_shape is not None
    if grid_sharded or resolve_transform(params) != 'ozaki':
        return 0
    N = params.N
    if N < 1024:
        return 0
    max_L = 2 if N <= 4096 else 1
    L = 0
    while (L < max_L and N % (2 ** (L + 1)) == 0
           and N * 2 ** (L + 1) <= 63550):
        L += 1
    return L


# float32 runs that pin no matmul_precision take 'high' (3xTF32, K6) from
# this N up, 'highest' (cuBLAS FP32) below; the JAX package takes 'high'
# at every N (chsimpy_tpu/core/solver.py:467-468).  Earned on the card
# (phase 16 (b), (d), three runs; H100 80GB HBM3, 700 W): 'high' holds the
# float32 class (the stops 1674, 1836-1837, 2039-2040 inside their bands,
# E within 6.6e-8 of float64 at every step, 3.9e-8 over 256 steps at
# N=4096), and matmul steps/s at high / highest are 739-958 / 763-918 at
# N=512 (no clear winner: host-bound), 860-1083 / 842-917 at 1024,
# 698-723 / 617-619 at 2048, 184-186 / 88 at 4096
F32_HIGH_MIN_N = 1024
# the JAX package's float32 fast-mode gates (chsimpy_tpu/core/solver.py:
# 150-217; float32, the split route on one device, no pinned precision),
# each kept only where the card earned it: the smallest N of each (None:
# off).  steps/s of the split route at N=4096 float32, 'high' alone
# against each knob in turns (phase 16 (c), two runs; H100 80GB HBM3,
# 700 W; PERF.md §6): alone 247.7-263.5; the 1-pass forward
# 269.4-305.1 (on: its stops stay in their bands, E 9.2e-8 at N=2048,
# 3.8e-8 over 256 steps at N=4096, phase 16 (b)); otf 249.3-269.1 (off:
# within the spread of the route alone; with -a on matmul 85.3-85.4
# against 83.6, but the gate is the split route's); --inv-band N/4
# 201.1-218.3 (off: the tail is a second product beside K6's low band);
# --fold-field 227.9-263.8 at depth 5 (off).  At N < 4096 the route
# there is matmul (AUTO_ROUTES) and the split route's knobs were measured
# for their class only.
AUTO_FWD_DEFAULT_MIN_N = 4096
AUTO_INV_BAND_MIN_N = None
AUTO_OTF_MIN_N = None
AUTO_FOLD = False


def resolve_matmul_precision(params: Parameters) -> str:
    """The float32 product precision of the transforms: the pinned name,
    else in float32 'high' from N = F32_HIGH_MIN_N up and 'highest'
    below; 'highest' in float64 (float64 products ignore the name).  What
    each name computes on the card: ``ops/dct.py``."""
    if params.matmul_precision is not None:
        return params.matmul_precision
    if params.precision == 'float32' and params.N >= F32_HIGH_MIN_N:
        return 'high'
    return 'highest'


def _fast_mode(params: Parameters, min_n: Optional[int]) -> bool:
    """The JAX package's auto-gate condition: float32, the split route on
    one device, no pinned matmul_precision, N >= min_n (None: off)."""
    return (min_n is not None and params.precision == 'float32'
            and params.matmul_precision is None and params.N >= min_n
            and params.mesh_shape is None
            and resolve_transform(params) == 'split')


def resolve_fwd_matmul_precision(params: Parameters) -> Optional[str]:
    """The forward transform's precision (None: the run's).  Auto: the
    JAX package's 1-pass forward ('default') on its fast-mode gate at N >=
    AUTO_FWD_DEFAULT_MIN_N (chsimpy_tpu/core/solver.py:150-172)."""
    if params.fwd_matmul_precision is not None:
        return params.fwd_matmul_precision
    return 'default' if _fast_mode(params, AUTO_FWD_DEFAULT_MIN_N) else None


def resolve_inv_band(params: Parameters) -> Optional[int]:
    """The banded inverse's first tail index (None: uniform precision;
    ``inv_band=0`` forces that).  Auto: N/4 on the fast-mode gate at N >=
    AUTO_INV_BAND_MIN_N (chsimpy_tpu/core/solver.py:175-202)."""
    if params.inv_band is not None:
        return params.inv_band or None
    return params.N // 4 if _fast_mode(params, AUTO_INV_BAND_MIN_N) else None


def resolve_otf_coeffs(params: Parameters) -> bool:
    """The update's coefficients rebuilt per step by K12 (``otf_coeffs``
    1 / 0 pins it).  Auto: on the fast-mode gate at N >= AUTO_OTF_MIN_N
    (chsimpy_tpu/core/solver.py:205-233)."""
    if params.otf_coeffs is not None:
        return bool(params.otf_coeffs)
    return _fast_mode(params, AUTO_OTF_MIN_N)


def resolve_fold_field(params: Parameters,
                       grid_sharded: Optional[bool] = None) -> bool:
    """The level-1 folded field (``fold_field`` True / False pins it).
    Auto (AUTO_FOLD): whenever the split route runs on member-local
    fields (``grid_sharded``: the field split over ranks; by default a
    mesh), as the JAX package resolves it (chsimpy_tpu/core/solver.py:
    46-92).  The JAX package refuses the fold with its Pallas kernels; the
    port's kernels read the folded layout (K3's fold mode)."""
    if params.fold_field is not None:
        return bool(params.fold_field)
    if grid_sharded is None:
        grid_sharded = params.mesh_shape is not None
    return (AUTO_FOLD and not grid_sharded
            and resolve_transform(params) == 'split')


INV_BAND_F64 = ("--inv-band is a float32 fast-mode knob (a 1-pass bf16 "
                "band would break the float64 validation contract)")
FOLD_SPLIT_ONLY = ("--fold-field needs the split transform route (the fold "
                   "is a property of its level-1 layout)")


def check_knobs(params: Parameters) -> None:
    """The JAX Solver's guards of the knobs (chsimpy_tpu/core/solver.py:
    416-448), shared by the single run and the ensemble: a pinned
    --inv-band is float32 only, in (0, N), on the matmul and split routes;
    the fold is the split route's (its mesh rule is the caller's)."""
    ib = params.inv_band
    if ib:
        if params.precision != 'float32':
            raise ValueError(INV_BAND_F64)
        if not 0 < ib < params.N:
            raise ValueError(f"--inv-band must be in (0, N) or 0 for "
                             f"uniform precision, got {ib}")
        if resolve_transform(params) not in ('matmul', 'split'):
            raise ValueError(
                "--inv-band applies to the matmul and split routes")
    if params.fold_field and resolve_transform(params) != 'split':
        raise ValueError(FOLD_SPLIT_ONLY)


def resolve_ozaki_fwd_pairs(params: Parameters) -> tuple:
    """Pair cutoffs of the ozaki forward transform (of the nonlinear
    term, which rides the semi-implicit damping): (3, 5) unless set.  The
    JAX package's default, measured on the canonical run: E at the
    float64 floor down to (2, 4), the cliff at (2, 3)."""
    pairs = params.ozaki_fwd_pairs
    return (3, 5) if pairs is None else tuple(pairs)


def resolve_ozaki_inv_pairs(params: Parameters) -> tuple:
    """Pair cutoffs of the rfold inverse: (3, 5) unless set (the JAX
    package's default, measured on the N=1024 golden: exact stop 1837
    down to (2, 4), stop 1808 at (2, 3)).  The level-1 fold and the
    unfolded inverses keep (5, 7)."""
    pairs = params.ozaki_inv_pairs
    return (3, 5) if pairs is None else tuple(pairs)


def mesh_ranks(params: Parameters) -> Optional[int]:
    """The rank count of ``params.mesh_shape`` (None: no mesh)."""
    if params.mesh_shape is None:
        return None
    mx, my = params.mesh_shape
    return mx * my


def resolve_pencil(params: Parameters, D: Optional[int]) -> bool:
    """True when a field tiled over ``D`` ranks (None: a field on one
    device) takes the pencil layout: the split or ozaki route and N
    divisible by D (the JAX package's ``pencil``,
    ``chsimpy_tpu/core/solver.py:489-498``; the port has no
    ``--kernels``), with its guards: fft does not shard, split needs D to
    divide N.  The ozaki route with N not divisible by D takes the grid
    layout (``ops/ozaki.py`` ``dct2_ozaki_grid``), as the JAX package's
    GSPMD-partitioned unfolded route does.  The single run and the
    ensemble both decide here."""
    if D is None:
        return False
    tb = params.transform_backend
    if tb == 'fft':
        raise ValueError(FFT_UNDER_MESH)
    if tb == 'split' and params.N % D:
        raise ValueError(
            f"--transform split under --mesh uses the pencil layout, "
            f"which needs N divisible by the device count {D} "
            f"(got N={params.N})")
    return (resolve_transform(params) in ('split', 'ozaki')
            and params.N % D == 0)


def check_grid_mesh(params: Parameters) -> None:
    """N divisible by mx and by my: the grid layout's blocks are equal,
    as the JAX package's ``device_put`` of the field onto its mesh needs
    (an uneven split raises there).  The JAX package's stricter guard (N
    divisible by 8*mx, ``chsimpy_tpu/core/solver.py:503-516``) holds only
    for its ``kernel_backend='pallas'``, whose banded kernels tile to the
    TPU's (8, 128) geometry; its default path and the port's kernels take
    any block."""
    mx, my = params.mesh_shape
    N = params.N
    if N % mx or N % my:
        raise ValueError(
            f"N={N} does not tile a {mx}x{my} mesh: N must be divisible "
            f"by {mx} and by {my}")


class Solver:
    """Cahn-Hilliard (CH) integrator: semi-implicit spectral method over the
    2-D DCT, Flory-Huggins energy with linear Redlich-Kister interaction.
    See Ghiass et al (2016), JMS Part B 55(4):411-425."""

    def __init__(self, params: Parameters = None, U_init=None):
        self.params = params if params is not None else Parameters()
        params = self.params
        check_solver_scope(params)
        self.device = resolve_device(params.device)
        self.derived = Derived.from_params(params)
        self.solution = Solution(params, self.derived)
        N = params.N

        self.skip_check = False
        self.time_delta_sum = 0.0
        self.time_passed = 0.0
        self._prepared = False
        self.delt = params.delt

        # initial field: host-side, bit-exact generators; the jitter
        # stream continues the generator that built it
        self.generator: Optional[FieldGenerator] = None
        if U_init is not None:
            U_init = np.asarray(U_init)
            if U_init.shape != (N, N):
                raise ValueError(
                    f"U_init has wrong shape {U_init.shape}, "
                    f"must be ({N}, {N})")
            self.U_init = np.asarray(U_init, dtype=np.float64)
        else:
            self.generator = FieldGenerator(params.generator, N, params.seed)
            self.U_init = self.generator.initial_field(params.XXX)
        jitter_mode = resolve_jitter_mode(params, U_init is not None)

        time_limit = None
        if params.time_max is not None and params.time_max > 0:
            time_limit = params.time_max * 60.0

        check_split_levels(params)
        check_knobs(params)
        pencil = resolve_pencil(params, mesh_ranks(params))
        transform = resolve_transform(params)
        fold_field = resolve_fold_field(params)
        if fold_field and params.mesh_shape is not None:
            raise ValueError("--fold-field is single-device only (the "
                             "folded seam crosses shard halves)")
        self.mesh = None
        if params.mesh_shape is not None:
            check_grid_mesh(params)
            resolve_backend(params.dist_backend, self.device)
            self.mesh = GridMesh(params.mesh_shape, self.device)
        d = self.derived
        self.cfg = StepConfig(
            N=N, dtype=params.precision,
            RT=d.RT, BRT=d.BRT, B=params.B,
            Amr=d.Amr, L=params.L, delx=d.delx, delx2=d.delx2,
            M_tilde=params.M_tilde, threshold=params.threshold,
            A0=d.A0, A1=d.A1, kappa_tilde=d.kappa_tilde,
            delt_base=params.delt, delt_max=params.delt_max,
            adaptive_time=params.adaptive_time,
            time_limit=time_limit, full_sim=params.full_sim,
            jitter=params.jitter if jitter_mode != 'none' else None,
            jitter_mode=jitter_mode,
            transform_backend=transform,
            split_levels=params.split_levels,
            ozaki_fold=(transform == 'ozaki' and N % 2 == 0
                        and self.mesh is None),
            ozaki_rfold_levels=_resolve_rfold_levels(params),
            ozaki_fwd_pairs=resolve_ozaki_fwd_pairs(params),
            ozaki_inv_pairs=resolve_ozaki_inv_pairs(params),
            pencil=pencil, fold_field=fold_field,
            matmul_precision=resolve_matmul_precision(params),
            fwd_matmul_precision=resolve_fwd_matmul_precision(params),
            inv_band=resolve_inv_band(params),
            otf_coeffs=resolve_otf_coeffs(params))
        # the layout of the field: the grid's, or its column blocks
        self.field_mesh = field_mesh(self.cfg, self.mesh)
        # chunk size: device steps per host round-trip
        self.chunk_size = max(1, int(params.chunk_size))
        if jitter_mode == 'stream':
            self.chunk_size = max(1, min(self.chunk_size,
                                         _JITTER_BUF_BYTES // (N * N * 8)))
        dct_ops.require_full_fp32()
        self._consts = make_consts(self.cfg, self.delt, device=self.device)
        if jitter_mode == 'device_sobol':
            sv, sh = sobol_ops.sobol_tables(N, params.seed)
            self._consts.update(
                sobol_sv=torch.tensor(sv.astype(np.int64), device=self.device),
                sobol_shift=torch.tensor(sh.astype(np.int64),
                                         device=self.device))
        if self.mesh is not None:
            self._consts = shard_consts(self._consts, self.mesh, pencil)
        # the simplex slab, drawn at first use
        self._static_jbuf = None
        self._state: Optional[SolverState] = None

    # ------------------------------------------------------------------
    def prepare(self) -> None:
        """Initial computations before the simulation loop."""
        U0 = torch.as_tensor(self.U_init).to(device=self.device,
                                             dtype=self.cfg.tdtype)
        self.solution.U = U0
        if self.mesh is not None:
            U0 = shard_field(U0, self.field_mesh)[0]
        # the state's layout from here on (folded under fold_field;
        # solution.U stays natural)
        U0 = self.field_state(U0)
        row0 = prepare_row0(self.cfg, self._consts, U0, self.mesh)
        E, E2, Ra, PS = torch.stack(row0).tolist()

        data = TimeData()
        data.insert(it=0, delt=self.delt, E=E, E2=E2, SA=0, domtime=0,
                    Ra=Ra, L2=0, PS=PS)

        state = state_mod.init_state(
            U0=U0, hat_U0=torch.zeros_like(U0),  # rebuilt at solve entry
            delt=self.delt, E2_first=E2, chunk_cap=self.chunk_size,
            seed=self.params.seed)
        # quirk parity: prepare() does NOT reset time_delta_sum/skip_check;
        # it does reset the device jitter's key (init_state), as JAX's does
        self._state = state.replace(
            time_delta_sum=torch.tensor(self.time_delta_sum,
                                        dtype=torch.float64,
                                        device=self.device),
            skip_check=torch.tensor(bool(self.skip_check),
                                    device=self.device))
        self.solution.timedata = data
        self.solution.tau0 = 0.0
        self.solution.t0 = 0.0
        self.solution.stop_reason = 'None'
        self.solution.computed_steps = 1
        self._ckpt_last_saved = None
        self._prepared = True

    # ------------------------------------------------------------------
    def _ensure_generator(self) -> FieldGenerator:
        """The jitter's host stream: the generator that built U0, or, when
        U came from the caller, one built from (generator, N, seed)."""
        if self.generator is None:
            self.generator = FieldGenerator(
                self.params.generator, self.params.N, self.params.seed)
        return self.generator

    def _to_device(self, slabs: np.ndarray) -> torch.Tensor:
        """Host slabs (..., N, N) in the field's type on the device; on a
        mesh this rank's block of each; under fold_field folded (the same
        values land on the same natural cells)."""
        t = torch.as_tensor(slabs)
        if self.mesh is not None:
            rows, cols = block_slices(self.field_mesh, self.params.N)
            t = t[..., rows, cols]
        return self.field_state(t.to(device=self.device,
                                     dtype=self.cfg.tdtype))

    def _draw_jitter_buf(self, k: int):
        """The chunk's jitter slabs (``stream``: k draws of the host
        stream; ``static``: the one simplex slab), or None."""
        mode = self.cfg.jitter_mode
        if mode == 'stream':
            gen = self._ensure_generator()
            N = self.params.N
            slabs = np.empty((k, N, N), dtype=np.float64)
            for i in range(k):
                slabs[i] = gen.next_sample()
            return self._to_device(slabs)
        if mode == 'static':
            if self._static_jbuf is None:
                self._static_jbuf = self._to_device(
                    self._ensure_generator().next_sample())
            return self._static_jbuf
        return None

    def solve_or_resume(self, nsteps: Optional[int] = None) -> Solution:
        """Run (or continue) the simulation; returns the Solution."""
        if not self._prepared:
            raise RuntimeError("call prepare() before solve_or_resume()")
        if nsteps is None:
            nsteps = max(self.params.ntmax, 0)

        # iteration-count semantics of the reference
        if self.solution.computed_steps == 1:
            n_iters = max(nsteps - 1, 0)
        else:
            n_iters = nsteps

        state = self._state
        if self.cfg.jitter_mode == 'device_sobol':
            # draws consumed before step 1: the initial field's N points
            # when this generator built U0 (0 after a caller's U).  The
            # host engine never advances in this mode, so its position is
            # that base at every entry; the step adds its own offset
            self._consts['sobol_base'] = torch.tensor(
                self._ensure_generator().sobol_position, dtype=torch.int64,
                device=self.device)
        # the reference recomputes the spectral image at every (re)entry
        state = state.replace(
            hat_U=entry_dct2(self.cfg, self._consts, state.U, self.mesh))
        if n_iters > 0:
            # re-entering after a stop continues the simulation
            state = state.replace(
                stop_reason=torch.full_like(state.stop_reason, STOP_NONE))
            self.solution.stop_reason = 'None'

        every = self.params.checkpoint_every
        ckpt = self.params.checkpoint_file
        # the save cadence survives re-entry (a caller may step in slices
        # far smaller than checkpoint_every)
        if self._ckpt_last_saved is None:
            self._ckpt_last_saved = self.solution.computed_steps
        while n_iters > 0 and self.solution.stop_reason == 'None':
            k = min(n_iters, self.chunk_size)
            state = self._run_chunk(state, k)
            n_iters -= k
            state = self._sync(state)
            if (ckpt and every and self.solution.computed_steps
                    - self._ckpt_last_saved >= every):
                # a resumable snapshot at the chunk boundary (every rank
                # of a mesh gets here at the same step: the scalars are
                # the same bits on all of them)
                self._state = state
                self.solution.U = self.host_field(state.U)
                from ..checkpoint import save_checkpoint
                save_checkpoint(ckpt, self)
                self._ckpt_last_saved = self.solution.computed_steps

        self._state = state
        self.solution.U = self.host_field(state.U)
        return self.solution

    def _run_chunk(self, state: SolverState, k: int) -> SolverState:
        """``k`` steps of the solve (:func:`~.stepper.run_chunk`)."""
        return run_chunk(self.cfg, self._consts, state, k, self.mesh,
                         self._draw_jitter_buf(k))

    def host_field(self, U: torch.Tensor) -> torch.Tensor:
        """The whole field of this rank's ``U`` in the natural layout
        (gathered under a mesh: a collective, every rank calls it;
        unfolded under fold_field)."""
        if self.mesh is not None:
            return gather_field(U, self.field_mesh)
        return self.field_state(U)

    def field_state(self, U: torch.Tensor) -> torch.Tensor:
        """A natural field in the state's layout (and back: the level-1
        fold is an involution); the identity unless fold_field."""
        return dct_ops.fold1(U) if self.cfg.fold_field else U

    @spanned('ch.sync')
    def _sync(self, state: SolverState) -> SolverState:
        """Per-chunk host sync: pull rows, update host mirrors, map stop."""
        f64 = torch.float64
        scalars = torch.stack([
            state.rows.to(f64), state.stop_reason.to(f64),
            state.computed_steps.to(f64), state.tau0, state.t0,
            state.skip_check.to(f64), state.delt,
            state.time_delta_sum]).cpu().tolist()
        rows, stop, steps, tau0, t0, skip, delt, tds = scalars
        rows, stop = int(rows), int(stop)
        if rows > 0:
            # a copy: the device buffer is written in place by the next
            # chunk (and on the CPU .cpu() would alias it)
            block = state.rowbuf[:rows].to('cpu', copy=True).numpy()
            try:
                self.solution.timedata.insert_block(block)
            except FloatingPointError:
                self.solution.stop_reason = 'nan'
                raise
        if stop == STOP_NAN:
            self.solution.stop_reason = 'nan'
            raise FloatingPointError(
                f"NaN encountered in timedata (step {int(steps)})")
        if stop != STOP_NONE:
            self.solution.stop_reason = STOP_STRINGS[stop]
        self.solution.computed_steps = int(steps)
        self.solution.tau0 = tau0
        self.solution.t0 = t0
        self.skip_check = bool(skip)
        self.delt = delt
        self.time_delta_sum = tds
        self.time_passed = self.time_delta_sum / self.params.M_tilde
        return state.replace(rows=torch.zeros_like(state.rows))
