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


def resolve_transform(params: Parameters) -> str:
    """The concrete DCT route: 'matmul', 'split', 'fft' or 'ozaki', with
    the JAX package's single-device guards.  'auto' stays matmul in the
    port: the JAX package's TPU choices (split for float32 at N >= 1024,
    ozaki for float64) have to be earned by a measurement on the H100
    (ROADMAP.md queue A item 14).  JAX's float64-FFT guard holds on a TPU
    only (no complex128 there): float64 FFT runs on the card."""
    tb = params.transform_backend or 'auto'
    if tb == 'fft' and params.mesh_shape is not None:
        raise ValueError(FFT_UNDER_MESH)
    if tb == 'auto':
        return 'matmul'
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
        pencil = resolve_pencil(params, mesh_ranks(params))
        transform = resolve_transform(params)
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
            pencil=pencil)
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
        mesh this rank's block of each."""
        t = torch.as_tensor(slabs)
        if self.mesh is not None:
            rows, cols = block_slices(self.field_mesh, self.params.N)
            t = t[..., rows, cols]
        return t.to(device=self.device, dtype=self.cfg.tdtype)

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
            state = run_chunk(self.cfg, self._consts, state, k, self.mesh,
                              self._draw_jitter_buf(k))
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

    def host_field(self, U: torch.Tensor) -> torch.Tensor:
        """The whole field of this rank's ``U`` (gathered under a mesh: a
        collective, every rank calls it)."""
        return U if self.mesh is None else gather_field(U, self.field_mesh)

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
