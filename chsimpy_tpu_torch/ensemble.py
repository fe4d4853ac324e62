"""Member-batched Monte-Carlo ensemble solver.

Port of ``chsimpy_tpu/ensemble.py``: the UQ members of the reference's
process pool (``chsimpy/experiment.py:84-126,197-216``) as a leading batch
axis of one solve.  Every member shares the step; the perturbed physics
scalars (A0, A1 and the kappa_tilde each pair implies) are per-member (R,)
tensors; per-member early stop freezes a stopped member while the others
run on.  Each step launches each of K1-K4 once for all members
(``ops/kernels.py`` ``*_members``); the DCTs are products (or FFTs)
batched over the member axis.  On the card, without jitter or a mesh,
each whole ``STOP_POLL`` steps of a chunk replay a CUDA graph of the
batch's step, captured once a batch (``core/stepper.py`` ``ChunkGraph``):
the same launches, one from the host.  On the float64 ozaki route each
slicing is one K5_members call for all members (each member its own
scale, as the JAX ensemble's ``vmap`` gives it) and each int8 product
serves all members (``ops/ozaki.py``).

All members share the initial field (the reference re-uses the same seed
for every run, ``experiment.py:87-89``) and, with per-step jitter, the host
stream (``stream``; ``static`` for simplex), as in the JAX package.

The ozaki layout is resolved as the JAX ensemble resolves it off the
TPU: the level-1 fold for even N at every R, the recursive fold at
N >= 1024, the forward pair cutoffs as the single solver's, the rfold
inverse's pin-only (None: untrimmed).  The JAX package's TPU batch-width
gates (``_warn_wide_f64_batch``, the ozaki ``R > 4`` unfold, and the
experiment's four-wide clamp) have no counterpart: they guard a TPU
compiler fault.

With ``mesh`` (an :class:`~.parallel.mesh.EnsembleMesh`: one rank per
JAX mesh device, ``chsimpy_tpu/ensemble.py:113-136, 276-306``) the members
are split over the mesh's 'ens' axis as JAX's ``P('ens')`` splits them
(ens slot e runs the members ``[e*R/E, (e+1)*R/E)``; ``R % E`` raises), and
with a grid of more than one rank each member's field is tiled over the
grid of its slot: on the matmul route as a grid (K8 as K1_members on the
blocks, the grid DCTs of the stacked blocks, K2_members, K7_members and
K4_members), on the split and ozaki routes in the pencil layout when the
grid's rank count D divides N (the members' column blocks, their spectral
images in row blocks, one transpose of the stack per 2-D transform,
K5_members sharded on the ozaki route, K7_members on the column blocks;
``vmap`` adds the member axis to the pencil specs in the JAX package),
and on the ozaki route with N not divisible by D as a grid again (the
grid ozaki transforms of the stacked blocks, K5_members sharded).
Each rank builds the constants and state of its own members.  The host
side (rows, stops, counters; the fields for ``solutions()`` and
checkpoints) is gathered over the ens axis (and the fields over the
grid), so every rank holds every member, as JAX's replicated identity
gives it, and every rank takes the same chunks.
``params.mesh_shape`` without a ``mesh`` builds the mesh on the
initialized process group (its world over the grid's ranks is E).

The float32 knobs are the single run's (``core/solver.py``): the product
precision, the forward's, ``fold_field`` (member-local fields only: one
device or an 'ens'-only mesh, as in the JAX package), and, pinned only as
in the JAX ensemble, ``inv_band`` and ``otf_coeffs`` (K12_members: each
member's coefficients from its kappa, no (R, N, N) CHeig).  A pinned
``inv_band`` takes the single run's guards, float64 refused (the JAX
ensemble accepts it there, ``chsimpy_tpu/ensemble.py:171``: a fault of the
reference the port does not copy).

Refused, as in the JAX package: split with N not divisible by D, and a
grid that N does not tile.  The JAX ensemble has no device jitter, so
``jitter_backend='device'`` is refused too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import material
from .core.solver import (_JITTER_BUF_BYTES, _resolve_rfold_levels,
                          check_grid_mesh, check_knobs, check_split_levels,
                          resolve_fold_field, resolve_fwd_matmul_precision,
                          resolve_inv_band, resolve_matmul_precision,
                          resolve_ozaki_fwd_pairs, resolve_pencil,
                          resolve_transform)
from .core.state import STOP_NAN, STOP_NONE, STOP_STRINGS, init_members_state
from .core.stepper import (STOP_POLL, ChunkGraph, StepConfig, entry_dct2,
                           field_mesh, graph_fits, make_members_consts,
                           prepare_members_row0, run_members_chunk)
from .derived import Derived
from .device import resolve_device
from .ops import dct as dct_ops
from .params import Parameters, check_solver_scope
from .parallel.sharding import (block_slices, gather_field, gather_members,
                                member_slice, shard_consts, shard_field,
                                shard_members)
from .rng import FieldGenerator
from .solution import Solution
from .timedata import TimeData
from .tracing import spanned


def derive_member_constants(params: Parameters, A0: float, A1: float):
    """kappa_tilde implied by a member's (A0, A1) pair — the sympy
    common-tangent solve the reference performs per process
    (``chsimpy/solution.py:39-48``); ``params.kappa_tilde`` where pinned.
    Host-side, cached by argument.  The card's machine has no sympy: pass
    the members' ``kappas`` (or pin ``kappa_tilde``) there."""
    if params.kappa_tilde is not None:
        return params.kappa_tilde
    kappa_base = material.get_distance_common_tangent(
        R=params.R, T=params.temp, B=params.B, a0=A0, a1=A1, at=params.XXX)
    return kappa_base / (0.1602564 * 64) ** 2


def _grid_devices(params: Parameters, mesh=None) -> int:
    """The ranks each member's field is tiled over (1: members local)."""
    if mesh is not None:
        return mesh.size
    if params.mesh_shape is None:
        return 1
    return params.mesh_shape[0] * params.mesh_shape[1]


def _grid_sharded(params: Parameters, mesh=None) -> bool:
    """True when each member's field is tiled over more than one rank."""
    return _grid_devices(params, mesh) > 1


def _build_mesh(params: Parameters, device):
    """The ('ens', 'x', 'y') mesh of ``params.mesh_shape`` on the
    initialized process group: E is the world over the grid's ranks."""
    import torch.distributed as dist
    from .parallel.mesh import EnsembleMesh, check_grid_shape
    mx, my = check_grid_shape(params.mesh_shape)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world == 0 or world % (mx * my):
        raise RuntimeError(
            f"the ensemble with --mesh {mx}x{my} needs a torch.distributed "
            f"process group of a multiple of {mx * my} ranks (E x {mx} x "
            f"{my}) and there is {'none' if world == 0 else world}: start "
            f"the processes with the experiment's --coordinator, or "
            f"torchrun, or pass an EnsembleMesh")
    return EnsembleMesh(world // (mx * my), (mx, my), device)


class EnsembleSolver:
    """Batched Cahn-Hilliard integrator over UQ members.

    ``A_pairs`` is an (R, 2) array of (A0, A1) values (already perturbed);
    ``kappas`` (R,) the members' kappa_tilde where known (else each is
    derived, :func:`derive_member_constants`).  API of the JAX package:
    ``prepare()`` then ``solve_or_resume(nsteps)``; results come back as
    one Solution per member via ``solutions()``."""

    def __init__(self, params: Parameters, A_pairs: np.ndarray,
                 U_init: Optional[np.ndarray] = None, mesh=None,
                 kappas: Optional[np.ndarray] = None):
        self.params = params
        check_solver_scope(params)
        if params.mesh_shape is not None:
            check_grid_mesh(params)
        self.device = resolve_device(params.device)
        D = _grid_devices(params, mesh)
        pencil = resolve_pencil(params, D if D > 1 else None)
        check_knobs(params)
        fold_field = resolve_fold_field(params,
                                        grid_sharded=_grid_sharded(params,
                                                                   mesh))
        if params.fold_field and _grid_sharded(params, mesh):
            raise ValueError("--fold-field needs member-local fields: shard "
                             "the ensemble over 'ens' only (the folded seam "
                             "crosses grid-shard halves)")
        if mesh is not None and params.mesh_shape is not None \
                and tuple(params.mesh_shape) != tuple(mesh.shape):
            raise ValueError(f"mesh_shape {tuple(params.mesh_shape)} is not "
                             f"the mesh's grid {tuple(mesh.shape)}")
        A_pairs = np.asarray(A_pairs, dtype=np.float64)
        if A_pairs.ndim != 2 or A_pairs.shape[1] != 2 \
                or A_pairs.shape[0] < 1:
            raise ValueError("A_pairs must be (R, 2)")
        self.R = A_pairs.shape[0]
        self.A0s = A_pairs[:, 0].copy()
        self.A1s = A_pairs[:, 1].copy()
        if kappas is not None:
            self.kappas = np.asarray(kappas, dtype=np.float64).copy()
            if self.kappas.shape != (self.R,):
                raise ValueError("kappas must be (R,)")
        else:
            self.kappas = np.array([
                derive_member_constants(params, a0, a1)
                for a0, a1 in zip(self.A0s, self.A1s)])
        N = params.N
        if mesh is None and params.mesh_shape is not None:
            mesh = _build_mesh(params, self.device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"params ask for device {params.device!r}, the "
                             f"mesh runs on {mesh.device.type!r}")
        self.mesh = mesh
        # the grid of grid-sharded member fields (None: members local)
        self._grid = mesh if _grid_sharded(params, mesh) else None
        transform = resolve_transform(params)
        # the members this rank steps (all of them without a mesh)
        self.local_members = member_slice(mesh, self.R)
        if self._grid is not None:
            block_slices(self._grid, N)         # N must tile the grid

        # initial field: shared across members (reference semantics)
        self.generator = None
        if U_init is not None:
            U_init = np.asarray(U_init, dtype=np.float64)
            if U_init.shape != (N, N):
                raise ValueError(f"U_init has wrong shape {U_init.shape}")
            self.U_init = U_init
        else:
            self.generator = FieldGenerator(params.generator, N, params.seed)
            self.U_init = self.generator.initial_field(params.XXX)

        jitter_on = (params.jitter is not None
                     and 0.0 < params.jitter < 0.1)
        if jitter_on and params.generator == 'lcg':
            raise ValueError("jitter requires a sample stream; 'lcg' has none")
        if jitter_on and params.jitter_backend != 'host':
            raise ValueError(
                "the ensemble's jitter is the host stream all members share "
                "(as in the JAX ensemble, which has no device jitter): "
                "pass jitter_backend='host'")
        if jitter_on:
            jitter_mode = ('static' if params.generator == 'simplex'
                           else 'stream')
        else:
            jitter_mode = 'none'

        time_limit = None
        if params.time_max is not None and params.time_max > 0:
            time_limit = params.time_max * 60.0

        check_split_levels(params)
        # the physics scalars shared across members (Amr, delx, RT, ...)
        # do not depend on A0/A1/kappa: the step reads those per member
        # from the consts, so the unperturbed kappa is not derived here
        dp = params.deepcopy()
        if dp.kappa_tilde is None:
            dp.kappa_tilde = float(self.kappas[0])
        d = Derived.from_params(dp)
        inv_pairs = params.ozaki_inv_pairs
        self.cfg = StepConfig(
            N=N, dtype=params.precision,
            RT=d.RT, BRT=d.BRT, B=params.B,
            Amr=d.Amr, L=params.L, delx=d.delx, delx2=d.delx2,
            M_tilde=params.M_tilde, threshold=params.threshold,
            A0=d.A0, A1=d.A1, kappa_tilde=d.kappa_tilde,
            delt_base=params.delt, delt_max=params.delt_max,
            adaptive_time=params.adaptive_time,
            time_limit=time_limit, full_sim=params.full_sim,
            jitter=params.jitter if jitter_on else None,
            jitter_mode=jitter_mode,
            transform_backend=transform,
            split_levels=params.split_levels,
            # grid-sharded member fields take the unfolded pencil route
            ozaki_fold=(transform == 'ozaki' and N % 2 == 0
                        and self._grid is None),
            ozaki_rfold_levels=_resolve_rfold_levels(
                params, grid_sharded=self._grid is not None),
            ozaki_fwd_pairs=resolve_ozaki_fwd_pairs(params),
            # pin-only under the ensemble, as in the JAX package
            ozaki_inv_pairs=tuple(inv_pairs) if inv_pairs else None,
            pencil=pencil, fold_field=fold_field,
            matmul_precision=resolve_matmul_precision(params),
            fwd_matmul_precision=resolve_fwd_matmul_precision(params),
            # pinned only, as the JAX ensemble takes them
            inv_band=resolve_inv_band(params) if params.inv_band else None,
            otf_coeffs=bool(params.otf_coeffs))
        # the layout of the fields on the grid: its own, or the pencil
        # layout's column blocks
        self._field = field_mesh(self.cfg, self._grid)

        self.chunk_size = max(1, int(params.chunk_size))
        if jitter_mode == 'stream':
            self.chunk_size = max(1, min(self.chunk_size,
                                         _JITTER_BUF_BYTES // (N * N * 8)))
        dct_ops.require_full_fp32()
        self._consts = make_members_consts(
            self.cfg, params.delt, shard_members(self.A0s, mesh),
            shard_members(self.A1s, mesh), shard_members(self.kappas, mesh),
            device=self.device)
        if self._grid is not None:
            self._consts = shard_consts(self._consts, self._grid, pencil)
        # the simplex slab, drawn at first use (checkpoint.restore_ensemble
        # installs the saved stream after construction)
        self._static_jbuf = None
        self._states = None
        self.timedatas = [TimeData() for _ in range(self.R)]
        self._stop = np.zeros(self.R, dtype=np.int64)
        self._ckpt_extra = None
        # the batch's CUDA graph of STOP_POLL steps (:meth:`_replays`),
        # captured at its first chunk of that many steps and kept with the
        # solver (its memory goes with it)
        self._graph = None

    # ------------------------------------------------------------------
    def _replays(self) -> bool:
        """True where the chunks replay a :class:`ChunkGraph` of
        ``STOP_POLL`` steps: a run the graph takes (``graph_fits``: on the
        card, no jitter) without a mesh (collectives through the host).
        Other runs launch every step from the host."""
        return self.mesh is None and graph_fits(self.cfg, self.device)

    def _gather_host(self, *leaves) -> np.ndarray:
        """Per-member leaves of this rank's members, as one (len(leaves),
        R) float64 numpy array of every member (gathered over the ens
        axis: every rank holds the same values)."""
        t = torch.stack([x.to(torch.float64) for x in leaves], dim=-1)
        if self.mesh is not None:
            t = gather_members(t, self.mesh)
        return t.cpu().numpy().T

    def _gather_members(self, t: torch.Tensor) -> torch.Tensor:
        """A per-member tensor of this rank's members (fields: their
        blocks) as every member's whole value, on every rank."""
        if t.dtype == torch.bool:
            return self._gather_members(t.to(torch.uint8)).bool()
        if self._grid is not None and t.dim() == 3:
            t = gather_field(t, self._field)
        return t if self.mesh is None else gather_members(t, self.mesh)

    def field_layout(self, U: torch.Tensor) -> torch.Tensor:
        """Natural fields (..., N, N) in the state's layout, and back (the
        level-1 fold is an involution); the identity unless fold_field."""
        return dct_ops.fold1(U) if self.cfg.fold_field else U

    def host_state(self) -> dict:
        """Every member's U (R, N, N) in the natural layout, key and
        per-member leaves as numpy arrays (a collective under a mesh:
        every rank calls it)."""
        s = self._states
        out = {'U': self.field_layout(
                   self._gather_members(s.U)).cpu().numpy(),
               'rng_key': self._gather_members(s.rng_key).cpu().numpy()}
        for name in ('delt', 'time_delta_sum', 'computed_steps',
                     'skip_check', 'stop_reason', 'tau0', 't0', 'E2_first',
                     'E2_prev'):
            out[name] = self._gather_members(getattr(s, name)).cpu().numpy()
        return out

    def load_host_state(self, host: dict) -> None:
        """Install every member's leaves (:meth:`host_state`'s keys, each
        with all R members) as this rank's members' state (their blocks
        under a grid)."""
        from .core.state import key_tensor
        s = self._states
        mine = {k: shard_members(np.asarray(v), self.mesh)
                for k, v in host.items()}
        U = torch.as_tensor(mine['U']).to(device=self.device,
                                          dtype=self.cfg.tdtype)
        if self._grid is not None:
            U = shard_field(U, self._field)[0]
        repl = {'U': self.field_layout(U),
                'rng_key': key_tensor(mine['rng_key'], self.device)}
        for name, v in mine.items():
            if name not in repl:
                repl[name] = torch.as_tensor(v).to(
                    device=self.device, dtype=getattr(s, name).dtype)
        self._states = s.replace(**repl)
        self._stop = np.asarray(host['stop_reason'], np.int64)

    def prepare(self):
        N, R = self.params.N, self.R
        U0 = torch.as_tensor(self.U_init).to(device=self.device,
                                             dtype=self.cfg.tdtype)
        n_local = self.local_members.stop - self.local_members.start
        U0_b = U0.expand(n_local, N, N).contiguous()
        if self._grid is not None:
            U0_b = shard_field(U0_b, self._field)[0]
        # the state's layout from here on (folded under fold_field)
        U0_b = self.field_layout(U0_b)
        row0 = prepare_members_row0(self.cfg, self._consts, U0_b, self._grid)
        E2_local = row0[1]
        E, E2, Ra, PS = self._gather_host(*row0)
        self._states = init_members_state(
            U0_b, self.params.delt, E2_local, self.chunk_size,
            self.params.seed)
        self.timedatas = [TimeData() for _ in range(R)]
        for r in range(R):
            self.timedatas[r].insert(it=0, delt=self.params.delt, E=E[r],
                                     E2=E2[r], SA=0, domtime=0, Ra=Ra[r],
                                     L2=0, PS=PS[r])
        self._stop = np.zeros(R, dtype=np.int64)

    # ------------------------------------------------------------------
    def _ensure_generator(self) -> FieldGenerator:
        """Jitter needs a sample stream even when U_init was passed
        explicitly (e.g. by checkpoint.restore_ensemble, which installs
        the saved stream after construction)."""
        if self.generator is None:
            self.generator = FieldGenerator(
                self.params.generator, self.params.N, self.params.seed)
        return self.generator

    def _draw_jitter_buf(self, k: int):
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

    def _to_device(self, slabs: np.ndarray) -> torch.Tensor:
        """Host slabs (..., N, N) in the field's type on the device; under
        a grid this rank's block of each; folded under fold_field."""
        t = torch.as_tensor(slabs)
        if self._grid is not None:
            rows, cols = block_slices(self._field, self.params.N)
            t = t[..., rows, cols]
        return self.field_layout(t.to(device=self.device,
                                      dtype=self.cfg.tdtype))

    def solve_or_resume(self, nsteps: Optional[int] = None, on_chunk=None,
                        preserve_stops: bool = False):
        """Run up to ``nsteps`` (reference entry semantics).  ``on_chunk``,
        if given, is called as ``on_chunk(self, states)`` after every
        chunk syncs.  ``preserve_stops=True`` keeps already-stopped
        members stopped (a checkpoint resume must not re-enter members
        whose early stop already fired); the default re-enters every
        member, as the reference's re-entry does."""
        if self._states is None:
            raise RuntimeError("call prepare() before solve_or_resume()")
        if nsteps is None:
            nsteps = max(self.params.ntmax, 0)
        computed = self._gather_host(
            self._states.computed_steps)[0].astype(np.int64)
        # entry semantics (a fresh solve runs nsteps-1 iterations, a
        # resume nsteps) are member 0's; a mix of fresh (== 1) and resumed
        # (> 1) members has no shared iteration count
        fresh = computed == 1
        if fresh.any() and not fresh.all():
            raise AssertionError(
                "ensemble members disagree on entry semantics: "
                f"computed_steps={computed.tolist()} mixes fresh (==1) and "
                "resumed members; re-run prepare() or resume all members")
        n_iters = nsteps - 1 if int(computed[0]) == 1 else nsteps
        n_iters = max(n_iters, 0)

        states = self._states
        # the reference recomputes the spectral image at every (re)entry
        states = states.replace(
            hat_U=entry_dct2(self.cfg, self._consts, states.U, self._grid))
        if n_iters > 0 and not preserve_stops:
            states = states.replace(
                stop_reason=torch.zeros_like(states.stop_reason))
            self._stop = np.zeros(self.R, dtype=np.int64)
        elif preserve_stops:
            self._stop = self._gather_host(
                states.stop_reason)[0].astype(np.int64)

        # the stops are every member's (gathered): every rank takes the
        # same chunks, so the collectives meet
        while n_iters > 0 and np.any(self._stop == STOP_NONE):
            k = min(n_iters, self.chunk_size)
            if self._graph is None and k >= STOP_POLL and self._replays():
                self._graph = ChunkGraph(self.cfg, self._consts, states,
                                         members=True)
            states = run_members_chunk(self.cfg, self._consts, states, k,
                                       self._draw_jitter_buf(k), self._grid,
                                       self._graph)
            n_iters -= k
            states = self._sync(states)
            # publish the state before the hook: it sees the solver as it
            # is now
            self._states = states
            if on_chunk is not None:
                on_chunk(self, states)
        self._states = states
        return self.solutions()

    @spanned('ch.sync')
    def _sync(self, states):
        """Per-chunk host sync: every member's new rows into its trace,
        the stop codes; NaN in a member raises.  Under a mesh the rows
        and stops of every member are gathered first (the same on every
        rank)."""
        host = self._gather_host(states.rows, states.stop_reason)
        rows = host[0].astype(np.int64)
        stops = host[1].astype(np.int64)
        top = int(rows.max())
        if top > 0:
            # a copy: the device buffer is written in place by the next
            # chunk (and on the CPU .cpu() would alias it)
            buf = states.rowbuf[:, :top]
            if self.mesh is not None:
                buf = gather_members(buf.contiguous(), self.mesh)
            bufs = buf.to('cpu', copy=True).numpy()
        for r in range(self.R):
            if rows[r] > 0:
                self.timedatas[r].insert_block(bufs[r, :rows[r]])
            if stops[r] == STOP_NAN:
                raise FloatingPointError(f"NaN in ensemble member {r}")
        self._stop = stops
        return states.replace(rows=torch.zeros_like(states.rows))

    # ------------------------------------------------------------------
    def solutions(self) -> Sequence[Solution]:
        """One Solution per member, all R on every rank (under a mesh a
        collective: every rank calls it)."""
        s = self._states
        host = self._gather_host(s.computed_steps, s.tau0, s.t0,
                                 s.stop_reason)
        U = self.field_layout(self._gather_members(s.U))
        sols = []
        for r in range(self.R):
            p = self.params.deepcopy()
            p.A0_const = float(self.A0s[r])
            p.A1_const = float(self.A1s[r])
            p.kappa_tilde = float(self.kappas[r])
            sol = Solution(p)
            sol.U = U[r]
            sol.timedata = self.timedatas[r]
            sol.computed_steps = int(host[0, r])
            sol.tau0 = float(host[1, r])
            sol.t0 = float(host[2, r])
            sol.stop_reason = STOP_STRINGS[int(host[3, r])]
            sols.append(sol)
        return sols
