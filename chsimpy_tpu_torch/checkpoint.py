"""On-disk checkpoint / resume, in the JAX package's format.

Port of ``chsimpy_tpu/checkpoint.py``: one ``.npz`` (format version 2)
with a JSON header (counters, delt, early-stop bookkeeping, the parameters'
``scalar_dict`` and the host generator's stream position as structured
JSON — restoring never runs code from the file) beside the arrays U,
timedata, rng_key and U_init.  A resumed run continues the exact
trajectory: the spectral image is recomputed from U at every solve entry,
so a restore is an in-memory re-entry.

Files cross between the packages both ways:

* ``rng_key`` holds the run's live threefry key, the ``device`` jitter's
  stream: the two packages draw the same stream from it (the port's K10,
  the JAX package's ``jax.random``), so a run of that mode continues the
  same stream after a restore in either package.  A fresh run's key is
  ``jax.random.PRNGKey(seed)`` (the seed's high and low 32-bit words),
  computed here without jax (:func:`jax_prng_key`);
* files of an earlier version of the port kept a ``torch.Generator``
  state of its ``device`` jitter under ``torch_jitter_generator``: that
  stream is gone, and such a file is refused;
* the port's own parameters (``device``, ``dist_backend``) ride in the
  header's params, which the JAX loader skips; on restore the caller's
  ``device`` wins;
* a checkpoint saved with ``kernel_backend='pallas'`` restores onto the
  port's kernel path (the hand-written kernels are the port's only path);
  any mode this build does not have (``'pallas-fused'``) fails loudly.

Ensemble runs have their own pair (:func:`save_ensemble_checkpoint` /
:func:`restore_ensemble`) covering every member (and its key) and the
shared host stream, on every route the ensemble runs (the float64 ozaki
route included);
the restore takes the members' kappas from the file (the values the JAX
package derives with sympy, which the card's machine lacks).

Under a mesh of ranks the file holds the whole field (every member's):
the save gathers it on every rank, rank 0 alone writes, and every rank
meets at a barrier after the write, so none reads a file that is not
there yet.  A restore runs on every rank and takes the rank's block (its
members' blocks).  A single run's restore takes the mesh shape from the
file (as the JAX package's does); an ensemble's file is mesh-free host
state and restores onto any mesh the caller passes, or none (the elastic
restart).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from .core.state import jax_prng_key, key_tensor  # noqa: F401
from .params import TUPLE_FIELDS, Parameters

FORMAT_VERSION = 2

# the array of the port's former device jitter stream (torch.Generator
# state bytes), which files of that version hold
TORCH_GENERATOR_KEY = 'torch_jitter_generator'


def _atomic_savez(fname: str, **arrays) -> None:
    """Crash-safe ``np.savez_compressed``: written to a temp file beside
    the target, fsynced, then renamed over it (a kill mid-write never
    corrupts the previous checkpoint).  Writing through a file object
    also keeps numpy from appending '.npz' to an extensionless name."""
    fname = os.fspath(fname)
    d = os.path.dirname(os.path.abspath(fname)) or '.'
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(fname) + '.tmp.')
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _params_from_header(header: dict, device='cuda') -> Parameters:
    """Parameters from a checkpoint header, validated against this
    build's mode choices (the JAX package's checks): a mode since deleted
    (``kernel_backend='pallas-fused'``) fails loudly instead of restoring
    onto another compute path.  ``device`` is the caller's."""
    params = Parameters()
    names = {f.name for f in dataclasses.fields(params)}
    for k, v in header['params'].items():
        if k in names and k != 'version':
            if k in TUPLE_FIELDS and v is not None:
                v = tuple(v)
            setattr(params, k, v)
    kb = params.kernel_backend
    if kb not in ('xla', 'pallas'):
        raise ValueError(
            f"checkpoint requests kernel_backend={kb!r}, which this build "
            "does not provide (choices: xla, pallas; 'pallas-fused' was "
            "removed in round 3)")
    # both are the hand-written kernels here
    params.kernel_backend = 'xla'
    tb = params.transform_backend
    if tb not in ('auto', 'matmul', 'split', 'fft', 'ozaki'):
        raise ValueError(
            f"checkpoint requests transform_backend={tb!r}, which this "
            "build does not provide")
    params.device = device
    return params


def _header_bytes(header: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)


def _load(fname: str):
    z = np.load(fname, allow_pickle=False)
    header = json.loads(bytes(z['header']).decode())
    if header['format_version'] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version "
                         f"{header['format_version']}")
    if TORCH_GENERATOR_KEY in z.files:
        raise ValueError(
            f"{fname} holds a torch.Generator state for the 'device' "
            "jitter ('torch_jitter_generator'): the port's device jitter "
            "stream has changed since that file was written (it is now "
            "the JAX package's threefry stream, carried in rng_key), so "
            "the run cannot continue its stream; restart it")
    return z, header


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _lead(mesh) -> bool:
    """True on the rank that writes: rank 0 of the world (every rank
    without a mesh)."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _written(mesh) -> None:
    """Every rank of a mesh waits here until rank 0 has written."""
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()


# ----------------------------------------------------------------------
# single run
# ----------------------------------------------------------------------

def save_checkpoint(fname: str, solver) -> None:
    """Serialize a Solver's resumable state.  Under a mesh every rank
    calls it: the field is the gathered ``solution.U`` (the solver sets
    it at every chunk boundary it saves at and at the end of a solve);
    rank 0 writes, then every rank meets at a barrier.  The field is
    written in the natural layout (a folded state is unfolded), as the
    JAX package writes it."""
    sol = solver.solution
    U = solver.field_state(solver._state.U) if solver.mesh is None \
        else sol.U
    if not _lead(solver.mesh):
        _written(solver.mesh)
        return
    header = {
        'format_version': FORMAT_VERSION,
        'computed_steps': sol.computed_steps,
        'tau0': sol.tau0,
        't0': sol.t0,
        'stop_reason': sol.stop_reason,
        'skip_check': solver.skip_check,
        'time_delta_sum': solver.time_delta_sum,
        'delt': solver.delt,
        'params': solver.params.scalar_dict(),
        'generator_state': (solver.generator.state_dict()
                            if solver.generator is not None else None),
    }
    arrays = dict(
        header=_header_bytes(header),
        U=_host(U).astype(np.float64),
        timedata=sol.timedata.data(),
        rng_key=_host(solver._state.rng_key).astype(np.uint32),
        U_init=np.asarray(solver.U_init, dtype=np.float64),
    )
    _atomic_savez(fname, **arrays)
    _written(solver.mesh)


def load_checkpoint(fname: str, device='cuda'):
    """(params, payload dict) — build a Solver via :func:`restore_solver`."""
    z, header = _load(fname)
    params = _params_from_header(header, device)
    payload = {
        'header': header,
        'U': z['U'],
        'timedata': z['timedata'],
        'rng_key': z['rng_key'],
        'generator_state': header.get('generator_state'),
        'U_init': z['U_init'],
    }
    return params, payload


def restore_solver(fname: str, device='cuda', dist_backend=None,
                   mesh_shape=None):
    """A prepared Solver on ``device``, mid-run, from a checkpoint written
    by either package.  The file's ``mesh_shape`` holds unless the caller
    gives one (a world of another shape; ``dist_backend``: the caller's,
    as ``device``): under a mesh every rank of the process group calls it
    and takes its block of the field (on the pencil layout its column
    block; the spectral image is rebuilt at the solve's entry)."""
    from .core.solver import Solver
    from .parallel.sharding import shard_field
    from .rng import FieldGenerator
    from .timedata import TimeData

    params, payload = load_checkpoint(fname, device)
    params.dist_backend = dist_backend
    if mesh_shape is not None:
        params.mesh_shape = tuple(mesh_shape)
    h = payload['header']
    solver = Solver(params, U_init=payload['U_init'])
    if payload['generator_state'] is not None:
        solver.generator = FieldGenerator.from_state(
            payload['generator_state'])
    solver.skip_check = h['skip_check']
    solver.time_delta_sum = h['time_delta_sum']
    solver.time_passed = h['time_delta_sum'] / params.M_tilde
    solver.delt = h['delt']
    solver.prepare()

    td = TimeData()
    td.insert_block(payload['timedata'])
    sol = solver.solution
    sol.timedata = td
    sol.computed_steps = h['computed_steps']
    sol.tau0 = h['tau0']
    sol.t0 = h['t0']
    sol.stop_reason = h['stop_reason']

    dev = solver.device
    f64 = torch.float64
    rows = payload['timedata']
    U = torch.as_tensor(payload['U']).to(device=dev,
                                         dtype=solver.cfg.tdtype)
    sol.U = U
    if solver.mesh is not None:
        U = shard_field(U, solver.field_mesh)[0]
    U = solver.field_state(U)

    def f(x):
        return torch.tensor(float(x), dtype=f64, device=dev)

    solver._state = solver._state.replace(
        U=U,
        delt=f(h['delt']),
        time_delta_sum=f(h['time_delta_sum']),
        computed_steps=torch.tensor(int(h['computed_steps']),
                                    dtype=torch.int64, device=dev),
        skip_check=torch.tensor(bool(h['skip_check']), device=dev),
        tau0=f(h['tau0']),
        t0=f(h['t0']),
        E2_first=f(rows[0, 2]),
        E2_prev=f(rows[-1, 2]),
        # after prepare(), which resets the key
        rng_key=key_tensor(payload['rng_key'], dev),
    )
    return solver


# ----------------------------------------------------------------------
# ensemble
# ----------------------------------------------------------------------

# per-member leaves and their dtypes in the JAX package's files
_ENS_LEAVES = {'delt': np.float64, 'time_delta_sum': np.float64,
               'computed_steps': np.int32, 'skip_check': np.bool_,
               'stop_reason': np.int32, 'tau0': np.float64,
               't0': np.float64, 'E2_first': np.float64,
               'E2_prev': np.float64}


def save_ensemble_checkpoint(fname: str, ens, extra_header: dict = None
                             ) -> None:
    """Serialize an EnsembleSolver's resumable state: every member's
    field, counters and trace, the (A0, A1) pairs, the kappas, and the
    shared host generator's stream position.  ``extra_header`` lets a
    caller (the UQ experiment) keep its own JSON-serializable progress in
    the header.  Under a mesh every rank calls it (the members are
    gathered); rank 0 writes."""
    s = ens.host_state()
    if not _lead(ens.mesh):
        _written(ens.mesh)
        return
    header = {
        'format_version': FORMAT_VERSION,
        'kind': 'ensemble',
        'R': ens.R,
        'params': ens.params.scalar_dict(),
        'row_counts': [len(td) for td in ens.timedatas],
        'generator_state': (ens.generator.state_dict()
                            if ens.generator is not None else None),
        'extra': extra_header,
    }
    _atomic_savez(
        fname,
        header=_header_bytes(header),
        U=s['U'].astype(np.float64),
        rng_key=s['rng_key'].astype(np.uint32),
        A_pairs=np.stack([ens.A0s, ens.A1s], axis=1),
        kappas=np.asarray(ens.kappas),
        timedata=np.concatenate([td.data() for td in ens.timedatas],
                                axis=0),
        U_init=np.asarray(ens.U_init, dtype=np.float64),
        **{f'm_{n}': s[n].astype(dt) for n, dt in _ENS_LEAVES.items()},
    )
    _written(ens.mesh)


def restore_ensemble(fname: str, mesh=None, device='cuda'):
    """A prepared EnsembleSolver on ``device``, mid-run, from an ensemble
    checkpoint written by either package, on ``mesh`` (an EnsembleMesh;
    every rank calls it) or on one device, whatever mesh wrote it."""
    from .ensemble import EnsembleSolver
    from .rng import FieldGenerator
    from .timedata import TimeData

    z, header = _load(fname)
    if header.get('kind') != 'ensemble':
        raise ValueError(f"{fname} is not an ensemble checkpoint")
    params = _params_from_header(header, device)
    # the caller's mesh (or none) places the members, not the writer's
    params.mesh_shape = None
    ens = EnsembleSolver(params, np.asarray(z['A_pairs']),
                         U_init=np.asarray(z['U_init']), mesh=mesh,
                         kappas=np.asarray(z['kappas']))
    if header.get('generator_state') is not None:
        ens.generator = FieldGenerator.from_state(header['generator_state'])
    ens.prepare()

    rows = np.asarray(z['timedata'])
    offs = np.cumsum([0] + list(header['row_counts']))
    ens.timedatas = []
    for r in range(header['R']):
        td = TimeData()
        td.insert_block(rows[offs[r]:offs[r + 1]])
        ens.timedatas.append(td)

    host = {'U': np.asarray(z['U']), 'rng_key': np.asarray(z['rng_key'])}
    host.update({n: np.asarray(z[f'm_{n}']) for n in _ENS_LEAVES})
    ens.load_host_state(host)
    ens._ckpt_extra = header.get('extra')
    return ens
