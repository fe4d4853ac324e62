"""Process groups for the grid-sharded solve.

Counterpart of ``chsimpy_tpu/parallel/distributed.py``.  JAX runs one
program over many devices; here each mesh device is a process (a rank) of
a ``torch.distributed`` process group:

* :func:`initialize` joins a process group and binds the rank's card:
  the one ``torchrun`` describes in the environment (``env://``), or,
  with JAX's ``coordinator_address``, ``num_processes`` and
  ``process_id``, the one that meets at that TCP address (the
  multi-process experiment's ``--coordinator``);
* :func:`spawn_world` starts a world of ranks from Python (the tests and
  ``chip_smoke.py``) on an ('ens', 'x', 'y') mesh and returns each rank's
  result; :func:`spawn_grid` is its grid-only case;
* :class:`Heartbeat` logs liveness and progress per rank.

The backend is stated, never guessed at run time: ``nccl`` (one card per
rank; NCCL refuses two ranks on one card) or ``gloo`` (CPU tensors; with
the blocks on a card every collective is staged through host memory, see
``GridMesh.staged``).  The default is ``nccl`` for 'cuda' and ``gloo`` for
'cpu'.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue
import shutil
import tempfile
import threading
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.cuda_build import build
from .mesh import EnsembleMesh, GridMesh, check_grid_shape

logger = logging.getLogger('chsimpy_tpu_torch.distributed')

BACKENDS = ('nccl', 'gloo')


def resolve_backend(backend: Optional[str], device) -> str:
    """``backend`` checked against ``device``; None picks nccl for a card,
    gloo for the CPU."""
    kind = torch.device(device).type
    if backend is None:
        return 'nccl' if kind == 'cuda' else 'gloo'
    if backend not in BACKENDS:
        raise ValueError(f"unknown --dist-backend {backend!r}; "
                         f"choose one of {BACKENDS}")
    if backend == 'nccl' and kind != 'cuda':
        raise ValueError("--dist-backend nccl moves CUDA tensors; a run on "
                         "the CPU takes gloo")
    return backend


def bind_device(device, backend: str, local_rank: int,
                local_world: int) -> None:
    """Make this rank's card the current one.  NCCL takes one card per
    rank (``local_rank``) and raises when the host has fewer cards than
    ranks; gloo lets ranks share cards (rank modulo the card count)."""
    if torch.device(device).type != 'cuda':
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available on this machine")
    count = torch.cuda.device_count()
    if backend == 'nccl':
        if count < local_world:
            raise RuntimeError(
                f"--dist-backend nccl takes one card per rank: {local_world}"
                f" ranks on this host, {count} card(s); run fewer ranks or "
                f"--dist-backend gloo (ranks share cards, collectives "
                f"staged through host memory)")
        torch.cuda.set_device(local_rank)
    else:
        torch.cuda.set_device(local_rank % count)


def initialize(backend: Optional[str] = None, device='cuda',
               coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: float = 600.0) -> dict:
    """Join a process group unless one is initialized, bind the rank's
    card and return the topology in the keys of the JAX package's
    ``initialize`` (``process_index``, ``process_count``,
    ``local_devices``: 1, a process per device; ``global_devices``) and
    the backend.

    With ``coordinator_address`` (host:port), ``num_processes`` and
    ``process_id`` the processes meet at that address (``tcp://``); the
    process binds card ``process_id`` modulo the host's cards (nccl: one
    card each, so more processes than cards raises).  A process whose
    peers do not all come within ``timeout`` seconds raises naming the
    coordinator.  Without them it joins the group of a ``torchrun``
    launch (``env://``: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); with neither, nothing is joined."""
    if not dist.is_initialized():
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address needs "
                                 "num_processes and process_id")
            if not 0 <= process_id < num_processes:
                raise ValueError(f"process_id {process_id} is not in "
                                 f"[0, {num_processes})")
            backend = resolve_backend(backend, device)
            bind_device(device, backend, process_id, num_processes)
            try:
                dist.init_process_group(
                    backend, init_method=f'tcp://{coordinator_address}',
                    rank=process_id, world_size=num_processes,
                    timeout=datetime.timedelta(seconds=timeout))
            except Exception as e:
                raise RuntimeError(
                    f"process {process_id} of {num_processes} could not "
                    f"form the process group at coordinator "
                    f"{coordinator_address} ({backend}) within {timeout:g} "
                    f"s: {e}") from e
        elif 'WORLD_SIZE' in os.environ:
            backend = resolve_backend(backend, device)
            world = int(os.environ['WORLD_SIZE'])
            local_rank = int(os.environ.get('LOCAL_RANK', 0))
            local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
            bind_device(device, backend, local_rank, local_world)
            dist.init_process_group(backend, init_method='env://')
    if not dist.is_initialized():
        return {'process_index': 0, 'process_count': 1, 'local_devices': 1,
                'global_devices': 1, 'backend': None}
    world = dist.get_world_size()
    return {'process_index': dist.get_rank(), 'process_count': world,
            'local_devices': 1, 'global_devices': world,
            'backend': str(dist.get_backend())}


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Heartbeat:
    """Background thread logging liveness + step progress per rank."""

    def __init__(self, interval_s: float = 60.0, get_progress=None):
        self.interval_s = interval_s
        self.get_progress = get_progress
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        def loop():
            while not self._stop.wait(self.interval_s):
                rank, world = ((dist.get_rank(), dist.get_world_size())
                               if dist.is_initialized() else (0, 1))
                msg = f"heartbeat rank={rank}/{world}"
                if self.get_progress is not None:
                    try:
                        msg += f" progress={self.get_progress()}"
                    except Exception as e:
                        msg += f" progress_error={e}"
                logger.info(msg)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ----------------------------------------------------------------------
# worlds started from Python
# ----------------------------------------------------------------------

def _rank_main(rank, world, store, fn, shape, grid_only, backend, device,
               args, results, threads):
    """Body of one spawned rank: join the group, build the mesh, run
    ``fn(mesh, *args)`` and send back (rank, ok, result or traceback)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        bind_device(device, backend, rank, world)
        dist.init_process_group(backend, init_method=f'file://{store}',
                                rank=rank, world_size=world)
        dev = _rank_device(device)
        mesh = (GridMesh(shape[1:], dev) if grid_only
                else EnsembleMesh(shape[0], shape[1:], dev))
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def _rank_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def _spawn(fn, shape: tuple, grid_only: bool, backend, device, args,
           timeout, threads) -> list:
    world = shape[0] * shape[1] * shape[2]
    name = ('%dx%d' % shape[1:] if grid_only
            else "('ens', 'x', 'y') = (%d, %d, %d)" % shape)
    backend = resolve_backend(backend, device)
    if torch.device(device).type == 'cuda':
        build()
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix='chsimpy_world_')
    store = os.path.join(tmp, 'store')
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, fn, shape, grid_only,
                               backend, str(device), tuple(args), results,
                               threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out = [None] * world
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"world {name} ({backend}, {device}) "
                                   f"gave no result within {timeout} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of the {name} world "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def spawn_world(fn, shape: Sequence[int], backend: Optional[str] = None,
                device='cuda', args: tuple = (), timeout: float = 600.0,
                threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a new world of ``E*mx*my``
    ranks, ``mesh`` an :class:`EnsembleMesh` of ``shape = (E, mx, my)``,
    and return the results as a list indexed by rank.

    Ranks are processes started with the *spawn* method (a forked child
    cannot use CUDA), so ``fn`` must be importable by name: a function of
    this package, never of a test file (a rank imports no jax).  They meet
    through a ``file://`` store in a fresh temporary directory, so worlds
    started side by side never share a port.  For a run on the card the
    kernels are built here first, so the ranks load one library instead
    of compiling it once each.  A rank that raises, or a world that runs
    past ``timeout`` seconds, ends every rank and raises here."""
    shape = tuple(shape)
    if len(shape) != 3 or int(shape[0]) != shape[0] or shape[0] < 1:
        raise ValueError(f"a world's shape is (E, mx, my), got {shape}")
    shape = (int(shape[0]),) + check_grid_shape(shape[1:])
    return _spawn(fn, shape, False, backend, device, args, timeout, threads)


def spawn_grid(fn, mesh_shape: Sequence[int], backend: Optional[str] = None,
               device='cuda', args: tuple = (), timeout: float = 600.0,
               threads: Optional[int] = None) -> list:
    """:func:`spawn_world` of one grid: ``fn(mesh, *args)`` with ``mesh``
    a :class:`GridMesh` of ``mesh_shape = (mx, my)`` on every rank of an
    ``mx*my`` world."""
    shape = (1,) + check_grid_shape(mesh_shape)
    return _spawn(fn, shape, True, backend, device, args, timeout, threads)
