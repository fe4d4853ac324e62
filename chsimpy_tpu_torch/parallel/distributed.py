"""Process groups for the grid-sharded solve.

Counterpart of ``chsimpy_tpu/parallel/distributed.py``.  JAX runs one
program over many devices; here each mesh device is a process (a rank) of
a ``torch.distributed`` process group:

* :func:`initialize` joins the group ``torchrun`` describes in the
  environment (``env://``) and binds the rank's card;
* :func:`spawn_grid` starts a world of ranks from Python (the tests and
  ``chip_smoke.py``) and returns each rank's result;
* :class:`Heartbeat` logs liveness and progress per rank.

The backend is stated, never guessed at run time: ``nccl`` (one card per
rank; NCCL refuses two ranks on one card) or ``gloo`` (CPU tensors; with
the blocks on a card every collective is staged through host memory, see
``GridMesh.staged``).  The default is ``nccl`` for 'cuda' and ``gloo`` for
'cpu'.
"""

from __future__ import annotations

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
from .mesh import GridMesh, check_grid_shape

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


def initialize(backend: Optional[str] = None, device='cuda') -> dict:
    """Join the process group of a ``torchrun`` launch (``env://``:
    RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) unless one is initialized, and bind the rank's card.
    Without those variables (a plain single process) nothing is joined.
    Returns a topology summary."""
    if not dist.is_initialized() and 'WORLD_SIZE' in os.environ:
        backend = resolve_backend(backend, device)
        world = int(os.environ['WORLD_SIZE'])
        local_rank = int(os.environ.get('LOCAL_RANK', 0))
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        bind_device(device, backend, local_rank, local_world)
        dist.init_process_group(backend, init_method='env://')
    if not dist.is_initialized():
        return {'process_index': 0, 'process_count': 1, 'backend': None}
    return {'process_index': dist.get_rank(),
            'process_count': dist.get_world_size(),
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

def _rank_main(rank, world, store, fn, mesh_shape, backend, device, args,
               results, threads):
    """Body of one spawned rank: join the group, build the mesh, run
    ``fn(mesh, *args)`` and send back (rank, ok, result or traceback)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        bind_device(device, backend, rank, world)
        dist.init_process_group(backend, init_method=f'file://{store}',
                                rank=rank, world_size=world)
        mesh = GridMesh(mesh_shape, _rank_device(device))
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


def spawn_grid(fn, mesh_shape: Sequence[int], backend: Optional[str] = None,
               device='cuda', args: tuple = (), timeout: float = 600.0,
               threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a new ``mx x my`` world
    and return the results as a list indexed by rank.

    Ranks are processes started with the *spawn* method (a forked child
    cannot use CUDA), so ``fn`` must be importable by name: a function of
    this package, never of a test file (a rank imports no jax).  They meet
    through a ``file://`` store in a fresh temporary directory, so worlds
    started side by side never share a port.  For a run on the card the
    kernels are built here first, so the ranks load one library instead
    of compiling it four times.  A rank that raises, or a world that runs
    past ``timeout`` seconds, ends every rank and raises here."""
    mx, my = check_grid_shape(mesh_shape)
    world = mx * my
    backend = resolve_backend(backend, device)
    if torch.device(device).type == 'cuda':
        build()
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix='chsimpy_world_')
    store = os.path.join(tmp, 'store')
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, fn, (mx, my), backend,
                               str(device), tuple(args), results, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out = [None] * world
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"world {mx}x{my} ({backend}, {device}) "
                                   f"gave no result within {timeout} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of the {mx}x{my} world "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
