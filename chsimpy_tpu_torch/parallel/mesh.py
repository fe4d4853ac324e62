"""The 2-D grid mesh of ranks.

Port of the grid part of ``chsimpy_tpu/parallel/mesh.py``.  JAX builds a
``Mesh`` of devices with axes ``('x', 'y')``; here the devices are the
ranks of the default ``torch.distributed`` process group, one process per
JAX mesh device.  Rank ``r`` sits at ``(r // my, r % my)``, the order of
JAX's ``np.asarray(devices).reshape(shape)``: the field's row blocks run
along ``x``, its column blocks along ``y``.

Each rank holds two subgroups:

* ``x_group`` — the ``mx`` ranks ``(0..mx-1, j)`` that hold the row blocks
  of this rank's column strip (the JAX mesh axis ``'x'``);
* ``y_group`` — the ``my`` ranks ``(i, 0..my-1)`` of this rank's row strip
  (axis ``'y'``).

A group's rank order is the coordinate along its axis, so an all-gather
over a group lands the blocks in field order.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

TORCHRUN_HINT = ("start one process per mesh device, e.g. "
                 "`torchrun --standalone --nproc-per-node {n} -m "
                 "chsimpy_tpu_torch --mesh {mx}x{my} ...`, or call "
                 "torch.distributed.init_process_group with world size {n} "
                 "first")


def check_grid_shape(shape: Sequence[int]) -> tuple:
    shape = tuple(shape)
    if len(shape) != 2 or any(int(v) != v or v < 1 for v in shape):
        raise ValueError(f"grid mesh shape must be two positive integers, "
                         f"got {shape}")
    return tuple(int(v) for v in shape)


def best_grid_shape(n_devices: int) -> tuple:
    """Near-square 2-D factorization of n_devices (minimizes the
    all-to-all transpose volume of the distributed DCT)."""
    best = (1, n_devices)
    for a in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % a == 0:
            best = (a, n_devices // a)
    return best


class GridMesh:
    """``mx x my`` ranks of the initialized default process group.

    ``device`` is where this rank's blocks live.  ``staged`` is True when
    the collectives run on gloo with the blocks on a card: gloo moves CPU
    tensors, so every collective copies its operand to host memory and its
    result back (:mod:`.collectives`).  It is a property of the mesh,
    printed by :meth:`describe`; no backend is ever switched at run time.
    """

    def __init__(self, shape: Sequence[int], device):
        mx, my = check_grid_shape(shape)
        n = mx * my
        hint = TORCHRUN_HINT.format(n=n, mx=mx, my=my)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"--mesh {mx}x{my} needs a torch.distributed "
                               f"process group of {n} ranks and there is "
                               f"none: {hint}")
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(f"--mesh {mx}x{my} needs {n} ranks but the "
                               f"process group has {world}: {hint}")
        self.shape = (mx, my)
        self.size = n
        self.rank = dist.get_rank()
        self.coords = (self.rank // my, self.rank % my)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        if self.backend == 'nccl' and self.device.type != 'cuda':
            raise ValueError("the nccl backend moves CUDA tensors; a run on "
                             "the CPU takes --dist-backend gloo")
        self.staged = self.backend == 'gloo' and self.device.type == 'cuda'
        i, j = self.coords
        # every rank creates every group, in the same order
        self.x_group = self.y_group = None
        for jj in range(my):
            g = dist.new_group([ii * my + jj for ii in range(mx)])
            if jj == j:
                self.x_group = g
        for ii in range(mx):
            g = dist.new_group([ii * my + jj for jj in range(my)])
            if ii == i:
                self.y_group = g
        # one collective over the whole world before any point-to-point
        # exchange (NCCL wants all ranks in a group's first call)
        dist.barrier()

    def rank_at(self, i: int, j: int) -> int:
        return i * self.shape[1] + j

    def describe(self) -> str:
        mx, my = self.shape
        how = ('staged through host memory (gloo moves CPU tensors)'
               if self.staged else f'on {self.device.type} tensors')
        return (f"mesh {mx}x{my}: {self.size} ranks, backend "
                f"{self.backend}, collectives {how}")
