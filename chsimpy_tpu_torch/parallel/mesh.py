"""The meshes of ranks: a 2-D grid, and an ensemble of grids.

Port of ``chsimpy_tpu/parallel/mesh.py``.  JAX builds a ``Mesh`` of
devices; here the devices are the ranks of the default
``torch.distributed`` process group, one process per JAX mesh device.

* :class:`GridMesh` (``make_mesh``): axes ``('x', 'y')``.  Rank ``r`` sits
  at ``(r // my, r % my)``, the order of JAX's
  ``np.asarray(devices).reshape(shape)``: the field's row blocks run along
  ``x``, its column blocks along ``y``.
* :class:`EnsembleMesh` (``make_ensemble_mesh``): axes ``('ens', 'x',
  'y')`` of shape ``(E, mx, my)``.  Rank ``r`` sits at ``(e, i, j) =
  (r // (mx*my), (r // my) % mx, r % my)``.  The ``mx*my`` ranks of ens
  slot ``e`` form a grid of their own (the members' fields are tiled over
  it), and the ``E`` ranks at one ``(i, j)`` hold the same block of
  different members.

Each rank holds its grid's subgroups:

* ``x_group`` — the ``mx`` ranks ``(0..mx-1, j)`` of its slot that hold the
  row blocks of this rank's column strip (the JAX mesh axis ``'x'``);
* ``y_group`` — the ``my`` ranks ``(i, 0..my-1)`` of its row strip (``'y'``);
* ``group`` — the ``mx*my`` ranks of its slot (None: the whole world);

and, on an ensemble mesh, ``ens_group``: the ``E`` ranks at its ``(i, j)``
in ``e`` order.  A group's rank order is the coordinate along its axis, so
an all-gather over a group lands the blocks in field (or member) order.
Every rank creates every group, in the same order.

The pencil layout of the split and ozaki routes (``chsimpy_tpu/parallel/
sharding.py:1-17, 33-60``) shards the field over ONE axis using all ``D =
mx*my`` ranks of the grid, flattened in mesh order: the field's columns
(``P(None, ('x', 'y'))``) and the spectral image's rows (``P(('x', 'y'),
None)``), rank ``r = i*my + j`` holding column block ``r`` and row block
``r``.  That is the grid layout of a ``(1, D)`` mesh, and of a ``(D, 1)``
mesh, over the same ranks in the same order: a grid's ``field_view`` and
``spec_view`` (:class:`PencilView`) are those meshes, so the block
helpers, the halo exchange and the sharded statistics run on a pencil
block unchanged.  The views make no group: their collectives run over
the grid's ``group``.
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


def _require_world(n: int, what: str, hint: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs a torch.distributed process group "
                           f"of {n} ranks and there is none: {hint}")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"{what} needs {n} ranks but the process group "
                           f"has {world}: {hint}")


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
        _require_world(mx * my, f"--mesh {mx}x{my}",
                       TORCHRUN_HINT.format(n=mx * my, mx=mx, my=my))
        self._join(device)
        self._grid_groups(mx, my, 1)
        # one collective over the whole world before any point-to-point
        # exchange (NCCL wants all ranks in a group's first call)
        dist.barrier()

    def _join(self, device) -> None:
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        if self.backend == 'nccl' and self.device.type != 'cuda':
            raise ValueError("the nccl backend moves CUDA tensors; a run on "
                             "the CPU takes --dist-backend gloo")
        self.staged = self.backend == 'gloo' and self.device.type == 'cuda'

    def _grid_groups(self, mx: int, my: int, n_slots: int) -> None:
        """The ``mx x my`` grid of this rank's ens slot: shape, coords and
        size relative to the slot, and the grid groups of every slot
        (every rank creates every group, in the same order)."""
        n = mx * my
        self.shape = (mx, my)
        self.size = n
        self.slot = self.rank // n
        self.base = self.slot * n           # the slot's first rank
        local = self.rank - self.base
        self.coords = (local // my, local % my)
        i, j = self.coords
        self.x_group = self.y_group = self.group = None
        for e in range(n_slots):
            base = e * n
            for jj in range(my):
                g = dist.new_group([base + ii * my + jj for ii in range(mx)])
                if e == self.slot and jj == j:
                    self.x_group = g
            for ii in range(mx):
                g = dist.new_group([base + ii * my + jj for jj in range(my)])
                if e == self.slot and ii == i:
                    self.y_group = g
            if n_slots > 1:
                g = dist.new_group(list(range(base, base + n)))
                if e == self.slot:
                    self.group = g
        self.field_view = PencilView(self, (1, n))
        self.spec_view = PencilView(self, (n, 1))

    def rank_at(self, i: int, j: int) -> int:
        """The global rank at grid coordinates (i, j) of this slot."""
        return self.base + i * self.shape[1] + j

    def describe(self) -> str:
        mx, my = self.shape
        how = ('staged through host memory (gloo moves CPU tensors)'
               if self.staged else f'on {self.device.type} tensors')
        return (f"mesh {mx}x{my}: {self.size} ranks, backend "
                f"{self.backend}, collectives {how}")


class PencilView:
    """The ``(1, D)`` (field) or ``(D, 1)`` (spectral) pencil layout of
    a grid's ``D`` ranks in rank order, with the attributes of a
    :class:`GridMesh` that the blocks and the collectives read.  The axis
    of length 1 has no group (a gather over it is the block itself); the
    other runs over the grid's ``group``."""

    def __init__(self, grid: GridMesh, shape: tuple):
        local = grid.rank - grid.base
        self.grid = grid
        self.shape = shape
        self.size = grid.size
        self.rank, self.base, self.slot = grid.rank, grid.base, grid.slot
        self.device, self.backend, self.staged = (grid.device, grid.backend,
                                                  grid.staged)
        self.group = grid.group
        if shape[0] == 1:
            self.coords = (0, local)
            self.x_group, self.y_group = None, grid.group
        else:
            self.coords = (local, 0)
            self.x_group, self.y_group = grid.group, None

    def rank_at(self, i: int, j: int) -> int:
        return self.base + i * self.shape[1] + j


class EnsembleMesh(GridMesh):
    """``E x mx x my`` ranks of the initialized default process group: the
    counterpart of ``make_ensemble_mesh(E, (mx, my))``.  The grid
    attributes of :class:`GridMesh` describe this rank's ens slot, so the
    grid collectives, kernels and sharding run on it unchanged;
    ``EnsembleMesh(1, (mx, my))`` builds the same groups as ``GridMesh``.
    ``n_ens`` and ``slot`` (the rank's ens index) place the rank on the
    member axis."""

    def __init__(self, n_ens: int, grid_shape: Sequence[int] = (1, 1),
                 device='cuda'):
        if int(n_ens) != n_ens or n_ens < 1:
            raise ValueError(f"n_ens must be a positive integer, got "
                             f"{n_ens!r}")
        E = int(n_ens)
        mx, my = check_grid_shape(grid_shape)
        n = E * mx * my
        hint = (f"start {n} processes (the experiment: --num-processes {n} "
                f"with --coordinator), or call "
                f"torch.distributed.init_process_group with world size {n} "
                f"first")
        _require_world(n, f"the ('ens', 'x', 'y') mesh ({E}, {mx}, {my})",
                       hint)
        self._join(device)
        self._grid_groups(mx, my, E)
        self.n_ens = E
        self.ens_group = None
        if E > 1:
            for ii in range(mx):
                for jj in range(my):
                    g = dist.new_group([e * mx * my + ii * my + jj
                                        for e in range(E)])
                    if (ii, jj) == self.coords:
                        self.ens_group = g
        dist.barrier()

    def describe(self) -> str:
        mx, my = self.shape
        how = ('staged through host memory (gloo moves CPU tensors)'
               if self.staged else f'on {self.device.type} tensors')
        return (f"mesh ('ens', 'x', 'y') = ({self.n_ens}, {mx}, {my}): "
                f"{self.n_ens * self.size} ranks, backend {self.backend}, "
                f"collectives {how}")
