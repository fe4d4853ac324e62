"""Blocks of the field, the constants and the state on a grid mesh.

Port of the grid parts of ``chsimpy_tpu/parallel/sharding.py``: the field
is tiled ``P('x', 'y')``, rank ``(i, j)`` holding rows ``[i*bn, (i+1)*bn)``
and columns ``[j*bw, (j+1)*bw)`` with ``bn = N/mx``, ``bw = N/my``.  The
pencil layout of the split and ozaki routes is not ported (ROADMAP.md
queue A item 11).
"""

from __future__ import annotations

import torch

from . import collectives


def block_slices(mesh, N: int):
    """(rows, cols) slices of this rank's block of an (N, N) array."""
    mx, my = mesh.shape
    if N % mx or N % my:
        raise ValueError(f"N={N} does not tile a {mx}x{my} mesh")
    bn, bw = N // mx, N // my
    i, j = mesh.coords
    return slice(i * bn, (i + 1) * bn), slice(j * bw, (j + 1) * bw)


def shard_field(U: torch.Tensor, mesh):
    """(this rank's block of the (N, N) field U, row_off, col_off); the
    block is a contiguous copy."""
    rows, cols = block_slices(mesh, U.shape[0])
    return U[rows, cols].contiguous(), rows.start, cols.start


def gather_field(Ub: torch.Tensor, mesh) -> torch.Tensor:
    """The full (N, N) field from every rank's block, on every rank (a
    collective: every rank calls it)."""
    mx, my = mesh.shape
    bn, bw = Ub.shape
    blocks = collectives.gather_world(mesh, Ub)         # (mx*my, bn, bw)
    return (blocks.reshape(mx, my, bn, bw).permute(0, 2, 1, 3)
            .reshape(mx * bn, my * bw))


# the (N, N) grids of the spectral update: blocks of the spectral image
_GRIDS = ('leig', 'CHeig', 'Seig')


def shard_consts(consts: dict, mesh) -> dict:
    """The eigenvalue and coefficient grids as this rank's blocks; the DCT
    matrix C stays whole (the grid transforms read its row and column
    strips in place), and so does everything else."""
    out = dict(consts)
    for k in _GRIDS:
        out[k] = shard_field(consts[k], mesh)[0]
    return out


def shard_state(state, mesh):
    """U and hat_U as this rank's blocks; the scalars and the row buffer
    stay whole (every rank holds the same values)."""
    return state.replace(U=shard_field(state.U, mesh)[0],
                         hat_U=shard_field(state.hat_U, mesh)[0])
