"""Blocks of the field, the constants and the state on a mesh.

Port of the grid and ensemble parts of ``chsimpy_tpu/parallel/sharding.py``:
the field is tiled ``P('x', 'y')``, rank ``(i, j)`` holding rows
``[i*bn, (i+1)*bn)`` and columns ``[j*bw, (j+1)*bw)`` with ``bn = N/mx``,
``bw = N/my``; a stack of members' fields (R, N, N) is tiled the same way
member by member.  On an ensemble mesh the member axis is split as JAX's
``P('ens')`` splits it: ens slot ``e`` holds the contiguous members
``[e*R/E, (e+1)*R/E)`` (:func:`shard_members`).

The pencil layout of the split and ozaki routes is the grid layout of a
grid's ``field_view`` (the field's column blocks, a ``(1, D)`` mesh) and
``spec_view`` (the spectral image's row blocks, ``(D, 1)``;
``parallel/mesh.py``): :func:`shard_field` and :func:`gather_field` take
either view, and :func:`shard_consts` places the spectral grids as row
blocks with ``pencil=True``.  The ozaki route where the rank count does
not divide N keeps the grid layout: each rank holds the blocks of the
DCT's slice stacks its products read (:func:`ozaki_grid_stacks`).
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
    block is a contiguous copy.  A member stack (R, N, N) gives each
    member's block, (R, bn, bw)."""
    rows, cols = block_slices(mesh, U.shape[-1])
    return U[..., rows, cols].contiguous(), rows.start, cols.start


def gather_field(Ub: torch.Tensor, mesh) -> torch.Tensor:
    """The full (N, N) field from every rank's block, on every rank of
    the grid (a collective: every rank calls it); member blocks (R, bn,
    bw) give the members' fields (R, N, N)."""
    mx, my = mesh.shape
    lead = tuple(Ub.shape[:-2])
    bn, bw = Ub.shape[-2:]
    blocks = collectives.gather_world(mesh, Ub)    # (mx*my, ..., bn, bw)
    k = len(lead)
    out = blocks.reshape((mx, my) + lead + (bn, bw)).permute(
        *range(2, 2 + k), 0, 2 + k, 1, 3 + k)
    return out.reshape(lead + (mx * bn, my * bw))


def member_slice(mesh, R: int) -> slice:
    """The members [e*R/E, (e+1)*R/E) of this rank's ens slot e (all R
    without a mesh); R % E raises, as JAX's ``P('ens')`` refuses an axis
    its size does not divide."""
    if mesh is None:
        return slice(0, R)
    E = mesh.n_ens
    if R % E:
        raise ValueError(f"{R} members do not split over the {E} ens "
                         f"slots of the mesh: the global size of the "
                         f"member axis must be divisible by {E}")
    n = R // E
    return slice(mesh.slot * n, (mesh.slot + 1) * n)


def shard_members(x, mesh):
    """This rank's members of ``x`` (its leading axis is the member axis:
    a numpy array), a copy."""
    return x[member_slice(mesh, x.shape[0])].copy()


def gather_members(t: torch.Tensor, mesh) -> torch.Tensor:
    """All members of ``t`` (this rank's members along dim 0), on every
    rank, in member order (a collective over the ens axis)."""
    return collectives.gather_ens(mesh, t)


# the (N, N) grids of the spectral update: blocks of the spectral image
_GRIDS = ('leig', 'CHeig', 'Seig')


def ozaki_grid_stacks(Cs: torch.Tensor, CsT: torch.Tensor, mesh) -> dict:
    """The blocks of the DCT's int8 slice stacks (S, N, N) that a rank of
    the grid ozaki route reads (``ops/ozaki.py`` ``dct2_ozaki_grid``),
    each contiguous: the forward's C rows I and C^T columns J, the
    inverse's C^T rows I and C columns J, for this rank's block (I, J)."""
    I, J = block_slices(mesh, Cs.shape[-1])
    return {'fwd': (Cs[:, I].contiguous(), CsT[..., J].contiguous()),
            'inv': (CsT[:, I].contiguous(), Cs[..., J].contiguous())}


def shard_consts(consts: dict, mesh, pencil: bool = False) -> dict:
    """The eigenvalue and coefficient grids as this rank's blocks; the DCT
    matrix C stays whole (the grid transforms read its row and column
    strips in place), and so does everything else but the ozaki route's
    slice stacks on the grid layout, which give way to the blocks this
    rank reads (``'ozaki_grid'``, :func:`ozaki_grid_stacks`).
    ``pencil``: the grids live in spectral space, so they take the
    spectral layout, this rank's row block (on the split route the
    permuted grids)."""
    spec = mesh.spec_view if pencil else mesh
    out = dict(consts)
    for k in _GRIDS:
        out[k] = shard_field(consts[k], spec)[0]
    if not pencil and consts['Cs'].numel():
        out['ozaki_grid'] = ozaki_grid_stacks(consts['Cs'], consts['CsT'],
                                              mesh)
        out['Cs'] = out['CsT'] = consts['Cs'][:0]
    return out


def shard_state(state, mesh):
    """U and hat_U as this rank's blocks; the scalars and the row buffer
    stay whole (every rank holds the same values)."""
    return state.replace(U=shard_field(state.U, mesh)[0],
                         hat_U=shard_field(state.hat_U, mesh)[0])
