"""The collectives of the grid-sharded step.

Counterpart of the ``shard_map`` / ``ppermute`` / ``psum`` pieces of
``chsimpy_tpu/ops/pallas_kernels.py`` (``_neighbor_views``,
``fused_stats_sharded``) and of the collectives GSPMD inserts around the
sharded DCT products (``parallel/sharding.py`` of the JAX package):

* :func:`halo` — the four edge vectors the stencil needs from the
  neighbour blocks, exchanged point to point; at the global boundary a
  block's own edge stands in (edge replication, as ``_neighbor_views``);
* :func:`gather_x` / :func:`gather_y` — all-gathers over the rank's
  column strip (``x_group``) or row strip (``y_group``), concatenated
  along the row axis (dim -2) in coordinate order; a stack of members'
  blocks (R, bh, bw) gives the members' strips (R, ., bw);
* :func:`gather_world` and :func:`rank_sum` — every rank's partial sums on
  every rank of the grid (an ensemble mesh: of its ens slot), added in
  rank order;
* :func:`gather_ens` — the all-gather over the ens axis of an
  :class:`~.mesh.EnsembleMesh` (the ranks at the same grid coordinates),
  concatenated along dim 0 in ``e`` order.  ``all_reduce`` leaves its order to
  the backend; here each rank adds the same numbers in the same order, so
  every rank holds the same bits.  The stop predicate rests on that: a
  rank whose E2 differed by one ulp could stop alone and leave the others
  waiting in the next collective.

Each is called on every step by every rank, whether or not the run has
stopped (the stepper freezes the state with ``torch.where``), so all ranks
issue the same sequence.  On a staged mesh (gloo with the blocks on a
card) each operand is copied to host memory and each result back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# tags of the four halo messages (gloo matches on them; NCCL ignores them)
_TAG_UP, _TAG_DOWN, _TAG_LEFT, _TAG_RIGHT = 1, 2, 3, 4


def _wire(mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if mesh.staged else t


def _home(mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def _gather(mesh, t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along dim 0."""
    if n == 1:
        return t.contiguous()
    src = _wire(mesh, t)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return _home(mesh, out)


def _gather_rows(mesh, t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated along dim -2: dim 0 of a 2-D
    block; each member's rows of a member stack (R, a, b) -> (R, n*a, b)
    (gathered along dim 0, then one copy into the members' layout)."""
    if t.dim() == 2 or n == 1:
        return _gather(mesh, t, group, n)
    R, a, b = t.shape
    out = _gather(mesh, t, group, n)                     # (n*R, a, b)
    return out.reshape(n, R, a, b).transpose(0, 1).reshape(R, n * a, b)


def gather_x(mesh, t: torch.Tensor) -> torch.Tensor:
    """All-gather over the ``mx`` ranks of this rank's column strip."""
    return _gather_rows(mesh, t, mesh.x_group, mesh.shape[0])


def gather_y(mesh, t: torch.Tensor) -> torch.Tensor:
    """All-gather over the ``my`` ranks of this rank's row strip."""
    return _gather_rows(mesh, t, mesh.y_group, mesh.shape[1])


def gather_world(mesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every grid rank's ``t``, in rank order."""
    out = _gather(mesh, t.reshape((1,) + tuple(t.shape)), mesh.group,
                  mesh.size)
    return out.reshape((mesh.size,) + tuple(t.shape))


def gather_ens(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every ens slot's ``t`` at this rank's grid coordinates,
    concatenated along dim 0 in ``e`` order (an all-gather over the
    ``ens_group`` of an :class:`~.mesh.EnsembleMesh`)."""
    return _gather(mesh, t, mesh.ens_group, mesh.n_ens)


def rank_sum(gathered: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of a gathered (size, ...) tensor, in rank order."""
    acc = gathered[0]
    for r in range(1, gathered.shape[0]):
        acc = acc + gathered[r]
    return acc


def halo(mesh, Ub: torch.Tensor):
    """(up_row, dn_row, lf_col, rt_col) of the local block ``Ub`` (bn, W):
    the last row of the block above, the first row of the block below
    (each (W,)), the last column of the block to the left and the first
    column of the block to the right (each (bn,)).  A block on the global
    boundary gets its own edge on that side.  Only these four vectors
    cross ranks: one message to each neighbour and one from it.  A member
    stack (R, bn, W) gives (R, W) rows and (R, bn) columns, each member's
    edges in one message a side."""
    mx, my = mesh.shape
    i, j = mesh.coords
    first_row = Ub[..., 0, :].contiguous()
    last_row = Ub[..., -1, :].contiguous()
    first_col = Ub[..., :, 0].contiguous()
    last_col = Ub[..., :, -1].contiguous()
    out = {'up': first_row, 'dn': last_row, 'lf': first_col,
           'rt': last_col}
    # (side received, neighbour, edge sent to it, its tag, tag received)
    links = []
    if i > 0:
        links.append(('up', mesh.rank_at(i - 1, j), first_row, _TAG_UP,
                      _TAG_DOWN))
    if i < mx - 1:
        links.append(('dn', mesh.rank_at(i + 1, j), last_row, _TAG_DOWN,
                      _TAG_UP))
    if j > 0:
        links.append(('lf', mesh.rank_at(i, j - 1), first_col, _TAG_LEFT,
                      _TAG_RIGHT))
    if j < my - 1:
        links.append(('rt', mesh.rank_at(i, j + 1), last_col, _TAG_RIGHT,
                      _TAG_LEFT))
    if not links:
        return out['up'], out['dn'], out['lf'], out['rt']
    ops, recvs = [], []
    for side, peer, edge, tag_out, tag_in in links:
        send = _wire(mesh, edge)
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, peer, tag=tag_out))
        ops.append(dist.P2POp(dist.irecv, recv, peer, tag=tag_in))
        recvs.append((side, recv))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for side, recv in recvs:
        out[side] = _home(mesh, recv)
    return out['up'], out['dn'], out['lf'], out['rt']
