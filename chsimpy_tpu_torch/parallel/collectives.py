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
  in coordinate order along the row axis (dim -2) or a given dim; a
  stack of members' blocks (R, bh, bw) gives the members' strips (R, .,
  bw), and the grid ozaki route gathers its int8 slice stacks (S, bh, R,
  bw) along their rows (dim 1) and columns (dim -1);
* :func:`gather_world` and :func:`rank_sum` — every rank's partial sums on
  every rank of the grid (an ensemble mesh: of its ens slot), added in
  rank order; :func:`gather_row` the same over the row strip;
* :func:`gather_ens` — the all-gather over the ens axis of an
  :class:`~.mesh.EnsembleMesh` (the ranks at the same grid coordinates),
  concatenated along dim 0 in ``e`` order;
* :func:`transpose_to_rows` / :func:`transpose_to_cols` — the pencil
  layout's transpose between column and row blocks, one
  ``all_to_all_single`` over the grid;
* :func:`world_max` — an all-reduce MAX (order-free: every rank gets the
  same bits).

``all_reduce`` leaves the order of a sum to the backend; here each rank
adds the same numbers in the same order, so every rank holds the same
bits.  The stop predicate rests on that: a rank whose E2 differed by one
ulp could stop alone and leave the others waiting in the next collective.

Each is called on every step by every rank, whether or not the run has
stopped (the stepper freezes the state with ``torch.where``), so all ranks
issue the same sequence.  On a staged mesh (gloo with the blocks on a
card) each operand is copied to pinned host memory (the host waits for
the card there) and each result back without a host wait.

:data:`traffic` counts each kind's calls and bytes on this rank (the
result's bytes, as the JAX package's HLO audit counts a collective's
result shape, and the part of them received from other ranks), under
the names of the XLA collectives the JAX program has in their place: the
strip and ens gathers are ``'all-gather'``, the transposes
``'all-to-all'``, the halo ``'collective-permute'``, and
:func:`gather_world` and :func:`gather_row` (the partial sums an
all-reduce carries there, added in rank order here) and
:func:`world_max` ``'all-reduce'``.
``parallel/audit.py`` reads it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# tags of the four halo messages (gloo matches on them; NCCL ignores them)
_TAG_UP, _TAG_DOWN, _TAG_LEFT, _TAG_RIGHT = 1, 2, 3, 4

OPS = ('all-gather', 'all-to-all', 'all-reduce', 'collective-permute')
# op -> [calls, result bytes, the largest call's result bytes, bytes
# received from other ranks] on this rank since the last reset_traffic()
traffic = {op: [0, 0, 0, 0] for op in OPS}


def reset_traffic() -> None:
    for v in traffic.values():
        v[:] = [0, 0, 0, 0]


def _count(op: str, t: torch.Tensor, share: float = 1.0) -> None:
    """One call of ``op`` with result ``t``, ``share`` of it received
    from the other ranks."""
    nbytes = t.numel() * t.element_size()
    v = traffic[op]
    v[0] += 1
    v[1] += nbytes
    v[2] = max(v[2], nbytes)
    v[3] += int(nbytes * share)


def _wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend reads it: on a staged mesh a copy in pinned
    host memory (the host waits for it: gloo sends host bytes)."""
    t = t.contiguous()
    if not mesh.staged:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _buffer(mesh, like: torch.Tensor, shape=None) -> torch.Tensor:
    """A result buffer of the backend beside ``like`` (pinned host memory
    on a staged mesh)."""
    return torch.empty(like.shape if shape is None else shape,
                       dtype=like.dtype, device=like.device,
                       pin_memory=mesh.staged)


def _home(mesh, t: torch.Tensor) -> torch.Tensor:
    """A result back on the card: from pinned memory the copy is queued
    on the current stream ahead of the kernels that read it, and the host
    does not wait for it."""
    return t.to(mesh.device, non_blocking=True) if mesh.staged else t


def _gather(mesh, t: torch.Tensor, group, n: int,
            op: str = 'all-gather') -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along dim 0."""
    if n == 1:
        return t.contiguous()
    src = _wire(mesh, t)
    out = _buffer(mesh, src, (n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _count(op, out, (n - 1) / n)
    return _home(mesh, out)


def _gather_along(mesh, t: torch.Tensor, group, n: int,
                  dim: int = -2) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated along ``dim`` (gathered along
    dim 0, then one copy into place when ``dim`` is not 0): dim -2 of a
    2-D block or of a member stack (R, a, b) -> (R, n*a, b) gives each
    member's rows; an int8 slice stack in the products' layout (S, a, R,
    b) takes its rows with ``dim=1`` and its columns with ``dim=-1``."""
    d = dim % t.dim()
    out = _gather(mesh, t, group, n)                 # (n*t0, ...)
    if d == 0 or n == 1:
        return out
    shape = list(t.shape)
    shape[d] *= n
    return out.reshape((n,) + tuple(t.shape)).movedim(0, d).reshape(shape)


def gather_x(mesh, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """All-gather over the ``mx`` ranks of this rank's column strip,
    concatenated along ``dim``."""
    return _gather_along(mesh, t, mesh.x_group, mesh.shape[0], dim)


def gather_y(mesh, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """All-gather over the ``my`` ranks of this rank's row strip,
    concatenated along ``dim``."""
    return _gather_along(mesh, t, mesh.y_group, mesh.shape[1], dim)


def _stack(mesh, t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): the ``n`` ranks' ``t`` of ``group``, in order."""
    out = _gather(mesh, t.reshape((1,) + tuple(t.shape)), group, n,
                  'all-reduce')
    return out.reshape((n,) + tuple(t.shape))


def gather_world(mesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every grid rank's ``t``, in rank order."""
    return _stack(mesh, t, mesh.group, mesh.size)


def gather_row(mesh, t: torch.Tensor) -> torch.Tensor:
    """(my, *t.shape): the ``t`` of the ``my`` ranks of this rank's row
    strip (``y_group``), in coordinate order; on a pencil's field view
    (1, D), every rank's."""
    return _stack(mesh, t, mesh.y_group, mesh.shape[1])


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
    # the edges sent in one staged copy (one host wait a call), each
    # received into a buffer of its own
    sent = _wire(mesh, torch.cat([edge.reshape(-1) for _, _, edge, _, _
                                  in links]))
    ops, recvs, at = [], [], 0
    for side, peer, edge, tag_out, tag_in in links:
        send = sent[at:at + edge.numel()].view(edge.shape)
        at += edge.numel()
        recv = _buffer(mesh, send)
        ops.append(dist.P2POp(dist.isend, send, peer, tag=tag_out))
        ops.append(dist.P2POp(dist.irecv, recv, peer, tag=tag_in))
        recvs.append((side, recv))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for side, recv in recvs:
        _count('collective-permute', recv)
        out[side] = _home(mesh, recv)
    return out['up'], out['dn'], out['lf'], out['rt']


# ----------------------------------------------------------------------
# the pencil layout's transposes (the resharding the JAX package's
# ``constrain`` / ``constrain_mid`` asks GSPMD for, chsimpy_tpu/ops/
# dct.py:659-697, ops/ozaki.py:326-341)
# ----------------------------------------------------------------------

def _all_to_all(mesh, send: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` of ``send`` (D equal chunks along dim 0, chunk
    q to the grid's rank q) over the grid; chunk p of the result came
    from rank p."""
    src = _wire(mesh, send)
    out = _buffer(mesh, src)
    dist.all_to_all_single(out, src, group=mesh.group)
    _count('all-to-all', out, (mesh.size - 1) / mesh.size)
    return _home(mesh, out)


def transpose_to_rows(mesh, t: torch.Tensor, row_dim: int = -2
                      ) -> torch.Tensor:
    """A column block -> the row block of the same array: ``t`` holds
    every row (dim ``row_dim``, length N) of this rank's columns (the last
    dim, c = N/D); the result holds this rank's rows N/D of every column
    (D*c), contiguous, the other dims as they were.  A 2-D pencil (N, c),
    a member stack (R, N, c) or an int8 slice stack in the products'
    layout (S, N, R, c) (``row_dim=1``).  The D row bands go to the
    front for the call (one copy) and the D column blocks received are
    put side by side (one copy)."""
    D = mesh.size
    if D == 1:
        return t.contiguous()
    a = row_dim % t.dim()
    N = t.shape[a]
    if N % D:
        raise ValueError(f"{N} rows do not split over {D} ranks")
    x = t.movedim(a, 0)
    rest = tuple(x.shape[1:-1])
    send = x.reshape((D, N // D) + rest + (x.shape[-1],))
    out = _all_to_all(mesh, send)             # (D, b, *rest, c)
    # out dims: 0 = D (source rank = column block), 1 = b, 2.. = rest,
    # last = c; back to t's order with (D, c) merged as the last dim
    others = iter(range(2, 2 + len(rest)))
    order = []
    for d in range(t.dim()):
        if d == a:
            order.append(1)
        elif d == t.dim() - 1:
            order += [0, out.dim() - 1]
        else:
            order.append(next(others))
    shape = list(t.shape)
    shape[a] = N // D
    shape[-1] = D * t.shape[-1]
    return out.permute(order).reshape(shape)


def transpose_to_cols(mesh, t: torch.Tensor, row_dim: int = -2
                      ) -> torch.Tensor:
    """The inverse of :func:`transpose_to_rows`: a row block (rows N/D
    on dim ``row_dim``, every column N on the last dim) -> every row of
    this rank's columns N/D, contiguous."""
    D = mesh.size
    a = row_dim % t.dim()
    N = t.shape[-1]
    if N % D:
        raise ValueError(f"{N} columns do not split over {D} ranks")
    width = N // D
    if D == 1:
        return t.contiguous()
    send = t.unflatten(-1, (D, width)).movedim(-2, 0)   # (D, ..., width)
    out = _all_to_all(mesh, send.contiguous())
    # chunk p holds rank p's rows: stack them along the row dim
    shape = list(t.shape)
    shape[a] = D * t.shape[a]
    shape[-1] = width
    return out.movedim(0, a).reshape(shape)


def world_max(mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the grid's ranks (max is
    order-free: every rank gets the same bits)."""
    if mesh.size == 1:
        return t
    x = _wire(mesh, t)
    if not mesh.staged:
        x = x.clone()           # the all-reduce writes its operand
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    _count('all-reduce', x)
    return _home(mesh, x)
