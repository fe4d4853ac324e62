"""The float64 ozaki route: 2-D DCTs from exact int8 products.

Port of ``chsimpy_tpu/ops/ozaki.py`` (single device).  A float64 operand is
cut into int8 slices at a shared power-of-two scale,

    x = sx * sum_i X_i 2^{-7(i+1)},  X_i int8, |X_i| <= 64,

the DCT matrix likewise (once, on its device), and each slice pair is one
exact int8 x int8 -> int32 matrix product.  Products are summed into int32
groups by i + j, the groups of the first 1-D pass are carry-renormalized
back into int8 slices (shifts and masks, exact), and one float64 Horner
pass per 2-D transform puts the result together.

* Slicing is kernel K5 (``ops/kernels.py`` ``slice_field``: CUDA on the
  card, the plain version on the CPU); K5_members (``slice_field_members``)
  for an ensemble's (R, N, N) stack of members.
* Every transform takes one (N, N) field or an (R, N, N) stack of
  members (the JAX ensemble ``vmap``s the same functions): member r gets
  the single transform's bits on its field, each product serving all
  members (see "one field or an ensemble's members" below).
* The int8 products go to ``torch._int_mm`` (:func:`int8_matmul`), as the
  JAX package leaves them to XLA.
* Slices, group sums, renormalized stacks and the Horner sums are integers
  or exact, so they agree with the JAX package to the bit; a transform
  differs only through the field's mean, which the two packages sum in
  different orders.

Three route pairs, chosen by the solver as in the JAX package: unfolded
(:func:`dct2_ozaki`, odd N), the level-1 fold in natural layout
(:func:`dct2_ozaki_fold`, N < 1024) and the recursive fold in the permuted
basis (:func:`dct2_ozaki_rfold`, N >= 1024; conjugate the spectral grids
with ``dct.split_permute_grid``); under a mesh, the unfolded route on the
pencil layout (:func:`dct2_ozaki_pencil`, :func:`idct2_ozaki_pencil`:
K5 sharded, the int8 stacks transposed between the stages) where the
rank count divides N, else on the grid layout (:func:`dct2_ozaki_grid`,
:func:`idct2_ozaki_grid`: K5 sharded, strip gathers between the
stages).  The pair
cutoffs (s1, s2) and the int32 bounds are the JAX package's; see the
notes there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import collectives as coll
from . import kernels as K
from .dct import _dct_matrix_np

N_SLICES = K.MAX_SLICES  # 7 payload bits per slice -> 56 bits
MAX_PAIR = 7        # keep slice products with i+j <= MAX_PAIR (36 passes)
STAGE1_PAIR = 5     # contract-validated cutoffs (5, 7): 21 + 36 passes
STAGE2_PAIR = 7
RENORM_SHIFT = 14   # two slice slots of headroom for the growth of a 1-D
                    # transform, |C @ U| <= sqrt(N) max|U|

slice_field = K.slice_field
slice_field_members = K.slice_field_members


# ----------------------------------------------------------------------
# slicing of the constant matrices: C (and its fold blocks) computed on
# the host in float64 as the JAX package computes it, sliced on the
# device the route runs on.  Every slicing operation is exact (a
# power-of-two scaling, a rounding half to even, the remainder), so the
# slices are the JAX package's numpy slices, on any device.
# ----------------------------------------------------------------------

def _slice_scale(amax: float) -> float:
    """The power of two with amax / scale < 1/4."""
    e = int(np.ceil(np.log2(amax))) + 2 if amax > 0 else 0
    return float(2.0 ** e)


def slice_matrix(M: torch.Tensor, scale: float,
                 n_slices: int = N_SLICES) -> torch.Tensor:
    """Exact fixed-point slicing of a constant float64 matrix, as an
    (n_slices, ...) int8 stack: M = scale * sum_k S[k] 2^{-7(k+1)} (+ a
    tail below 2^{-7 n_slices} scale), with |M|/scale < 1/4 (matrices
    whose int32 product groups are added share ``scale``)."""
    u = M / scale
    out = torch.empty((n_slices,) + tuple(M.shape), dtype=torch.int8,
                      device=M.device)
    for k in range(n_slices):
        u = u * 128.0
        s = torch.round(u)
        u = u - s
        out[k] = s.to(torch.int8)
    return out


def _with_transpose(S: torch.Tensor) -> tuple:
    return S, S.transpose(1, 2).contiguous()


def _on(M: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(M), device=device)


def dct_slices(N: int, device='cpu'):
    """int8 slice stacks [S, N, N] of C and C^T, and their scale."""
    return (*_with_transpose(slice_matrix(_on(_dct_matrix_np(N), device),
                                          dct_scale(N))), dct_scale(N))


@functools.lru_cache(maxsize=32)
def dct_scale(N: int) -> float:
    return _slice_scale(float(np.max(np.abs(_dct_matrix_np(N)))))


def _fold_blocks_np(N: int) -> tuple:
    """Level-1 folded blocks Ce = C[0::2, :N/2], Co = C[1::2, :N/2]."""
    C = _dct_matrix_np(N)
    h = N // 2
    return C[0::2, :h], C[1::2, :h]


def dct_fold_slices(N: int, device='cpu') -> dict:
    """int8 stacks [S, N/2, N/2] of Ce, Co, Ce^T, Co^T, sliced at ONE
    shared scale (the inverse adds int32 groups across the even and odd
    branches), and the scale."""
    sc = dct_fold_scale(N)
    Ce, Co = (slice_matrix(_on(b, device), sc) for b in _fold_blocks_np(N))
    return {'CeS': Ce, 'CoS': Co, 'CeTS': Ce.transpose(1, 2).contiguous(),
            'CoTS': Co.transpose(1, 2).contiguous(), 'scale': sc}


@functools.lru_cache(maxsize=32)
def dct_fold_scale(N: int) -> float:
    return _slice_scale(max(float(np.max(np.abs(b)))
                            for b in _fold_blocks_np(N)))


@functools.lru_cache(maxsize=16)
def _rfold_blocks_np(N: int, levels: int):
    """Blocks of the recursive fold in branch order [E-leaf, O_levels, ...,
    O_1], and one shared slice scale."""
    C = _dct_matrix_np(N)

    def rec(M, lv):
        n = M.shape[1]
        if lv == 0 or n % 2:
            return [np.ascontiguousarray(M)]
        return rec(M[0::2, :n // 2], lv - 1) + [
            np.ascontiguousarray(M[1::2, :n // 2])]

    blocks = rec(C, levels)
    return blocks, _slice_scale(max(float(np.max(np.abs(b)))
                                    for b in blocks))


def dct_rfold_slices(N: int, levels: int, device='cpu'):
    """((block, block^T) int8 stacks in branch order, shared scale)."""
    blocks, sc = _rfold_blocks_np(N, levels)
    return (tuple(_with_transpose(slice_matrix(_on(b, device), sc))
                  for b in blocks), sc)


def dct_rfold_scale(N: int, levels: int) -> float:
    return _rfold_blocks_np(N, levels)[1]


# ----------------------------------------------------------------------
# int8 products, group sums, renormalization, recombination
# ----------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for int8 matrices, the exact int32 product
    (``torch._int_mm``).  On the card cuBLASLt takes inner and column
    counts that are multiples of 8, and refuses some row counts that are
    not multiples of 32 (16, 24, 40, 48 and 136 rows with 64 inner and 64
    columns; ``tests/test_torch_cuda.py``): other shapes are zero-padded,
    rows to a multiple of 32, which changes no sum.  A left operand of
    fewer than 32 rows (a (1, 4) pencil world's (16, 64) row block at
    N=64) is multiplied in float64 instead, exact: every partial sum is
    an integer below 2^53."""
    a, b = a.contiguous(), b.contiguous()
    if a.device.type != 'cuda':
        return torch._int_mm(a, b)
    M, Kd = a.shape
    N = b.shape[1]
    if M < 32:
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)
    Mp, Kp, Np = _round_up(M, 32), _round_up(Kd, 8), _round_up(N, 8)
    if (Mp, Kp, Np) == (M, Kd, N):
        return torch._int_mm(a, b)
    ap = torch.zeros((Mp, Kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((Kp, Np), dtype=torch.int8, device=b.device)
    ap[:M, :Kd] = a
    bp[:Kd, :N] = b
    return torch._int_mm(ap, bp)[:M, :N]


def _left(M, X):
    """M @ X[:, r, :] for every member r: M (m, rows), X (rows, R, cols)
    -> (m, R, cols), ONE product with the members side by side as
    columns."""
    rows, R, cols = X.shape
    return int8_matmul(M, X.reshape(rows, R * cols)).reshape(-1, R, cols)


def _right(X, M):
    """X[:, r, :] @ M for every member r: X (rows, R, cols), M (cols, m)
    -> (rows, R, m), ONE product with the members' rows stacked."""
    rows, R, cols = X.shape
    return int8_matmul(X.reshape(rows * R, cols), M).reshape(rows, R, -1)


def _pair_groups(a_slices, b_slices, max_pair=MAX_PAIR, dot=None):
    """All slice products dot(a_i, b_j) with i+j <= max_pair, summed into
    int32 groups by k = i+j (``dot``: :func:`int8_matmul` by default, or
    the transforms' :func:`_left` / :func:`_right`; the JAX package's
    ``_dot_left``/``_dot_right``), None where no pair adds to k.  Group
    sums stay < 2^31: each product is <= 65*65*N and <= 8 join a group
    (N <= 2^19); stacking members changes neither bound.

    Each group is one product: its a_i side by side along their
    contracted last axis (one copy), its b_j, j ascending, a range of the
    stack along their contracted first axis (a view), so the products'
    sum runs inside the product.  The sum is exact in int32, so it has
    the bits of the pairs' products added one by one, with a launch a
    group in place of two a pair."""
    dot = dot or int8_matmul
    Sa, Sb = a_slices.shape[0], b_slices.shape[0]
    groups = []
    for k in range(max_pair + 1):
        j0, j1 = max(0, k - Sa + 1), min(k, Sb - 1)
        if j0 > j1:
            groups.append(None)
            continue
        if j0 == j1:
            groups.append(dot(a_slices[k - j0], b_slices[j0]))
            continue
        n = j1 - j0 + 1
        a = torch.stack([a_slices[k - j] for j in range(j0, j1 + 1)],
                        dim=-2)
        a = a.reshape(*a.shape[:-2], n * a.shape[-1])
        b = b_slices[j0:j1 + 1]
        groups.append(dot(a, b.reshape(n * b.shape[1], *b.shape[2:])))
    return groups


def _renorm_to_slices(groups, n_slices: int = N_SLICES,
                      shift: int = RENORM_SHIFT):
    """Carry-renormalize int32 groups into int8 slices, exactly.

    V = Σ_k groups[k] 2^{-7(k+2)} becomes V 2^{-shift} = Σ_j r_j 2^{-7(j+1)}
    with |r_j| <= 64 (centered mod), group k landing at slot k + shift/7 + 1;
    slots past n_slices - 1 are dropped.  Shifts and masks on int32 (``>>``
    is arithmetic on a signed type)."""
    assert shift % 7 == 0, "shift must be a whole number of slice slots"
    q = shift // 7
    n_groups = len(groups)
    low_slot = n_groups + q         # least significant occupied slot
    acc = torch.zeros_like(groups[0])
    slices = {}
    for j in range(low_slot, -1, -1):
        k = j - q - 1
        if 0 <= k < n_groups:
            acc = acc + groups[k]
        r = ((acc + 64) & 127) - 64
        slices[j] = r
        acc = (acc - r) >> 7
    zero = torch.zeros_like(groups[0], dtype=torch.int8)
    return torch.stack([slices[j].to(torch.int8) if j in slices else zero
                        for j in range(n_slices)])


def _horner_f64(groups, dtype=torch.float64):
    """Σ_k groups[k] 2^{-7(k+2)} in float64 (one Horner pass)."""
    acc = groups[-1].to(dtype)
    for k in range(len(groups) - 2, -1, -1):
        acc = acc * 2.0 ** -7 + groups[k].to(dtype)
    return acc * 2.0 ** -14


def _n_slots(s2=STAGE2_PAIR):
    q = RENORM_SHIFT // 7
    return min(N_SLICES + q, s2 + 1)


def _n_field(s1=STAGE1_PAIR):
    return min(N_SLICES, s1 + 1)


# ----------------------------------------------------------------------
# one field (rows, cols) or an ensemble's members (R, rows, cols)
#
# Every transform takes either.  Field arithmetic (mean, folds, DC) runs
# in the field's own layout; the int8/int32 side runs in the products'
# layout (rows, R, cols) (R = 1 for one field, a free view), where one
# product serves all members: a left product takes the members side by
# side as columns, a right product their rows stacked.  The int32 sums
# are exact, so member r gets the single transform's bits on its field,
# with its own slice scale (K5_members), as the JAX ensemble's vmap does.
# ----------------------------------------------------------------------

# PyTorch's CUDA caching allocator hands out blocks at multiples of 512
# bytes (c10/cuda/CUDACachingAllocator.cpp, kMinBlockSize): a single
# transform's field always starts on such a boundary
_ALLOC_ALIGN = 512


def _mean(U):
    """The field's mean (0-d), or each member's ((R,)), each taken as the
    single transform takes it: ``torch.mean`` of one field that starts
    where a new allocation would.  A reduction over the member stack may
    add in another order, and the card's reduction picks its vector width
    (and so its order) from the pointer's alignment, so a member that
    starts off _ALLOC_ALIGN (odd N) is copied first.  One reduction a
    member: R reductions a forward transform instead of one."""
    if U.dim() == 2:
        return torch.mean(U)
    means = []
    for u in U:
        if u.data_ptr() % _ALLOC_ALIGN:
            u = u.clone()
        means.append(torch.mean(u))
    return torch.stack(means)


def _bcast(v):
    """A 0-d or (R,) value shaped to broadcast over the field(s)."""
    return v.reshape(v.shape + (1, 1))


def _mid(v):
    """A 0-d or (R,) value shaped to broadcast over (rows, R, cols)."""
    return v.reshape(1, -1, 1)


def _slice(x, n_slices):
    """K5 on a field, or K5_members on each member of a stack: (planes in
    the products' layout (S, rows, R, cols), scale 0-d or (R,))."""
    if x.dim() == 2:
        s, sc = slice_field(x, n_slices)
        return s.unsqueeze(2), sc
    s, sc = slice_field_members(x, n_slices)
    return s.transpose(1, 2).contiguous(), sc


def _field(Y, like):
    """(rows, R, cols) back to ``like``'s layout: (rows, cols) for a
    field, (R, rows, cols) for members."""
    if like.dim() == 2:
        return Y.squeeze(1)
    return Y.transpose(0, 1).contiguous()


def _dc_add(Y, v):
    """Y with v added at [0, 0] of each field (Y is the transform's own
    output)."""
    Y[..., 0, 0] += v
    return Y


def _dc_zero(X):
    """A copy of X with [0, 0] of each field zeroed."""
    X = X.clone()
    X[..., 0, 0].zero_()        # no host scalar: a CUDA graph captures it
    return X


# ----------------------------------------------------------------------
# unfolded route (odd N)
# ----------------------------------------------------------------------

def _transform2d(U, Ms_row, Ms_col, m_scale, s1=STAGE1_PAIR,
                 s2=STAGE2_PAIR):
    """M_row @ U @ M_col with both passes in int8/int32; Ms_row, Ms_col are
    [S, N, N] slice stacks at scale m_scale.  The pair cutoffs bound which
    slices any product reads, so only those are emitted."""
    Us, su = _slice(U, _n_field(s1))
    g1 = _pair_groups(Ms_row, Us, max_pair=s1, dot=_left)
    t = _renorm_to_slices(g1, n_slices=_n_slots(s2))
    g2 = _pair_groups(t, Ms_col, max_pair=s2, dot=_right)
    z = _horner_f64(g2, U.dtype)
    # scale: (m_scale * su * 2^RENORM_SHIFT) from pass 1, times m_scale
    return _field(z * _mid(su * (m_scale * m_scale * 2.0 ** RENORM_SHIFT)),
                  U)


def dct2_ozaki(U, Cs, CsT, m_scale, s1=STAGE1_PAIR, s2=STAGE2_PAIR):
    """Orthonormal 2-D DCT-II (C @ U @ C^T).  The mean goes around the int8
    path analytically (dct2(ones) = N e00), which shrinks the slice scale
    to the fluctuation's."""
    N = U.shape[-1]
    m = _mean(U)
    Y = _transform2d(U - _bcast(m), Cs, CsT, m_scale, s1=s1, s2=s2)
    return _dc_add(Y, m * N)


def idct2_ozaki(X, Cs, CsT, m_scale):
    """Orthonormal 2-D DCT-III (C^T @ X @ C), inverse of :func:`dct2_ozaki`;
    the DC coefficient goes around (idct2(e00) = ones/N)."""
    N = X.shape[-1]
    d = X[..., 0, 0]
    u = _transform2d(_dc_zero(X), CsT, Cs, m_scale)
    return u + _bcast(d / N)


# ----------------------------------------------------------------------
# the pencil layout (chsimpy_tpu/core/stepper.py:690-705, ops/ozaki.py:
# 385-500): the unfolded route on a rank's column block (N, N/D) of the
# field and row block (N/D, N) of the spectral image.  The slices take the
# whole field's scale (K5 sharded), each int8 product contracts a local
# axis, and the renormalized int8 stack crosses ranks in one transpose
# each way.  The int32 sums are exact under any partitioning and the mean
# is summed column by column (:func:`_world_mean_amax`), so a rank's result is
# the one-rank pencil transform's block, to the bit.  The mean's order is
# not torch.mean's: the result differs from :func:`dct2_ozaki` by that.
# ----------------------------------------------------------------------

def _world_mean_amax(mesh, Ub, N):
    """The whole field's mean and max|U - mean| (each 0-d, or (R,) for
    members) from whole columns ``Ub`` (..., N, c), in one gather over
    the mesh's row strip (:func:`~..parallel.collectives.gather_row`),
    whose ranks hold the field's column blocks in order: on the pencil's
    field view (1, D) every rank its own, on the grid (after the column
    strip's gather) ranks (i, 0..my-1) the my column strips.  Each column's
    sum over its N rows (a reduction along a contiguous row of the
    transposed block, so its bits do not depend on c), the block's max
    and min.  The N column sums are summed in column order, so every
    rank gets the same mean for any number of ranks, on the pencil layout
    and the grid alike.  x -> fl(x - mean) is monotone, so max|fl(U -
    mean)| is taken at U's max or min: the bits of
    ``torch.amax(torch.abs(U - mean))`` over the whole field."""
    lead = Ub.shape[:-2]
    c = Ub.shape[-1]
    part = torch.cat([Ub.transpose(-1, -2).contiguous().sum(-1),
                      Ub.amax(dim=(-2, -1)).unsqueeze(-1),
                      Ub.amin(dim=(-2, -1)).unsqueeze(-1)], dim=-1)
    g = coll.gather_row(mesh, part)                        # (my, ..., c + 2)
    m = g[..., :c].movedim(0, -2).reshape(lead + (N,)).sum(-1) / float(N * N)
    hi = g[..., c].amax(dim=0) - m
    lo = g[..., c + 1].amin(dim=0) - m
    return m, torch.maximum(hi.abs(), lo.abs())


def _slice_sharded(x, n_slices, mesh, also_max=None, amax=None):
    """K5 sharded on a block or on each member's block: (planes in the
    products' layout (S, rows, R, cols), the whole field's scale[, the
    world max of ``also_max``, taken in K5's own all-reduce]); ``amax``:
    the whole field's max|x|, known already."""
    f = K.slice_field_sharded if x.dim() == 2 else \
        K.slice_field_members_sharded
    s, sc, *also = f(x, mesh, n_slices, also_max=also_max, amax=amax)
    s = s.unsqueeze(2) if x.dim() == 2 else s.transpose(1, 2).contiguous()
    return (s, sc, *also)


def _holds_row0(mesh) -> bool:
    return mesh.rank == mesh.base


def dct2_ozaki_pencil(Ub, Cs, CsT, m_scale, mesh, s1=STAGE1_PAIR,
                      s2=STAGE2_PAIR):
    """:func:`dct2_ozaki` of the field whose column block is ``Ub`` (N,
    N/D) (or each member's, (R, N, N/D)) on the grid ``mesh``: this
    rank's row block of the spectral image.  The whole field's mean goes
    around the int8 path; the rank that holds row 0 adds it at [0, 0].
    The mean and the slices' scale come from one gather."""
    N = Ub.shape[-2]
    m, amax = _world_mean_amax(mesh.field_view, Ub, N)
    Us, su = _slice_sharded(Ub - _bcast(m), _n_field(s1), mesh, amax=amax)
    g1 = _pair_groups(Cs, Us, max_pair=s1, dot=_left)         # (N, R, c)
    t = _renorm_to_slices(g1, n_slices=_n_slots(s2))
    t = coll.transpose_to_rows(mesh, t, row_dim=1)            # (S, b, R, N)
    g2 = _pair_groups(t, CsT, max_pair=s2, dot=_right)        # (b, R, N)
    z = _horner_f64(g2, Ub.dtype)
    Y = _field(z * _mid(su * (m_scale * m_scale * 2.0 ** RENORM_SHIFT)),
               Ub)
    if _holds_row0(mesh):
        Y = _dc_add(Y, m * N)
    return Y


def idct2_ozaki_pencil(Xb, Cs, CsT, m_scale, mesh):
    """:func:`idct2_ozaki` of the spectral image whose row block is
    ``Xb`` (N/D, N) (or each member's): this rank's column block of the
    field.  The column stage runs first (``right_first``): it contracts
    the local axis of a row block.  [0, 0] (the DC) goes around: the rank
    that holds row 0 sends it in the slices' world max (every other rank
    puts -inf there), which costs no collective of its own."""
    N = Xb.shape[-1]
    # [0, 0] reaches every rank in K5's all-reduce MAX: -inf elsewhere
    if _holds_row0(mesh):
        d = Xb[..., 0, 0].clone()
        Xb = _dc_zero(Xb)
    else:
        d = torch.full(Xb.shape[:-2], -torch.inf, dtype=Xb.dtype,
                       device=Xb.device)
    Xs, sx, d = _slice_sharded(Xb, _n_field(), mesh, d)        # (S, b, R, N)
    g1 = _pair_groups(Xs, Cs, max_pair=STAGE1_PAIR, dot=_right)
    t = _renorm_to_slices(g1, n_slices=_n_slots())
    t = coll.transpose_to_cols(mesh, t, row_dim=1)             # (S, N, R, c)
    g2 = _pair_groups(CsT, t, max_pair=STAGE2_PAIR, dot=_left)
    z = _horner_f64(g2, Xb.dtype)
    u = _field(z * _mid(sx * (m_scale * m_scale * 2.0 ** RENORM_SHIFT)),
               Xb)
    return u + _bcast(d / N)


# ----------------------------------------------------------------------
# the grid layout (chsimpy_tpu/core/stepper.py:707-718, the last branch:
# dct2_ozaki / idct2_ozaki under the grid constrainer, partitioned by
# GSPMD): the unfolded route on a rank's (bn, bw) block (I, J) of the
# field and of the spectral image, where the rank count D does not divide
# N (no pencil layout).  Each stage is a strip gather and exact int8
# products with the blocks of the DCT's slice stacks the rank reads
# (``parallel/sharding.py`` ``ozaki_grid_stacks``):
#
#   forward  U[:, J] (a float64 gather over the column strip), K5 sharded
#            on it at the whole field's scale, C[I, :] @ . (T[I, J], int32
#            groups, renormalized), T[I, :] (an int8 gather over the row
#            strip), . @ C^T[:, J];
#   inverse  K5 sharded on the block at the world max, X[:, J] (an int8
#            gather over the column strip), C^T[I, :] @ ., the row strip's
#            gather, . @ C[:, J].
#
# The forward gathers the field's column strip in float64, not its int8
# slices: the mean is summed column by column over whole columns
# (:func:`_world_mean_amax`), the pencil's order, the same for any number
# of ranks, and the rank then slices the strip it holds (8 bytes an
# element cross in place of one a slice, in as many collectives).  The
# int32 sums are exact and the renormalization and Horner work element by
# element, so a rank's block is the one-device unfolded transform's block
# (:func:`dct2_ozaki`, :func:`idct2_ozaki`), to the bit, given the same
# mean; the inverse's DC rides K5's all-reduce MAX, as on the pencil.
# ----------------------------------------------------------------------

def dct2_ozaki_grid(Ub, stacks, m_scale, mesh, s1=STAGE1_PAIR,
                    s2=STAGE2_PAIR):
    """:func:`dct2_ozaki` of the field whose block on the grid ``mesh``
    is ``Ub`` (bn, bw) (or each member's, (R, bn, bw)): this rank's block
    of the spectral image.  ``stacks``: ``ozaki_grid_stacks`` of the
    DCT's slice stacks.  The whole field's mean goes around the int8
    path; the rank that holds [0, 0] adds it there."""
    Cs_I, CsT_J = stacks['fwd']
    N = Cs_I.shape[-1]
    Ucol = coll.gather_x(mesh, Ub)                            # U[:, J]
    m, amax = _world_mean_amax(mesh, Ucol, N)
    Us, su = _slice_sharded(Ucol - _bcast(m), _n_field(s1), mesh,
                            amax=amax)                        # (S, N, R, bw)
    g1 = _pair_groups(Cs_I, Us, max_pair=s1, dot=_left)       # (bn, R, bw)
    t = _renorm_to_slices(g1, n_slices=_n_slots(s2))
    t = coll.gather_y(mesh, t, dim=-1)                        # (S, bn, R, N)
    g2 = _pair_groups(t, CsT_J, max_pair=s2, dot=_right)      # (bn, R, bw)
    z = _horner_f64(g2, Ub.dtype)
    Y = _field(z * _mid(su * (m_scale * m_scale * 2.0 ** RENORM_SHIFT)),
               Ub)
    if _holds_row0(mesh):
        Y = _dc_add(Y, m * N)
    return Y


def idct2_ozaki_grid(Xb, stacks, m_scale, mesh):
    """:func:`idct2_ozaki` of the spectral image whose block on the grid
    ``mesh`` is ``Xb`` (bn, bw) (or each member's): this rank's block of
    the field, untrimmed.  [0, 0] (the DC) goes around: the rank that
    holds it sends it in the slices' world max (every other rank puts
    -inf there)."""
    CsT_I, Cs_J = stacks['inv']
    N = CsT_I.shape[-1]
    if _holds_row0(mesh):
        d = Xb[..., 0, 0].clone()
        Xb = _dc_zero(Xb)
    else:
        d = torch.full(Xb.shape[:-2], -torch.inf, dtype=Xb.dtype,
                       device=Xb.device)
    Xs, sx, d = _slice_sharded(Xb, _n_field(), mesh, d)        # (S, bn, R, bw)
    Xs = coll.gather_x(mesh, Xs, dim=1)                        # X[:, J]
    g1 = _pair_groups(CsT_I, Xs, max_pair=STAGE1_PAIR, dot=_left)
    t = _renorm_to_slices(g1, n_slices=_n_slots())
    t = coll.gather_y(mesh, t, dim=-1)                         # (S, bn, R, N)
    g2 = _pair_groups(t, Cs_J, max_pair=STAGE2_PAIR, dot=_right)
    z = _horner_f64(g2, Xb.dtype)
    u = _field(z * _mid(sx * (m_scale * m_scale * 2.0 ** RENORM_SHIFT)),
               Xb)
    return u + _bcast(d / N)


# ----------------------------------------------------------------------
# level-1 fold, natural layout (N < 1024)
# ----------------------------------------------------------------------

def _interleave(a, b, axis):
    """result[2i] = a[i], result[2i+1] = b[i] along ``axis``."""
    shape = list(a.shape)
    shape[axis] *= 2
    return torch.stack([a, b], dim=axis + 1).reshape(shape)


def dct2_ozaki_fold(U, fs, s1=STAGE1_PAIR, s2=STAGE2_PAIR):
    """Orthonormal 2-D DCT-II via folded int8 passes (half the MACs of
    :func:`dct2_ozaki`).  ``fs`` is :func:`dct_fold_slices`(N)."""
    N = U.shape[-1]
    h = N // 2
    m = _mean(U)
    X = U - _bcast(m)
    # row fold in float64
    bot = torch.flip(X[..., h:, :], (-2,))
    u = X[..., :h, :] + bot
    v = X[..., :h, :] - bot
    us, su = _slice(u, _n_field(s1))
    vs, sv = _slice(v, _n_field(s1))
    # pass 1: T_even = Ce @ u, T_odd = Co @ v
    ge = _pair_groups(fs['CeS'], us, max_pair=s1, dot=_left)
    go = _pair_groups(fs['CoS'], vs, max_pair=s1, dot=_left)

    def colfold(gs):
        p, q = [], []
        for g in gs:
            right = torch.flip(g[..., h:], (-1,))
            p.append(g[..., :h] + right)
            q.append(g[..., :h] - right)
        return p, q

    pe, qe = colfold(ge)
    po, qo = colfold(go)
    ns = _n_slots(s2)
    f = fs['scale'] * fs['scale'] * 2.0 ** RENORM_SHIFT
    # pass 2 per quarter; the row-block scales su / sv stay separable
    quarters = []
    for grp, mcol, s in ((pe, 'CeTS', su), (qe, 'CoTS', su),
                         (po, 'CeTS', sv), (qo, 'CoTS', sv)):
        t = _renorm_to_slices(grp, n_slices=ns)
        g2 = _pair_groups(t, fs[mcol], max_pair=s2, dot=_right)
        quarters.append(_horner_f64(g2, U.dtype) * _mid(s * f))
    zee, zeo, zoe, zoo = quarters
    Y = _interleave(_interleave(zee, zeo, axis=2),
                    _interleave(zoe, zoo, axis=2), axis=0)
    return _dc_add(_field(Y, U), m * N)


def idct2_ozaki_fold(X, fs):
    """Orthonormal 2-D DCT-III, inverse of :func:`dct2_ozaki_fold`.  The
    operand is sliced once, so the even/odd sub-stacks share its scale and
    the fold assemblies stay exact int32 adds."""
    N = X.shape[-1]
    d = X[..., 0, 0]
    ys, sy = _slice(_dc_zero(X), _n_field())
    # pass 1: x_top = Ce^T yE + Co^T yO, x_bot = flip(Ce^T yE - Co^T yO)
    yE = ys[:, 0::2].contiguous()
    yO = ys[:, 1::2].contiguous()
    a = _pair_groups(fs['CeTS'], yE, max_pair=STAGE1_PAIR, dot=_left)
    b = _pair_groups(fs['CoTS'], yO, max_pair=STAGE1_PAIR, dot=_left)
    wg = [torch.cat([x + y, torch.flip(x - y, (0,))], dim=0)
          for x, y in zip(a, b)]
    t = _renorm_to_slices(wg, n_slices=_n_slots())
    # pass 2: u_left = wE Ce + wO Co, u_right = flip(wE Ce - wO Co)
    wE = t[..., 0::2].contiguous()
    wO = t[..., 1::2].contiguous()
    gE = _pair_groups(wE, fs['CeS'], max_pair=STAGE2_PAIR, dot=_right)
    gO = _pair_groups(wO, fs['CoS'], max_pair=STAGE2_PAIR, dot=_right)
    gl = [x + y for x, y in zip(gE, gO)]
    gr = [x - y for x, y in zip(gE, gO)]
    f = _mid(sy * (fs['scale'] * fs['scale'] * 2.0 ** RENORM_SHIFT))
    ul = _horner_f64(gl, X.dtype) * f
    ur = torch.flip(_horner_f64(gr, X.dtype), (-1,)) * f
    return _field(torch.cat([ul, ur], dim=-1), X) + _bcast(d / N)


# ----------------------------------------------------------------------
# recursive fold in the permuted basis (N >= 1024)
# ----------------------------------------------------------------------

def _rfold_field(X, levels):
    """Row-branch inputs [u_E, v_L, ..., v_1] (float64 adds)."""
    if levels == 0:
        return [X]
    n = X.shape[-2]
    top, bot = X[..., :n // 2, :], torch.flip(X[..., n // 2:, :], (-2,))
    return _rfold_field(top + bot, levels - 1) + [top - bot]


def _rfold_groups_cols(groups, levels):
    """Column branches of int32 group planes, same order (exact adds)."""
    if levels == 0:
        return [groups]
    h = groups[0].shape[-1] // 2
    plus, minus = [], []
    for g in groups:
        bot = torch.flip(g[..., h:], (-1,))
        plus.append(g[..., :h] + bot)
        minus.append(g[..., :h] - bot)
    return _rfold_groups_cols(plus, levels - 1) + [minus]


def dct2_ozaki_rfold(U, rf, m_scale, levels, s1=STAGE1_PAIR,
                     s2=STAGE2_PAIR):
    """Orthonormal 2-D DCT-II via recursive folded int8 passes, in the
    PERMUTED block order on both axes.  ``rf`` is
    :func:`dct_rfold_slices`(N, levels)[0].  Each row branch is sliced at
    its own scale; no int32 sum ever crosses branches."""
    N = U.shape[-1]
    m = _mean(U)
    ns = _n_slots(s2)
    f = m_scale * m_scale * 2.0 ** RENORM_SHIFT
    row_blocks = []
    for b, (Bs, _BsT) in zip(_rfold_field(U - _bcast(m), levels), rf):
        us, su = _slice(b, _n_field(s1))
        g1 = _pair_groups(Bs, us, max_pair=s1, dot=_left)
        col_blocks = []
        for gc, (_Cs2, CsT2) in zip(_rfold_groups_cols(g1, levels), rf):
            t = _renorm_to_slices(gc, n_slices=ns)
            g2 = _pair_groups(t, CsT2, max_pair=s2, dot=_right)
            col_blocks.append(_horner_f64(g2, U.dtype) * _mid(su * f))
        row_blocks.append(torch.cat(col_blocks, dim=-1))
    # the permuted index of spectral (0, 0) is 0
    return _dc_add(_field(torch.cat(row_blocks, dim=0), U), m * N)


def _rfold_inv_rows(t, rf, levels, row0=0, size=None, s1=STAGE1_PAIR):
    """Pass 1 of the inverse: int32 groups of C^T X from the sliced
    permuted operand ``t`` ([S, N, R, N]); assembles [a + b; flip(a - b)]."""
    if size is None:
        size = t.shape[1]
    h = size // 2
    if levels == 0:
        _Bs, BsT = rf[0]
        sub = t[:, row0:row0 + size]
        return _pair_groups(BsT, sub, max_pair=s1, dot=_left)
    o_idx = levels  # rf index of this level's odd block: [E, O_L, .., O_1]
    a = _rfold_inv_rows(t, rf[:o_idx], levels - 1, row0, h, s1=s1)
    _Bs, BoT = rf[o_idx]
    sub = t[:, row0 + h:row0 + size]
    b = _pair_groups(BoT, sub, max_pair=s1, dot=_left)
    return [torch.cat([x + y, torch.flip(x - y, (0,))], dim=0)
            for x, y in zip(a, b)]


def _rfold_inv_cols(t, rf, levels, col0=0, size=None, s2=STAGE2_PAIR):
    """Pass 2 of the inverse along columns (same recursion, last axis).
    The column sub-stacks are made contiguous once for the products."""
    if size is None:
        size = t.shape[-1]
    h = size // 2
    if levels == 0:
        Bs, _BsT = rf[0]
        sub = t[..., col0:col0 + size].contiguous()
        return _pair_groups(sub, Bs, max_pair=s2, dot=_right)
    o_idx = levels
    a = _rfold_inv_cols(t, rf[:o_idx], levels - 1, col0, h, s2=s2)
    Bo, _BoT = rf[o_idx]
    sub = t[..., col0 + h:col0 + size].contiguous()
    b = _pair_groups(sub, Bo, max_pair=s2, dot=_right)
    return [torch.cat([x + y, torch.flip(x - y, (-1,))], dim=-1)
            for x, y in zip(a, b)]


def idct2_ozaki_rfold(X, rf, m_scale, levels, s1=STAGE1_PAIR,
                      s2=STAGE2_PAIR):
    """Orthonormal 2-D DCT-III from the permuted basis, inverse of
    :func:`dct2_ozaki_rfold`: one slicing, one renormalization, contiguous
    block reads.  (s1, s2) trim the pair cutoffs as the forward's do."""
    N = X.shape[-1]
    d = X[..., 0, 0]
    ys, sy = _slice(_dc_zero(X), _n_field(s1))
    g1 = _rfold_inv_rows(ys, rf, levels, s1=s1)
    t = _renorm_to_slices(g1, n_slices=_n_slots(s2))
    g2 = _rfold_inv_cols(t, rf, levels, s2=s2)
    u = _horner_f64(g2, X.dtype) * _mid(
        sy * (m_scale * m_scale * 2.0 ** RENORM_SHIFT))
    return _field(u, X) + _bcast(d / N)
