"""2-D DCT-II / DCT-III: the matmul, split and FFT routes.

Port of ``chsimpy_tpu/ops/dct.py`` for one device, of the matmul route
on a grid mesh (:func:`dct2_grid`, :func:`idct2_grid`), and of the pencil
forms (:func:`dct2_split_perm_pencil`, :func:`idct2_split_perm_pencil`,
:func:`dct2_pencil`, :func:`idct2_pencil`).

* **matmul** — the orthonormal DCT-II along an axis is a product with the
  (N, N) cosine matrix C, so

      dct2(U)  = C @ U @ C^T          idct2(X) = C^T @ X @ C

* **split** — decimation in frequency on the cosine matrix: even rows of C
  are symmetric in n, odd rows antisymmetric, so folding the input
  (u = top + reverse(bottom), v = top - reverse(bottom)) gives the even
  outputs as a half-size DCT-II of u (which folds again) and the odd ones
  as one (N/2, N/2) product with v.  ``levels`` folds do 1/2, 3/8, 11/32,
  ... of the matmul's FLOPs.  The block tree (:func:`split_tree`) holds
  exact sub-matrices of the float64 C.  Three layouts: natural
  (:func:`dct2_split`, the interleave restores the coefficient order),
  permuted (:func:`dct2_split_perm`, outputs in the recursive block order
  [E-leaf, O_levels, ..., O_1]: the solver conjugates its spectral grids
  once with :func:`split_permute_grid`), and permuted on a level-1 folded
  field (:func:`dct2_split_perm_folded`, the field kept in the layout of
  :func:`fold1`).
* **fft** — Makhoul (1980): one N-point real FFT per 1-D transform on
  ``torch.fft``, even N only.  complex64 for float32, complex128 for
  float64.

The JAX package leaves these products and FFTs to XLA outside any Pallas
kernel; here they go to :func:`mm` (cuBLAS or the GEMM kernel K6) and
``torch.fft``.  Transposes are views: ``_mm_nt`` is ``x @ m.T`` with no
copy.  ``x[n//2:][::-1]`` has no
torch view, so every reversal is a ``torch.flip`` (a copy).  The 2-D
transforms return contiguous tensors: the kernels take nothing else.

The solver runs the permuted forms (on a level-1 folded field under
``fold_field``: :func:`dct2_split_perm_folded`,
:func:`idct2_split_perm_folded`, :func:`fold1`) and the FFT route.  These
and the matmul route's :func:`dct2` / :func:`idct2` also take a stack of
fields (R, N, N), each transformed over its last two axes: the ensemble's
step (the (N, N) matrices are shared by every member).  The natural-layout
pair is reached only from the bake-off (``benchmarks/dct_bench.py``).

Not ported: the Hou odd-branch recursion (measured and rejected, ROADMAP.md
queue A item 2).

**Precision.**  Every float32 product takes one of the JAX package's
precision names (its bf16 pass counts on the TPU's matrix unit), mapped by
pass count to what Hopper computes, each at least as accurate as its TPU
counterpart (:func:`mm`):

* ``'highest'`` (6-pass bf16): full float32, cuBLAS with TF32 off
  (:func:`require_full_fp32` keeps the global switch off);
* ``'high'`` (3-pass bf16): 3xTF32 on the tensor cores, kernel K6
  (``ops/kernels.py`` ``matmul``, ``csrc/gemm_sm90.cu``);
* ``'default'`` (1-pass bf16): one TF32 pass (10 mantissa bits against
  bf16's 8), cuBLAS with TF32 on for that call only
  (``kernels.matmul_tf32``).

float64 products are float64 whatever the name, as on the JAX CPU
backend.  On the CPU every name but ``'default'`` is the float32 product;
``'default'`` rounds the operands to TF32 first.  The spectral images
``--inv-band`` bands (:func:`idct2_banded`, ``band_frac``) contract their
high-frequency tail at ``'default'``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..parallel import collectives as coll
from ..parallel.sharding import block_slices
from . import kernels as K

# the JAX package's matmul precision names (chsimpy_tpu/core/stepper.py
# StepConfig.matmul_precision), most accurate first
PRECISIONS = ('highest', 'high', 'default')
# the precision of a banded inverse's tail (idct2_banded, band_frac)
BAND_PRECISION = 'default'


@functools.lru_cache(maxsize=32)
def _dct_matrix_np(N: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, computed in float64:
    C[k, n] = s_k * cos(pi * (2n + 1) * k / (2N)),
    s_0 = sqrt(1/N), s_k = sqrt(2/N)."""
    k = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(N, dtype=np.float64)[None, :]
    C = np.cos(np.pi * (2.0 * n + 1.0) * k / (2.0 * N))
    C *= np.sqrt(2.0 / N)
    C[0, :] *= np.sqrt(0.5)
    C.setflags(write=False)
    return C


def dct_matrix(N: int, dtype=torch.float64, device='cpu') -> torch.Tensor:
    return torch.tensor(_dct_matrix_np(N)).to(device=device, dtype=dtype)


def require_full_fp32() -> None:
    """Keep the global TF32 switch off: a ``'highest'`` product is full
    float32, and TF32 is turned on only around a ``'default'`` one."""
    torch.backends.cuda.matmul.allow_tf32 = False


def mm(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``a @ b`` at a precision name (module docstring); None is
    ``'highest'``.  Either operand may be a stack (R, ., .)."""
    if precision in (None, 'highest') or a.dtype != torch.float32:
        return torch.matmul(a, b)
    if precision == 'high':
        return K.matmul(a, b)
    if precision == 'default':
        return K.matmul_tf32(a, b)
    raise ValueError(f"unknown matmul precision {precision!r}; "
                     f"choose from {PRECISIONS}")


def dct2(U: torch.Tensor, C: torch.Tensor, precision=None) -> torch.Tensor:
    """Orthonormal 2-D DCT-II (equals scipy ``dctn(U, norm='ortho')``)."""
    return mm(mm(C, U, precision), C.T, precision)


def idct2(X: torch.Tensor, C: torch.Tensor, precision=None) -> torch.Tensor:
    """Orthonormal 2-D DCT-III, the exact inverse of :func:`dct2`."""
    return mm(mm(C.T, X, precision), C, precision)


def _band(n: int, band_frac) -> int:
    """The first index of a banded contraction's tail over ``n`` spectral
    indices (n: no tail), as ``chsimpy_tpu/ops/dct.py`` ``_mmt_banded_l``
    cuts each split block."""
    if not band_frac:
        return n
    return min(n, max(1, int(n * band_frac)))


def _mmt_cut_l(M, y, precision, j0: int):
    """M.T @ y with y's rows from ``j0`` on (a high-frequency tail)
    contracted at ``BAND_PRECISION``."""
    low = mm(M.T[:, :j0], y[..., :j0, :], precision)
    if j0 == y.shape[-2]:
        return low
    return low + mm(M.T[:, j0:], y[..., j0:, :], BAND_PRECISION)


def _mm_cut_r(y, M, precision, j0: int):
    """y @ M with y's columns from ``j0`` on at ``BAND_PRECISION``."""
    low = mm(y[..., :j0], M[:j0], precision)
    if j0 == y.shape[-1]:
        return low
    return low + mm(y[..., j0:], M[j0:], BAND_PRECISION)


def _mmt_banded_l(M, y, precision, band_frac):
    """M.T @ y, the rows of y past ``band_frac`` of them (the block's
    tail: every split block is in ascending frequency) at
    ``BAND_PRECISION``."""
    return _mmt_cut_l(M, y, precision, _band(y.shape[-2], band_frac))


def _mm_banded_r(y, M, precision, band_frac):
    """y @ M, the right-side mirror of :func:`_mmt_banded_l`."""
    return _mm_cut_r(y, M, precision, _band(y.shape[-1], band_frac))


def idct2_banded(X: torch.Tensor, C: torch.Tensor, k0: int,
                 precision=None) -> torch.Tensor:
    """The inverse with a banded precision (``chsimpy_tpu/ops/dct.py:
    70-90``): both stages of C^T X C contract a frequency index, so each
    splits into the low band [0, k0) at ``precision`` and the tail
    [k0, N) at ``BAND_PRECISION``."""
    return _mm_cut_r(_mmt_cut_l(C, X, precision, k0), C, precision, k0)


# ----------------------------------------------------------------------
# matmul route on a grid mesh: the products GSPMD partitions in the JAX
# package (core/stepper.py, the matmul branch under P('x', 'y')).  Rank
# (i, j) holds block (I, J) of the field, |I| = bn = N/mx rows and
# |J| = bw = N/my columns, and does 1/(mx*my) of the FLOPs:
#
#   forward  C U C^T:  T = C[I, :] U[:, J]  (U[:, J]: all-gather over the
#                      column strip), then hat = T[I, :] C[J, :]^T
#                      (T[I, :]: all-gather over the row strip)
#   inverse  C^T X C:  the same with C^T (C's column strips)
#
# all_gather concatenates along dim 0, which assembles a column strip
# (blocks stacked by row) but not a row strip.  So the first product
# writes its block transposed, T[I, J]^T (bw, bn), straight from transposed
# views of its operands; the gather stacks those into T[I, :]^T (N, bn),
# and the second product reads it through a transposed view.  No block is
# copied for the layout: each 2-D transform moves (mx-1) + (my-1) blocks
# into each rank, 4 bytes (float32) or 8 per element.
# ----------------------------------------------------------------------

def dct2_grid(Ub: torch.Tensor, C: torch.Tensor, mesh,
              precision=None) -> torch.Tensor:
    """This rank's (bn, bw) block of ``dct2`` of the field whose block is
    ``Ub`` (a collective: every rank of the mesh calls it).  A stack of
    members' blocks (R, bn, bw) gives each member's block: batched
    products over the member axis and gathers of the stacked strips (the
    grid ensemble's transform)."""
    I, J = block_slices(mesh, C.shape[0])
    Ucol = coll.gather_x(mesh, Ub)                           # U[:, J]
    Tt = mm(Ucol.transpose(-1, -2), C[I].T, precision)       # T[I, J]^T
    G = coll.gather_y(mesh, Tt)                              # T[I, :]^T
    return mm(G.transpose(-1, -2), C[J].T, precision).contiguous()


def idct2_grid(Xb: torch.Tensor, C: torch.Tensor, mesh, precision=None,
               band: Optional[int] = None) -> torch.Tensor:
    """This rank's block of ``idct2`` of the spectral image whose block
    is ``Xb`` (a collective); member stacks as :func:`dct2_grid`.  Each
    stage contracts a frequency index (X's rows, then S's columns), so
    ``band`` cuts both as :func:`idct2_banded` does."""
    N = C.shape[0]
    I, J = block_slices(mesh, N)
    k0 = N if band is None else band
    Xcol = coll.gather_x(mesh, Xb)                           # X[:, J]
    St = _mm_cut_r(Xcol.transpose(-1, -2), C[:, I], precision, k0)
    G = coll.gather_y(mesh, St)                              # S[I, :]^T
    return _mm_cut_r(G.transpose(-1, -2), C[:, J], precision,
                     k0).contiguous()


# ----------------------------------------------------------------------
# pencil layout (chsimpy_tpu/ops/dct.py:659-697): the field is a column
# block (N, N/D) on every rank, the spectral image a row block (N/D, N).
# Each 1-D stage contracts a local axis and the one exchange of a 2-D
# transform is the transpose between them (``collectives.transpose_to_*``,
# the resharding JAX's ``constrain`` asks for).  The forward runs the
# column stage (over the rows, local in a column block) first; the inverse
# runs the row stage first, which nests the two 1-D sums the other way
# round from :func:`idct2_split_perm`: an equally exact DCT-III, the same
# bits on any number of ranks where each product gives the columns (rows)
# of the whole product's bits.  A stack of members (R, ., .) is
# transformed member by member over its last two axes.
# ----------------------------------------------------------------------

def dct2_pencil(Ub: torch.Tensor, C: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's row block of ``dct2`` of the field whose column block
    is ``Ub`` (a collective over the grid ``mesh``)."""
    T = coll.transpose_to_rows(mesh, torch.matmul(C, Ub))
    return torch.matmul(T, C.T).contiguous()


def idct2_pencil(Xb: torch.Tensor, C: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's column block of ``idct2`` of the spectral image whose
    row block is ``Xb``: ``(X @ C)``, the transpose, then ``C^T @ .``."""
    T = coll.transpose_to_cols(mesh, torch.matmul(Xb, C))
    return torch.matmul(C.T, T).contiguous()


def dct2_split_perm_pencil(Ub, tree, mesh, precision=None):
    """:func:`dct2_split_perm` of the field whose column block is ``Ub``:
    this rank's row block of the permuted spectral image."""
    T = coll.transpose_to_rows(mesh, _apply_split_perm(tree, Ub, precision))
    return _apply_split_perm_right(tree, T, precision).contiguous()


def idct2_split_perm_pencil(Xb, tree, mesh, precision=None,
                            band_frac=None):
    """The inverse of :func:`dct2_split_perm` with the last-axis stage
    first, from this rank's row block ``Xb`` to its column block of the
    field (``band_frac`` as :func:`idct2_split_perm`)."""
    T = coll.transpose_to_cols(mesh, _apply_split_t_perm_right(
        tree, Xb, precision, band_frac))
    return _apply_split_t_perm(tree, T, precision, band_frac).contiguous()


# ----------------------------------------------------------------------
# FFT route (Makhoul 1980):
#   v[n] = x[2n],  v[N-1-n] = x[2n+1]        (even-odd fold, no 2N pad)
#   X[k] = 2 * Re( e^{-i pi k / 2N} * FFT_N(v)[k] )
# with orthonormal scaling s_0 = sqrt(1/4N), s_k = sqrt(1/2N).
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _dct_fft_twiddles_np(N: int):
    """(forward twiddle t, inverse twiddle ti, rescale sh), in float64.
    Forward: X_ortho[k] = Re(t[k] * V[k]), t[k] = 2 s_k e^{-i pi k/2N}.
    Inverse: V[k] = ti[k] * sh[k] * (X[k] - i X[N-k]) for k <= N/2 (sh
    folds the ortho -> unnormalized rescale 1/s_k into the twiddle)."""
    k = np.arange(N, dtype=np.float64)
    s = np.full(N, np.sqrt(1.0 / (2.0 * N)))
    s[0] = np.sqrt(1.0 / (4.0 * N))
    w = np.exp(-1j * np.pi * k / (2.0 * N))
    t = 2.0 * s * w
    kh = np.arange(N // 2 + 1, dtype=np.float64)
    ti = 0.5 * np.exp(1j * np.pi * kh / (2.0 * N))
    sh = np.full(N // 2 + 1, np.sqrt(2.0 * N))
    sh[0] = np.sqrt(4.0 * N)
    return t, ti, sh


def _ctype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


@functools.lru_cache(maxsize=64)
def _fft_twiddles(N: int, dtype: torch.dtype, device: torch.device):
    """The twiddles as tensors on ``device`` (made once per shape: no host
    copy inside a timed loop): (t[:N/2+1], t[N/2+1:], ti * sh)."""
    t, ti, sh = _dct_fft_twiddles_np(N)
    ct = _ctype(dtype)
    return tuple(torch.tensor(a).to(device=device, dtype=ct)
                 for a in (t[:N // 2 + 1], t[N // 2 + 1:], ti * sh))


def _even_n(N: int) -> None:
    if N % 2:
        raise ValueError(f"fft DCT route requires even N, got {N}")


def dct1d_fft(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis via one N-point rFFT (even
    N only)."""
    N = x.shape[-1]
    _even_n(N)
    th, tt, _ = _fft_twiddles(N, x.dtype, x.device)
    v = torch.cat([x[..., ::2], torch.flip(x[..., 1::2], (-1,))], dim=-1)
    Vh = torch.fft.rfft(v, dim=-1)                 # k = 0 .. N/2
    Xh = torch.real(th * Vh)
    # k > N/2 from Hermitian symmetry: X[k] = Re(t[k] conj(V[N-k]))
    Xt = torch.real(tt * torch.conj(torch.flip(Vh[..., 1:N // 2], (-1,))))
    return torch.cat([Xh, Xt], dim=-1).to(x.dtype)


def idct1d_fft(X: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (inverse of :func:`dct1d_fft`) along the last
    axis via one N-point irFFT (even N only)."""
    N = X.shape[-1]
    _even_n(N)
    _, _, tis = _fft_twiddles(N, X.dtype, X.device)
    # X[k] - i X[N-k] for k = 0..N/2 (X[N] == 0): the mirror term walks the
    # upper half downward, b = [0, X[N-1], .., X[N/2]]
    a = X[..., :N // 2 + 1]
    b = torch.cat([torch.zeros_like(X[..., :1]),
                   torch.flip(X[..., N // 2:], (-1,))], dim=-1)
    Vh = tis * (a - 1j * b.to(tis.dtype))
    v = torch.fft.irfft(Vh, n=N, dim=-1).to(X.dtype)
    half = v[..., :N // 2]
    rev = torch.flip(v[..., N // 2:], (-1,))
    return torch.stack([half, rev], dim=-1).reshape(X.shape)


def dct2_fft(U: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II via row then column rFFTs (over the last two
    axes: a field or a stack of fields)."""
    return dct1d_fft(dct1d_fft(U).mT).mT.contiguous()


def idct2_fft(X: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-III, the exact inverse of :func:`dct2_fft`."""
    return idct1d_fft(idct1d_fft(X).mT).mT.contiguous()


# ----------------------------------------------------------------------
# split route: the block tree and its applications
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _split_tree_np(N: int, levels: int):
    """Nested block tree for ``levels`` folds: a leaf is a plain matrix, a
    node is (even_subtree, B).  Blocks are exact sub-matrices of the
    float64 orthonormal DCT-II matrix; block rows have norm 1/sqrt(2) per
    level, which makes the structured transpose the exact inverse."""
    C = _dct_matrix_np(N)

    def rec(M, lv):
        n = M.shape[1]
        if lv == 0 or n % 2:
            return M
        return (rec(M[0::2, :n // 2], lv - 1), M[1::2, :n // 2])

    return rec(C, levels)


def split_tree(N: int, levels: int, dtype=torch.float64, device='cpu'):
    """The block tree of :func:`_split_tree_np` on ``device``, each block
    a contiguous tensor."""
    def rec(t):
        if isinstance(t, tuple):
            return tuple(rec(s) for s in t)
        return torch.tensor(np.ascontiguousarray(t)).to(device=device,
                                                        dtype=dtype)
    return rec(_split_tree_np(N, levels))


def _flip0(x):
    """Reverse the row axis (-2: 0 of a field)."""
    return torch.flip(x, (-2,))


def _flip1(x):
    return torch.flip(x, (-1,))


def _apply_split(tree, x):
    """C_block @ x, contracting over axis 0 (x: (n, M)), natural order."""
    if not isinstance(tree, tuple):
        return torch.matmul(tree, x)
    n = x.shape[0]
    top, bot = x[:n // 2], _flip0(x[n // 2:])
    even = _apply_split(tree[0], top + bot)
    odd = torch.matmul(tree[1], top - bot)
    # interleave rows [e0, o0, e1, o1, ...]
    return torch.stack([even, odd], dim=1).reshape(n, x.shape[1])


def _apply_split_t(tree, y):
    """C_block^T @ y (the exact inverse of :func:`_apply_split`)."""
    if not isinstance(tree, tuple):
        return torch.matmul(tree.T, y)
    u = _apply_split_t(tree[0], y[0::2])
    v = torch.matmul(tree[1].T, y[1::2])
    return torch.cat([u + v, _flip0(u - v)], dim=0)


def dct2_split(U, tree):
    """Orthonormal 2-D DCT-II via the folded block products."""
    X = _apply_split(tree, U)
    return _apply_split(tree, X.T).T.contiguous()


def idct2_split(X, tree):
    """Orthonormal 2-D DCT-III, the structured transpose of
    :func:`dct2_split`."""
    U = _apply_split_t(tree, X)
    return _apply_split_t(tree, U.T).T.contiguous()


# --- permuted basis: the step touches spectral space only elementwise,
# so the interleave that restores natural coefficient order is dropped;
# outputs stay in block order and the solver's grids are conjugated once.

def _apply_split_perm(tree, x, precision=None):
    """P · C_block @ x: :func:`_apply_split` without the interleave (over
    the row axis -2, so x may be a stack of fields)."""
    if not isinstance(tree, tuple):
        return mm(tree, x, precision)
    n = x.shape[-2]
    top, bot = x[..., :n // 2, :], _flip0(x[..., n // 2:, :])
    even = _apply_split_perm(tree[0], top + bot, precision)
    odd = mm(tree[1], top - bot, precision)
    return torch.cat([even, odd], dim=-2)


def _apply_split_t_perm(tree, y, precision=None, band_frac=None):
    """C_block^T · P^T @ y, the inverse of :func:`_apply_split_perm`;
    ``band_frac``: each block's tail at ``BAND_PRECISION``."""
    if not isinstance(tree, tuple):
        return _mmt_banded_l(tree, y, precision, band_frac)
    n2 = y.shape[-2] // 2
    u = _apply_split_t_perm(tree[0], y[..., :n2, :], precision, band_frac)
    v = _mmt_banded_l(tree[1], y[..., n2:, :], precision, band_frac)
    return torch.cat([u + v, _flip0(u - v)], dim=-2)


@functools.lru_cache(maxsize=64)
def _split_permutation_np(N: int, levels: int) -> np.ndarray:
    """perm with (P·C x)[i] == (C x)[perm[i]] for the block order of
    :func:`_apply_split_perm` (also the order the ozaki rfold route
    emits, ops/ozaki.py)."""
    def rec(n, lv):
        if lv == 0 or n % 2:
            return np.arange(n)
        even = 2 * rec(n // 2, lv - 1)
        odd = 1 + 2 * np.arange(n // 2)
        return np.concatenate([even, odd])
    return rec(N, levels)


def split_permute_grid(G: np.ndarray, N: int, levels: int) -> np.ndarray:
    """Conjugate an (N, N) spectral-space grid into the permuted basis
    (host-side, at setup)."""
    p = _split_permutation_np(N, levels)
    return np.asarray(G)[np.ix_(p, p)]


def split_permute_axis(v: np.ndarray, N: int, levels: int) -> np.ndarray:
    """Permute a 1-D spectral axis into the same block order: the
    separable factor of :func:`split_permute_grid`."""
    return np.asarray(v)[_split_permutation_np(N, levels)]


def _mm_nt(x, m, precision=None):
    """x @ m^T, the transpose a view (no copy of the block; K6 reads it
    as a transposed operand)."""
    return mm(x, m.T, precision)


def _apply_split_perm_right(tree, x, precision=None):
    """x @ (P·C_block)^T: folds and block order along the LAST axis, so
    the 2-D transform runs rows then columns with no full-field
    transpose."""
    if not isinstance(tree, tuple):
        return _mm_nt(x, tree, precision)
    n = x.shape[-1]
    top, bot = x[..., :n // 2], _flip1(x[..., n // 2:])
    even = _apply_split_perm_right(tree[0], top + bot, precision)
    odd = _mm_nt(top - bot, tree[1], precision)
    return torch.cat([even, odd], dim=-1)


def _apply_split_t_perm_right(tree, y, precision=None, band_frac=None):
    """y @ P·C_block, the inverse of :func:`_apply_split_perm_right`."""
    if not isinstance(tree, tuple):
        return _mm_banded_r(y, tree, precision, band_frac)
    n2 = y.shape[-1] // 2
    u = _apply_split_t_perm_right(tree[0], y[..., :n2], precision,
                                  band_frac)
    v = _mm_banded_r(y[..., n2:], tree[1], precision, band_frac)
    return torch.cat([u + v, _flip1(u - v)], dim=-1)


def dct2_split_perm(U, tree, precision=None):
    """2-D DCT-II into the permuted spectral basis (rows by the left
    application, columns by the right one)."""
    return _apply_split_perm_right(tree, _apply_split_perm(tree, U,
                                                           precision),
                                   precision)


def idct2_split_perm(X, tree, precision=None, band_frac=None):
    """Inverse from the permuted spectral basis (the exact inverse of
    :func:`dct2_split_perm`); ``band_frac`` contracts the high-frequency
    tail of every block at ``BAND_PRECISION`` (``chsimpy_tpu/ops/dct.py``
    ``_mmt_banded_l``)."""
    return _apply_split_t_perm_right(
        tree, _apply_split_t_perm(tree, X, precision, band_frac), precision,
        band_frac)


# --- level-1 folded field: bottom rows and right columns stored reversed,
# so the level-1 fold of the forward and the unfold of the inverse read
# the halves directly instead of reversing them.

def fold1(x: torch.Tensor) -> torch.Tensor:
    """Natural <-> level-1-folded spatial layout (an involution) over the
    last two axes: bottom half rows reversed, then right half columns
    reversed (the JAX ``fold1`` / ``fold1_np``)."""
    n = x.shape[-2]
    x = torch.cat([x[..., :n // 2, :], _flip0(x[..., n // 2:, :])], dim=-2)
    return fold_cols(x)


def fold_cols(x: torch.Tensor) -> torch.Tensor:
    """:func:`fold1` of the last axis alone (rows of a folded field)."""
    m = x.shape[-1]
    return torch.cat([x[..., :m // 2], _flip1(x[..., m // 2:])], dim=-1)


def _needs_levels(tree) -> None:
    if not isinstance(tree, tuple):
        raise ValueError("folded split variants need levels >= 1")


def dct2_split_perm_folded(V, tree, precision=None):
    """2-D DCT-II (permuted basis) of a level-1-folded field (or a stack
    of them); equals ``dct2_split_perm(fold1(V))`` without the two
    reversals."""
    _needs_levels(tree)
    n = V.shape[-2]
    top, bot = V[..., :n // 2, :], V[..., n // 2:, :]
    X = torch.cat([_apply_split_perm(tree[0], top + bot, precision),
                   mm(tree[1], top - bot, precision)], dim=-2)
    m = X.shape[-1]
    left, right = X[..., :m // 2], X[..., m // 2:]
    return torch.cat([_apply_split_perm_right(tree[0], left + right,
                                              precision),
                      _mm_nt(left - right, tree[1], precision)], dim=-1)


def idct2_split_perm_folded(X, tree, precision=None, band_frac=None):
    """Inverse of :func:`dct2_split_perm_folded`, emitting the
    level-1-folded field (``fold1(idct2_split_perm(X))`` without the two
    reversals); ``band_frac`` as :func:`idct2_split_perm`."""
    _needs_levels(tree)
    n2 = X.shape[-2] // 2
    u = _apply_split_t_perm(tree[0], X[..., :n2, :], precision, band_frac)
    v = _mmt_banded_l(tree[1], X[..., n2:, :], precision, band_frac)
    U = torch.cat([u + v, u - v], dim=-2)
    m2 = U.shape[-1] // 2
    u = _apply_split_t_perm_right(tree[0], U[..., :m2], precision,
                                  band_frac)
    v = _mm_banded_r(U[..., m2:], tree[1], precision, band_frac)
    return torch.cat([u + v, u - v], dim=-1)
