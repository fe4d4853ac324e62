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
kernel; here they go to ``torch.matmul`` and ``torch.fft``.  Transposes are
views: ``_mm_nt`` is ``x @ m.T`` with no copy.  ``x[n//2:][::-1]`` has no
torch view, so every reversal is a ``torch.flip`` (a copy).  The 2-D
transforms return contiguous tensors: the kernels take nothing else.

The solver runs the permuted forms and the FFT route.  These and the
matmul route's :func:`dct2` / :func:`idct2` also take a stack of fields
(R, N, N), each transformed over its last two axes: the ensemble's step
(``torch.matmul`` broadcasts the (N, N) matrices over the member axis).  The natural-layout
pair and the folded pair are reached only from the bake-off
(``benchmarks/dct_bench.py``): the solver's folded field layout
(``fold_field``, the JAX ``fold1_np``) is item 14.

Not ported: the Hou odd-branch recursion (measured and rejected, ROADMAP.md
queue A item 2), and the ``band_frac`` banding and ``idct2_banded`` (the
``--inv-band`` knob, item 14).

float32 products run in full float32: :func:`require_full_fp32` turns
TF32 off.  The JAX float32 route contracts at 3-pass bf16 ('high', about
float32 accuracy) and its E trace is held to the float32 class against
float64 (1e-5 relative); TF32 keeps about three decimal digits and would
leave that class.  Whether a TF32 or 3xTF32 product keeps the class is a
measurement for a later change.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import collectives as coll
from ..parallel.sharding import block_slices


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
    """Keep float32 matrix products in full float32 on the card (see the
    module docstring for why the solve does not take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def dct2(U: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II (equals scipy ``dctn(U, norm='ortho')``)."""
    return torch.matmul(torch.matmul(C, U), C.T)


def idct2(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-III, the exact inverse of :func:`dct2`."""
    return torch.matmul(torch.matmul(C.T, X), C)


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

def dct2_grid(Ub: torch.Tensor, C: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (bn, bw) block of ``dct2`` of the field whose block is
    ``Ub`` (a collective: every rank of the mesh calls it).  A stack of
    members' blocks (R, bn, bw) gives each member's block: batched
    products over the member axis and gathers of the stacked strips (the
    grid ensemble's transform)."""
    I, J = block_slices(mesh, C.shape[0])
    Ucol = coll.gather_x(mesh, Ub)                           # U[:, J]
    Tt = torch.matmul(Ucol.transpose(-1, -2), C[I].T)        # T[I, J]^T
    G = coll.gather_y(mesh, Tt)                              # T[I, :]^T
    return torch.matmul(G.transpose(-1, -2), C[J].T).contiguous()


def idct2_grid(Xb: torch.Tensor, C: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``idct2`` of the spectral image whose block
    is ``Xb`` (a collective); member stacks as :func:`dct2_grid`."""
    I, J = block_slices(mesh, C.shape[0])
    Xcol = coll.gather_x(mesh, Xb)                           # X[:, J]
    St = torch.matmul(Xcol.transpose(-1, -2), C[:, I])       # S[I, J]^T
    G = coll.gather_y(mesh, St)                              # S[I, :]^T
    return torch.matmul(G.transpose(-1, -2), C[:, J]).contiguous()


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


def dct2_split_perm_pencil(Ub, tree, mesh):
    """:func:`dct2_split_perm` of the field whose column block is ``Ub``:
    this rank's row block of the permuted spectral image."""
    T = coll.transpose_to_rows(mesh, _apply_split_perm(tree, Ub))
    return _apply_split_perm_right(tree, T).contiguous()


def idct2_split_perm_pencil(Xb, tree, mesh):
    """The inverse of :func:`dct2_split_perm` with the last-axis stage
    first, from this rank's row block ``Xb`` to its column block of the
    field."""
    T = coll.transpose_to_cols(mesh, _apply_split_t_perm_right(tree, Xb))
    return _apply_split_t_perm(tree, T).contiguous()


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

def _apply_split_perm(tree, x):
    """P · C_block @ x: :func:`_apply_split` without the interleave (over
    the row axis -2, so x may be a stack of fields)."""
    if not isinstance(tree, tuple):
        return torch.matmul(tree, x)
    n = x.shape[-2]
    top, bot = x[..., :n // 2, :], _flip0(x[..., n // 2:, :])
    even = _apply_split_perm(tree[0], top + bot)
    odd = torch.matmul(tree[1], top - bot)
    return torch.cat([even, odd], dim=-2)


def _apply_split_t_perm(tree, y):
    """C_block^T · P^T @ y, the inverse of :func:`_apply_split_perm`."""
    if not isinstance(tree, tuple):
        return torch.matmul(tree.T, y)
    n2 = y.shape[-2] // 2
    u = _apply_split_t_perm(tree[0], y[..., :n2, :])
    v = torch.matmul(tree[1].T, y[..., n2:, :])
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


def _mm_nt(x, m):
    """x @ m^T, the transpose a view (no copy of the block)."""
    return torch.matmul(x, m.T)


def _apply_split_perm_right(tree, x):
    """x @ (P·C_block)^T: folds and block order along the LAST axis, so
    the 2-D transform runs rows then columns with no full-field
    transpose."""
    if not isinstance(tree, tuple):
        return _mm_nt(x, tree)
    n = x.shape[-1]
    top, bot = x[..., :n // 2], _flip1(x[..., n // 2:])
    even = _apply_split_perm_right(tree[0], top + bot)
    odd = _mm_nt(top - bot, tree[1])
    return torch.cat([even, odd], dim=-1)


def _apply_split_t_perm_right(tree, y):
    """y @ P·C_block, the inverse of :func:`_apply_split_perm_right`."""
    if not isinstance(tree, tuple):
        return torch.matmul(y, tree)
    n2 = y.shape[-1] // 2
    u = _apply_split_t_perm_right(tree[0], y[..., :n2])
    v = torch.matmul(y[..., n2:], tree[1])
    return torch.cat([u + v, _flip1(u - v)], dim=-1)


def dct2_split_perm(U, tree):
    """2-D DCT-II into the permuted spectral basis (rows by the left
    application, columns by the right one)."""
    return _apply_split_perm_right(tree, _apply_split_perm(tree, U))


def idct2_split_perm(X, tree):
    """Inverse from the permuted spectral basis (the exact inverse of
    :func:`dct2_split_perm`)."""
    return _apply_split_t_perm_right(tree, _apply_split_t_perm(tree, X))


# --- level-1 folded field: bottom rows and right columns stored reversed,
# so the level-1 fold of the forward and the unfold of the inverse read
# the halves directly instead of reversing them.

def fold1(x: torch.Tensor) -> torch.Tensor:
    """Natural <-> level-1-folded spatial layout (an involution): bottom
    half rows reversed, then right half columns reversed."""
    n, m = x.shape[0], x.shape[1]
    x = torch.cat([x[:n // 2], _flip0(x[n // 2:])], dim=0)
    return torch.cat([x[..., :m // 2], _flip1(x[..., m // 2:])], dim=-1)


def _needs_levels(tree) -> None:
    if not isinstance(tree, tuple):
        raise ValueError("folded split variants need levels >= 1")


def dct2_split_perm_folded(V, tree):
    """2-D DCT-II (permuted basis) of a level-1-folded field; equals
    ``dct2_split_perm(fold1(V))`` without the two reversals."""
    _needs_levels(tree)
    n = V.shape[0]
    top, bot = V[:n // 2], V[n // 2:]
    X = torch.cat([_apply_split_perm(tree[0], top + bot),
                   torch.matmul(tree[1], top - bot)], dim=0)
    m = X.shape[-1]
    left, right = X[..., :m // 2], X[..., m // 2:]
    return torch.cat([_apply_split_perm_right(tree[0], left + right),
                      _mm_nt(left - right, tree[1])], dim=-1)


def idct2_split_perm_folded(X, tree):
    """Inverse of :func:`dct2_split_perm_folded`, emitting the
    level-1-folded field (``fold1(idct2_split_perm(X))`` without the two
    reversals)."""
    _needs_levels(tree)
    n2 = X.shape[0] // 2
    u = _apply_split_t_perm(tree[0], X[:n2])
    v = torch.matmul(tree[1].T, X[n2:])
    U = torch.cat([u + v, u - v], dim=0)
    m2 = U.shape[-1] // 2
    u = _apply_split_t_perm_right(tree[0], U[..., :m2])
    v = torch.matmul(U[..., m2:], tree[1])
    return torch.cat([u + v, u - v], dim=-1)
