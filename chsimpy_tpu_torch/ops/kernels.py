"""The step's kernels: a hand-written CUDA kernel for a tensor on the card,
its plain PyTorch version for a tensor on the CPU.

Counterpart of ``chsimpy_tpu/ops/pallas_kernels.py`` (K1-K4, the tiled
matmul K6 with the DCTs built on it, and the grid-sharded K7 and K8) and
of the ozaki route's slice kernel in ``chsimpy_tpu/ops/ozaki.py`` (K5).
K9, the per-step Sobol jitter, has no Pallas counterpart: it adds the
points of ``chsimpy_tpu/ops/sobol.py`` (which XLA fuses there) to the
field; nor has K10, the ``device`` jitter, which draws the JAX step's
``jax.random`` threefry stream on the card.  K1-K4 also come
member-batched (``*_members``) for the ensemble, where the JAX package
``vmap``s B1-B4 over a leading member axis with per-member A0/A1
(``chsimpy_tpu/ensemble.py``): one launch for R fields of an (R, N, N)
stack, member r giving the single launch's bits on field r with its own
scalars; so does K5 on the ozaki route (``slice_field_members``, B6 under
``vmap``: each member its own scale), K5 on a rank's block of a
pencil-sharded field at the whole field's scale (``slice_field_sharded``
and ``slice_field_members_sharded``), and K7 on the members' blocks of a
grid ensemble (``local_band_sums_members``, B7 under ``vmap``; K1, K2 and
K4 take the blocks as they are).  K11 (``row_absdev_members``) takes each
member's Ra with an order that does not depend on the member count (no
Pallas counterpart); the members' step runs its body in K4_members'
second pass (``absdev_ra_members``).  K12 (``update_otf``,
``update_otf_members``) is K2 with its coefficient grids rebuilt in
registers from the eigenvalue axis
(the JAX step's ``otf_coeffs``, fused by XLA there); K3 and K3_members
take the field in the folded layout of ``fold_field`` (``fold=True``); K6
takes a member axis and is the solve's float32 product at
``matmul_precision='high'``.  Each wrapper

* runs the plain version (``*_ref``) only when its input lies on the CPU;
* on a CUDA tensor launches its kernel (``csrc/ch_kernels.cu``; the GEMM
  ``csrc/gemm_sm90.cu``) on the current stream or raises — there is no
  fallback;
* adds one to ``launches[name]`` where it launches the kernel, and nowhere
  else (the CPU path does not count); K5 and K5_members also count in
  ``one_launch`` the calls that took their one-launch path.  A thread
  inside :func:`own_counts` (a CUDA graph's capture) counts in its own
  pair of dicts instead.

The ``*_ref`` functions keep the JAX package's formulas and operation
order.  Sums are returned as float64 tensors on the input's device: the
float32 stop predicate rests on a float64 accumulation of float32 terms.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Optional

import torch

from ..parallel import collectives as coll
from .sobol import MASK32, SOBOL_BITS, sobol_points_ref
from .stencil import gradient2d

# kernel name -> number of launches on the card (see reset_launches)
launches = {'chemical_potential': 0, 'spectral_update': 0,
            'stats_sums': 0, 'absdev_sum': 0, 'slice_field': 0, 'matmul': 0,
            'local_band_sums': 0, 'chemical_potential_sharded': 0,
            'sobol_jitter': 0, 'chemical_potential_members': 0,
            'spectral_update_members': 0, 'stats_sums_members': 0,
            'absdev_sum_members': 0, 'threefry_jitter': 0,
            'slice_field_members': 0, 'local_band_sums_members': 0,
            'row_absdev_members': 0, 'slice_field_sharded': 0,
            'slice_field_members_sharded': 0, 'update_otf': 0,
            'update_otf_members': 0}
# of those calls of K5 and K5_members, the ones that took the one-launch
# path (slice_one_launch_kernel; the others launched the max and slice
# passes)
one_launch = {'slice_field': 0, 'slice_field_members': 0}

# grids of the reduction kernels: fixed by the shape (and, for K3 and K7,
# the vector width) alone, so the summation order (and the result, to the
# bit) never depends on the card
STATS_THREADS = 256             # K3/K7: threads per block, V columns each
STATS_ROWS_X_VEC = 64           # K3/K7's fixed tile: rows per band times V
STATS_MIN_BLOCKS = 256          # K3/K7: a grid below this is refined
STATS_MIN_BAND = 4              # K3/K7: the refined tile's shortest band
ABSDEV_ELEMS_PER_BLOCK = 8 * 256
ABSDEV_MAX_BLOCKS = 4096
SLICE_MAX_BLOCKS = 1024         # K5's max pass: blocks at most
# K5 sharded's max pass on a rank's block: blocks at most (about two an SM
# of the H100; the max is exact, so the grid changes no bit).  On the H100,
# in turns (benchmarks/slice_paths.py --sharded): 0.0091 ms on a (4096,
# 1024) and a 2047x2047 block against 0.0093-0.0095 on a whole field's
# SLICE_MAX_BLOCKS; the same 0.0048 on R=4 (512, 128) blocks
SLICE_SHARDED_MAX_BLOCKS = 256
# K5's one-launch path: fields of at most this many bytes in all.  One
# launch against two on the H100, one call (benchmarks/slice_paths.py):
# 0.82-1.00 of the time at 32 MiB (R=16 N=512, R=4 N=1024, R=1 N=2048),
# 0.87-0.93 at 40 and 48 MiB (R=5, 6 at N=1024; R=20, 24 at N=512); a
# single 50 MiB field 1.06-1.07, 64 MiB stacks 0.98-0.99, 128 and 512
# MiB 1.10-1.13 (the second read no longer comes from the 50 MB L2)
SLICE_ONE_LAUNCH_BYTES = 48 << 20

# the ticket counters of K3, K5 and K7, one set per (device, stream), one
# counter per member of a batched K3: 0 between calls; and the scratch of
# K5's one-launch path, likewise
_TICKETS: dict = {}
_SLICE_SCRATCH: dict = {}
_OWNER = threading.local()      # .scratch: own_scratch's dict, or None;
                                # .counts: own_counts' dicts, or None

_SUFFIX = {torch.float32: '_f32', torch.float64: '_f64'}


def reset_launches() -> None:
    for counts in (launches, one_launch):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def own_counts():
    """Inside (in this thread): the launches are counted in the two dicts
    yielded, this thread's own ``launches`` and ``one_launch``, and not in
    those.  A CUDA graph's capture, which launches nothing, keeps so what
    each replay launches (:func:`add_counts`); other threads count as
    ever, launches and replays alike."""
    outer = getattr(_OWNER, 'counts', None)
    own = (defaultdict(int), defaultdict(int))
    _OWNER.counts = own
    try:
        yield own
    finally:
        _OWNER.counts = outer


def add_counts(own) -> None:
    """Add :func:`own_counts`' dicts to ``launches`` and ``one_launch``."""
    for counts, add in zip((launches, one_launch), own):
        for k, n in add.items():
            counts[k] += n


def _count(counts: dict, name: str) -> None:
    """One launch of ``name`` in ``counts`` (``launches`` or
    ``one_launch``), or in this thread's :func:`own_counts`."""
    own = getattr(_OWNER, 'counts', None)
    if own is not None:
        counts = own[counts is one_launch]
    counts[name] += 1


def _cast(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype`` (a float64 scalar cast to the field type, as
    the JAX step casts A0/A1)."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _on_card(*tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises otherwise."""
    t0 = tensors[0]
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"kernel inputs on different devices: "
                             f"{t.device} vs {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"kernel inputs of different types: "
                            f"{t.dtype} vs {t0.dtype}")
    if t0.device.type == 'cpu':
        return False
    if t0.device.type != 'cuda':
        raise ValueError(f"no kernel for device {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise TypeError(f"the kernels take float32 or float64, "
                        f"got {t0.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    if t0.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t0.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return True


def _call(name: str, dtype: torch.dtype, *args) -> None:
    from .cuda_build import load_library
    fn = getattr(load_library(), name + _SUFFIX[dtype])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name}{_SUFFIX[dtype]} failed to "
                           f"launch: cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _square(U: torch.Tensor) -> None:
    if U.dim() != 2 or U.shape[0] != U.shape[1] or U.shape[0] < 2:
        raise ValueError(f"expected an (N, N) field with N >= 2, "
                         f"got {tuple(U.shape)}")


def _block(U: torch.Tensor) -> None:
    """A 2-D block of a field (one rank's share on a grid mesh)."""
    if U.dim() != 2 or 0 in U.shape:
        raise ValueError(f"expected a non-empty 2-D block, got "
                         f"{tuple(U.shape)}")


# ----------------------------------------------------------------------
# K1: chemical potential (replaces pallas_kernels.chemical_potential)
# ----------------------------------------------------------------------

def chemical_potential_ref(U, RT, BRT, A0, A1):
    """EnergieEut = RT·log(U/(1−U)) − BRT + (A0+A1(1−2U))(1−2U) − 2A1·U(1−U)
    (``chsimpy_tpu/core/stepper.py:_nonlinear_term``)."""
    A0 = _cast(A0, U.dtype)
    A1 = _cast(A1, U.dtype)
    Uinv = 1.0 - U
    U1Uinv = U / Uinv
    U2inv = Uinv - U
    return (RT * torch.log(U1Uinv) - BRT
            + (A0 + A1 * U2inv) * U2inv
            - 2.0 * A1 * U * Uinv)


def _launch_mu(U, RT, BRT, A0, A1):
    out = torch.empty_like(U)
    _call('ch_mu', U.dtype, U.data_ptr(), out.data_ptr(), U.numel(),
          float(RT), float(BRT), float(A0), float(A1), _stream())
    return out


def chemical_potential(U, RT, BRT, A0, A1):
    if not _on_card(U):
        return chemical_potential_ref(U, RT, BRT, A0, A1)
    out = _launch_mu(U, RT, BRT, A0, A1)
    _count(launches, 'chemical_potential')
    return out


# ----------------------------------------------------------------------
# K2: spectral update (replaces pallas_kernels.spectral_update)
# ----------------------------------------------------------------------

def spectral_update_ref(hat_U, hat_E, Seig, CHeig):
    """hat_U' = (hat_U + Seig * hat_E) / CHeig."""
    return (hat_U + Seig * hat_E) / CHeig


def spectral_update(hat_U, hat_E, Seig, CHeig):
    if not _on_card(hat_U, hat_E, Seig, CHeig):
        return spectral_update_ref(hat_U, hat_E, Seig, CHeig)
    if not (hat_U.shape == hat_E.shape == Seig.shape == CHeig.shape):
        raise ValueError("spectral_update operands differ in shape")
    out = torch.empty_like(hat_U)
    _call('ch_update', hat_U.dtype, hat_U.data_ptr(), hat_E.data_ptr(),
          Seig.data_ptr(), CHeig.data_ptr(), out.data_ptr(), hat_U.numel(),
          _stream())
    _count(launches, 'spectral_update')
    return out


# ----------------------------------------------------------------------
# K12: spectral update with the coefficients rebuilt from the eigenvalue
# axis (replaces the JAX step's otf_coeffs update, coeffs.
# get_coefficients_axis fused into (hat_U + Seig*hat_E)/CHeig by XLA)
# ----------------------------------------------------------------------

def otf_coefficients_ref(e_rows, e_cols, delt, kappa, delx2):
    """(CHeig, Seig) of ``chsimpy_tpu/ops/coeffs.py``
    ``get_coefficients_axis`` over leig = e_rows[i] + e_cols[j], in its
    operations and order: lam1 = delt / delx2, lam2 = kappa * lam1 /
    delx2 (true divisions: delx2 is a tensor of the axis' type on its
    device, since PyTorch turns a division of a CUDA tensor by a Python
    number into a product with its reciprocal), CHeig = 1 + lam2 *
    (leig * leig), Seig = lam1 * leig.  ``delt``: a float64 tensor, 0-d or
    (R,) (one per member); ``kappa``: a float or an (R,) float64 tensor;
    both cast to the axis' type first, as the JAX step casts them.  The
    grids are (rows, cols), or (R, rows, cols) for member arrays."""
    dtype = e_rows.dtype
    d2 = torch.tensor(delx2, dtype=dtype, device=e_rows.device)
    if isinstance(kappa, torch.Tensor):
        kappa = kappa.to(dtype).reshape(-1, 1, 1)
    else:
        kappa = _cast(kappa, dtype)
    delt = delt.to(dtype)
    if delt.dim():
        delt = delt.reshape(-1, 1, 1)
    lam1 = delt / d2
    lam2 = kappa * lam1 / d2
    leig = e_rows.reshape(-1, 1) + e_cols.reshape(1, -1)
    return 1.0 + lam2 * (leig * leig), lam1 * leig


def _otf_axes(eaxis, shape, row_off: int, col_off: int):
    rows, cols = shape
    N = eaxis.shape[0]
    if eaxis.dim() != 1 or not (0 <= row_off and row_off + rows <= N
                                and 0 <= col_off and col_off + cols <= N):
        raise ValueError(f"a ({rows}, {cols}) block at ({row_off}, "
                         f"{col_off}) does not lie in the spectral image of "
                         f"an axis of shape {tuple(eaxis.shape)}")
    return (eaxis[row_off:row_off + rows], eaxis[col_off:col_off + cols])


def update_otf_ref(hat_U, hat_E, eaxis, delt, kappa, delx2,
                   row_off: int = 0, col_off: int = 0):
    """:func:`spectral_update_ref` with (CHeig, Seig) from
    :func:`otf_coefficients_ref` on the block of the spectral image at
    (row_off, col_off)."""
    CHeig, Seig = otf_coefficients_ref(
        *_otf_axes(eaxis, hat_U.shape[-2:], row_off, col_off), delt, kappa,
        delx2)
    return (hat_U + Seig * hat_E) / CHeig


def _otf_checks(hat_U, hat_E, eaxis, delt):
    if hat_E.shape != hat_U.shape:
        raise ValueError("hat_E and hat_U differ in shape")
    if eaxis.dtype != hat_U.dtype or eaxis.device != hat_U.device:
        raise ValueError("eaxis must be of the field's type and device")
    if delt.dtype != torch.float64 or delt.device != hat_U.device:
        raise ValueError("delt must be a float64 tensor on the field's "
                         "device")


def update_otf(hat_U, hat_E, eaxis, delt, kappa, delx2, row_off: int = 0,
               col_off: int = 0):
    """K12 on a field, or on a rank's (rows, cols) block at (row_off,
    col_off) of the spectral image (a grid or pencil block): ``delt`` a
    0-d float64 tensor on the card (read there: no host sync), ``kappa``
    a float, ``eaxis`` the whole (N,) axis in the route's order."""
    _block(hat_U)
    _otf_checks(hat_U, hat_E, eaxis, delt)
    if delt.dim() != 0:
        raise ValueError("delt must be a 0-d tensor")
    _otf_axes(eaxis, hat_U.shape, row_off, col_off)
    if not _on_card(hat_U, hat_E, eaxis):
        return update_otf_ref(hat_U, hat_E, eaxis, delt, kappa, delx2,
                              row_off, col_off)
    out = torch.empty_like(hat_U)
    rows, cols = hat_U.shape
    _call('ch_update_otf', hat_U.dtype, hat_U.data_ptr(), hat_E.data_ptr(),
          eaxis.data_ptr(), out.data_ptr(), rows, cols, int(row_off),
          int(col_off), 1, delt.data_ptr(), 0, None, float(kappa),
          float(delx2), _stream())
    _count(launches, 'update_otf')
    return out


def update_otf_members(hat_U, hat_E, eaxis, delts, kappas, delx2,
                       row_off: int = 0, col_off: int = 0):
    """K12 on every member's field (or block) of an (R, rows, cols)
    stack in one launch, member r with its own kappa (``kappas``: (R,)
    float64) and delt (``delts``: (R,) float64, or one 0-d delt for all):
    what the ensemble's (R, N, N) CHeig grids give, without them."""
    R = _member_blocks(hat_U)
    _otf_checks(hat_U, hat_E, eaxis, delts)
    _member_vector('kappas', kappas, R, hat_U, torch.float64)
    if delts.dim():
        _member_vector('delts', delts, R, hat_U, torch.float64)
    _otf_axes(eaxis, hat_U.shape[1:], row_off, col_off)
    if not _on_card(hat_U, hat_E, eaxis):
        return update_otf_ref(hat_U, hat_E, eaxis, delts, kappas, delx2,
                              row_off, col_off)
    if not (delts.is_contiguous() and kappas.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    out = torch.empty_like(hat_U)
    _, rows, cols = hat_U.shape
    _call('ch_update_otf', hat_U.dtype, hat_U.data_ptr(), hat_E.data_ptr(),
          eaxis.data_ptr(), out.data_ptr(), rows, cols, int(row_off),
          int(col_off), R, delts.data_ptr(), int(delts.dim() > 0),
          kappas.data_ptr(), 0.0, float(delx2), _stream())
    _count(launches, 'update_otf_members')
    return out


# ----------------------------------------------------------------------
# K3: fused field sums (replaces pallas_kernels.stats_band_sums)
# ----------------------------------------------------------------------

def _unfolded(U, EnergieEut, fold: bool):
    """(U, EnergieEut) in the natural layout: as given, or (``fold``)
    read back from the level-1 folded layout (an even N)."""
    if not fold:
        return U, EnergieEut
    if U.shape[-1] % 2:
        raise ValueError(f"the folded layout needs an even N, got "
                         f"{U.shape[-1]}")
    from .dct import fold1
    return fold1(U), None if EnergieEut is None else fold1(EnergieEut)


def stats_sums_ref(U, EnergieEut: Optional[torch.Tensor], A0, A1, *,
                   delx, RT, B, threshold, fold: bool = False):
    """(5,) float64: [Σ integrand, Σ|∇U|², ΣU, #(U<threshold), ΣEnergieEut²]
    — terms in the field type, sums in float64; the last is 0 when
    ``EnergieEut`` is None (the prepare path).  ``fold``: U and EnergieEut
    are in the level-1 folded layout (``ops/dct.py`` :func:`fold1`), the
    sums those of the natural field."""
    U, EnergieEut = _unfolded(U, EnergieEut, fold)
    A0 = _cast(A0, U.dtype)
    A1 = _cast(A1, U.dtype)
    f64 = torch.float64
    DUx, DUy = gradient2d(U, delx)
    du2 = DUx * DUx + DUy * DUy
    Uinv = 1.0 - U
    integrand = (RT * (U * (torch.log(U) - B) + Uinv * torch.log(Uinv))
                 + (A0 + A1 * (Uinv - U)) * U * Uinv)
    if EnergieEut is None:
        s_e2 = torch.zeros((), dtype=f64, device=U.device)
    else:
        s_e2 = (EnergieEut * EnergieEut).to(f64).sum()
    return torch.stack([integrand.to(f64).sum(), du2.to(f64).sum(),
                        U.to(f64).sum(), (U < threshold).to(f64).sum(),
                        s_e2])


def _check_block(bn: int, W: int, N: int, row_off: int, col_off: int):
    if not (bn >= 1 and W >= 1 and N >= 2 and 0 <= row_off
            and row_off + bn <= N and 0 <= col_off and col_off + W <= N):
        raise ValueError(f"block {bn}x{W} at ({row_off}, {col_off}) does "
                         f"not lie in an ({N}, {N}) field")


def _stats_blocks(bn: int, W: int, vec: int, band: int) -> int:
    return -(-W // (STATS_THREADS * vec)) * -(-bn // band)


def _tile(bn: int, W: int, vec: int):
    """(V, band) of the statistics kernel on a (bn, W) block whose widest
    vector is ``vec``: the fixed tile (STATS_THREADS * V columns,
    STATS_ROWS_X_VEC / V rows) where it gives at least STATS_MIN_BLOCKS
    blocks; else the vector halves while a block of the narrower one
    still spans W, and the band halves (from STATS_ROWS_X_VEC / V, down
    to STATS_MIN_BAND) until the grid has STATS_MIN_BLOCKS blocks."""
    band = STATS_ROWS_X_VEC // vec
    if _stats_blocks(bn, W, vec, band) >= STATS_MIN_BLOCKS:
        return vec, band
    while vec > 1 and STATS_THREADS * (vec // 2) >= W:
        vec //= 2
    band = STATS_ROWS_X_VEC // vec
    while (band > STATS_MIN_BAND
           and _stats_blocks(bn, W, vec, band) < STATS_MIN_BLOCKS):
        band //= 2
    return vec, band


def stats_tile(bn: int, W: int, N: int, row_off: int, col_off: int,
               itemsize: int, *addresses: int, fold: bool = False):
    """(V, band, blocks) of the statistics kernel on a (bn, W) block at
    (row_off, col_off) of an (N, N) field (K3: the whole field): V
    columns a thread, ``band`` rows a block of STATS_THREADS threads.
    The widest vector is 16 / itemsize columns (a float4 or double2)
    where W and every address (the block, E and the halo rows) allow it,
    else 1; :func:`_tile` sizes the rest from (bn, W) and that width.  The
    offsets only have to place the block in the field: the tile, and with
    it the summation order, is the same wherever the block lies, so a
    member of a batched launch takes the single launch's and K7 on the
    whole field K3's.  ``fold`` (K3's fold mode): the vector also needs
    N/2 divisible by V (a thread's columns lie on one side of the fold),
    else the one-column tile."""
    _check_block(bn, W, N, row_off, col_off)
    vec, band = _tile(bn, W, _widest_vec(W, itemsize, addresses))
    if fold and (N // 2) % vec:
        vec, band = _tile(bn, W, 1)
    return vec, band, _stats_blocks(bn, W, vec, band)


def _widest_vec(W: int, itemsize: int, addresses) -> int:
    vec = 16 // itemsize
    return 1 if W % vec or any(a % 16 for a in addresses) else vec


def fixed_stats_tile(bn: int, W: int, itemsize: int, *addresses: int):
    """(V, band, blocks) of the statistics kernel's fixed tile on a (bn,
    W) block (:func:`stats_tile`'s widest vector, STATS_ROWS_X_VEC / V
    rows): the tile it keeps wherever that gives STATS_MIN_BLOCKS blocks,
    and the one every shape took before the refinement; the private
    launches take it to time it beside the refined tile."""
    vec = _widest_vec(W, itemsize, addresses)
    band = STATS_ROWS_X_VEC // vec
    return vec, band, _stats_blocks(bn, W, vec, band)


def local_stats_grid(bn: int, W: int, N: int, row_off: int, col_off: int,
                     itemsize: int, *addresses: int):
    """(V, blocks) of the statistics kernel on a (bn, W) block at
    (row_off, col_off) of an (N, N) field (:func:`stats_tile`)."""
    vec, _, blocks = stats_tile(bn, W, N, row_off, col_off, itemsize,
                                *addresses)
    return vec, blocks


def stats_grid(N: int, itemsize: int, *addresses: int, fold: bool = False):
    """(V, blocks) of K3: the whole (N, N) field as one block
    (:func:`stats_tile`, ``fold`` its fold mode)."""
    vec, _, blocks = stats_tile(N, N, N, 0, 0, itemsize, *addresses,
                                fold=fold)
    return vec, blocks


@contextlib.contextmanager
def own_scratch(owner: dict):
    """Inside (in this thread): the tickets and the one-launch scratch
    come from ``owner``, one buffer a device and size, never replaced, in
    place of the current stream's.  Launches captured in a CUDA graph here
    hold buffers that nothing else shares while ``owner`` lives."""
    outer = getattr(_OWNER, 'scratch', None)
    _OWNER.scratch = owner
    try:
        yield
    finally:
        _OWNER.scratch = outer


def _owned(kind: str, device: torch.device, n: int, dtype):
    """``own_scratch``'s buffer of ``n`` zeros, or None outside it."""
    owner = getattr(_OWNER, 'scratch', None)
    if owner is None:
        return None
    key = (kind, device.index, n)
    if key not in owner:
        owner[key] = torch.zeros(n, dtype=dtype, device=device)
    return owner[key]


def _ticket(device: torch.device, count: int = 1) -> torch.Tensor:
    """The tickets of K3, K5 and K7 on ``device`` for the current stream
    (or ``own_scratch``'s): at least ``count`` counters (a batched K3
    takes one a member), each 0 between calls (each kernel's last block
    resets its own; kernels on one stream never overlap, and a replaced
    buffer goes back to the stream's allocator only behind the launches
    that use it)."""
    t = _owned('ticket', device, max(count, 1), torch.int32)
    if t is not None:
        return t
    key = (device.index, _stream())
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        t = _TICKETS[key] = torch.zeros(max(count, 1), dtype=torch.int32,
                                        device=device)
    return t


def stats_sums(U, EnergieEut: Optional[torch.Tensor], A0, A1, *,
               delx, RT, B, threshold, fold: bool = False):
    """K3.  ``fold``: U and EnergieEut in the level-1 folded layout
    (``fold_field``); the kernel walks the natural rows and columns and
    reads each value through the fold map, so the sums are the natural
    field's to the bit wherever N/2 allows K3's vector width (every N
    divisible by 16; else the one-column grid's order)."""
    _square(U)
    if fold and U.shape[0] % 2:
        raise ValueError(f"the folded layout needs an even N, got "
                         f"{U.shape[0]}")
    ops = (U,) if EnergieEut is None else (U, EnergieEut)
    if not _on_card(*ops):
        return stats_sums_ref(U, EnergieEut, A0, A1, delx=delx, RT=RT, B=B,
                              threshold=threshold, fold=fold)
    if EnergieEut is not None and EnergieEut.shape != U.shape:
        raise ValueError("EnergieEut and U differ in shape")
    N = U.shape[0]
    tile = stats_tile(N, N, N, 0, 0, U.element_size(),
                      *(t.data_ptr() for t in ops), fold=fold)
    return _stats_sums_launch(U, EnergieEut, A0, A1, tile, delx=delx, RT=RT,
                              B=B, threshold=threshold, fold=fold)


def _stats_sums_launch(U, EnergieEut, A0, A1, tile, *, delx, RT, B,
                       threshold, fold=False, prev=False):
    """K3's launch with ``tile`` (V, band, blocks): :func:`stats_tile`'s
    from :func:`stats_sums`, or :func:`fixed_stats_tile`'s to time it;
    ``prev``: the kernel's parent body (the true divisions, the edges
    decided per element), kept to time the body beside it (the same
    bits)."""
    N = U.shape[0]
    vec, band, nblocks = tile
    partials = torch.empty((nblocks, 5), dtype=torch.float64,
                           device=U.device)
    sums = torch.empty((5,), dtype=torch.float64, device=U.device)
    _call('ch_stats', U.dtype, U.data_ptr(),
          None if EnergieEut is None else EnergieEut.data_ptr(), N,
          float(delx), float(RT), float(B), float(A0), float(A1),
          float(threshold), partials.data_ptr(), nblocks, vec, band,
          _ticket(U.device).data_ptr(), sums.data_ptr(), int(fold),
          int(prev), _stream())
    _count(launches, 'stats_sums')
    return sums


# ----------------------------------------------------------------------
# K4: Σ|U − mean| (replaces pallas_kernels.absdev_band_sums)
# ----------------------------------------------------------------------

def absdev_sum_ref(U, mean):
    """0-d float64: Σ|U − mean| with ``mean`` a 0-d tensor of U's dtype."""
    return (U - mean).abs().to(torch.float64).sum()


def absdev_sum(U, mean):
    if mean.dim() != 0:
        raise ValueError("mean must be a 0-d tensor")
    if not _on_card(U, mean):
        return absdev_sum_ref(U, mean)
    n = U.numel()
    nblocks = int(min(ABSDEV_MAX_BLOCKS,
                      max(1, -(-n // ABSDEV_ELEMS_PER_BLOCK))))
    partials = torch.empty((nblocks,), dtype=torch.float64, device=U.device)
    out = torch.empty((), dtype=torch.float64, device=U.device)
    _call('ch_absdev', U.dtype, U.data_ptr(), n, mean.data_ptr(),
          partials.data_ptr(), nblocks, out.data_ptr(), _stream())
    _count(launches, 'absdev_sum')
    return out


# ----------------------------------------------------------------------
# K5: float64 field -> int8 slices (replaces ozaki.slice_field_pallas)
# ----------------------------------------------------------------------

MAX_SLICES = 8      # 7 payload bits each: 56 bits cover a float64's hi/lo
LO_SKIP = 3         # the lo component's first three slices are zero


def scale_from_amax(amax):
    """(scale, a float64 tensor of amax's shape; inv = 2^-e, float32, of
    shape (1,) for a 0-d amax) from max|x|: e = max(ceil(log2(amax +
    1e-30)) + 2, -90), so |x| / scale <= 1/4 and an all-zero field keeps
    a finite scale.  K5's max pass (``scale_from_max``) and K5 sharded's
    finish compute the same bits on the card."""
    e = torch.clamp(torch.ceil(torch.log2(amax + 1e-30)) + 2.0, min=-90.0)
    return torch.exp2(e), torch.exp2(-e).to(torch.float32).reshape(
        amax.shape or (1,))


def slice_scale(x):
    """The shared power-of-two scale of :func:`slice_field_ref`, on x's
    device with no host sync: :func:`scale_from_amax` of max|x|."""
    return scale_from_amax(torch.amax(torch.abs(x)))


def slice_field_ref(x, n_slices: int = MAX_SLICES, amax=None):
    """(int8 [n_slices, *x.shape], scale) with x = scale * Σ_k s_k 2^-7(k+1)
    to ~2^-48 relative (``chsimpy_tpu/ops/ozaki.py:slice_field``).
    ``amax`` (a 0-d float64 tensor, at least max|x|) sets the scale in
    place of x's own max: K5 sharded's block of a field at the field's
    scale.

    x splits into float32 hi and lo; each runs the fixed-point chain
    v <- 128 v, s = round(v) (half to even), v <- v - s in float32, which is
    exact.  The lo chain starts at slice 3: |lo| * 128^3 / scale < 1/2."""
    scale, inv = slice_scale(x) if amax is None else scale_from_amax(amax)
    inv = inv.reshape(())
    hi0 = x.to(torch.float32)
    lo0 = (x - hi0.to(x.dtype)).to(torch.float32)
    lo_skip = min(LO_SKIP, n_slices)

    def chain(v, n):
        out = []
        for _ in range(n):
            v = v * 128.0
            s = torch.round(v)
            v = v - s
            out.append(s)
        return out

    hs = chain(hi0 * inv, n_slices)
    ls = chain(lo0 * inv * float(128.0 ** lo_skip), n_slices - lo_skip)
    sl = [hs[k] if k < lo_skip else hs[k] + ls[k - lo_skip]
          for k in range(n_slices)]
    return torch.stack([s.to(torch.int8) for s in sl]), scale


def _slice_scale_launch(x):
    """K5's first launch: (scale, inv) of :func:`slice_scale`, computed on
    the card from max|x| (``slice_scale_kernel``)."""
    scale = torch.empty((), dtype=torch.float64, device=x.device)
    inv = torch.empty((1,), dtype=torch.float32, device=x.device)
    partials = torch.empty((SLICE_MAX_BLOCKS,), dtype=torch.int64,
                           device=x.device)
    _call('ch_slice_scale', x.dtype, x.data_ptr(), x.numel(),
          partials.data_ptr(), SLICE_MAX_BLOCKS,
          _ticket(x.device).data_ptr(), scale.data_ptr(), inv.data_ptr(),
          _stream())
    return scale, inv


def _slice_planes_launch(x, inv, n_slices: int):
    """K5's second launch: the int8 planes of x under ``inv``
    (``slice_kernel``)."""
    out = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.int8,
                      device=x.device)
    _call('ch_slice', x.dtype, x.data_ptr(), inv.data_ptr(), out.data_ptr(),
          x.numel(), n_slices, _stream())
    return out


def slice_one_launch(R: int, n: int) -> bool:
    """Whether K5 on R fields of n elements takes its one-launch path
    (``slice_one_launch_kernel``: max, grid barrier, slices): where the
    fields, R * n * 8 bytes, fit in SLICE_ONE_LAUNCH_BYTES, so that its
    second read of them comes from L2.  A function of the shape alone:
    the canonical R=16 N=512 batch (32 MiB), the single N=512 to 2048
    fields and R <= 24 at N=512 take it, R=4 N=4096 keeps the two
    launches."""
    return R * n * 8 <= SLICE_ONE_LAUNCH_BYTES


def _slice_scratch(device: torch.device, R: int) -> torch.Tensor:
    """The one-launch path's scratch on ``device`` for the current
    stream (or ``own_scratch``'s): the barrier's counters and R maxima, 0
    between calls (the kernel's last block resets them)."""
    t = _owned('slice', device, R + 1, torch.int64)
    if t is not None:
        return t
    key = (device.index, _stream())
    t = _SLICE_SCRATCH.get(key)
    if t is None or t.numel() < R + 1:
        t = _SLICE_SCRATCH[key] = torch.zeros(R + 1, dtype=torch.int64,
                                              device=device)
    return t


def _slice_one_launch(x, R: int, n_slices: int):
    """K5's one-launch path on R fields of x: (planes (n_slices, *x.shape),
    scales (R,) float64)."""
    scale = torch.empty((R,), dtype=torch.float64, device=x.device)
    inv = torch.empty((R,), dtype=torch.float32, device=x.device)
    out = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.int8,
                      device=x.device)
    _call('ch_slice_one_launch', x.dtype, x.data_ptr(), x.numel() // R, R,
          _slice_scratch(x.device, R).data_ptr(), scale.data_ptr(),
          inv.data_ptr(), out.data_ptr(), n_slices, _stream())
    return out, scale


def slice_field(x, n_slices: int = MAX_SLICES):
    """On the card: the scale and the planes by one launch where the
    field fits in L2 (:func:`slice_one_launch`), else by two kernel
    launches, with no torch arithmetic between them (one count a
    call; ``one_launch`` counts the first kind)."""
    _slice_args(x, n_slices, 2)
    if not _on_card(x):
        return slice_field_ref(x, n_slices)
    if slice_one_launch(1, x.numel()):
        out, scale = _slice_one_launch(x, 1, n_slices)
        scale = scale.reshape(())
        _count(one_launch, 'slice_field')
    else:
        out, scale = _slice_two_launches(x, n_slices)
    _count(launches, 'slice_field')
    return out, scale


def _slice_two_launches(x, n_slices: int):
    """K5's max and slice passes on one field: (planes, scale)."""
    scale, inv = _slice_scale_launch(x)
    return _slice_planes_launch(x, inv, n_slices), scale


def _slice_args(x, n_slices: int, dim: int) -> None:
    if x.dim() != dim or x.dtype != torch.float64 or 0 in x.shape:
        what = 'field' if dim == 2 else '(R, rows, cols) stack of fields'
        raise TypeError(f"expected a non-empty {dim}-D float64 {what}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= n_slices <= MAX_SLICES:
        raise ValueError(f"n_slices must be in [1, {MAX_SLICES}], "
                         f"got {n_slices}")


def slice_field_members_ref(x, n_slices: int = MAX_SLICES, amax=None):
    """(int8 [n_slices, R, rows, cols], (R,) float64 scales): member r's
    planes and scale are :func:`slice_field_ref` of x[r] (the JAX
    ensemble's ``vmap`` of ``slice_field``: a scale per member), at
    ``amax[r]`` where given."""
    parts = [slice_field_ref(m, n_slices, None if amax is None else amax[r])
             for r, m in enumerate(x)]
    return (torch.stack([s for s, _ in parts], dim=1),
            torch.stack([sc for _, sc in parts]))


def slice_field_members(x, n_slices: int = MAX_SLICES):
    """K5 on every member of an (R, rows, cols) float64 stack: where the
    stack fits in L2 (:func:`slice_one_launch`), one launch for all
    members; else one max pass for all members (a ticket, a scale and a
    float32 inverse each, kept on the card) and one slice pass
    (``slice_scale_kernel`` and ``slice_kernel`` with member r on grid
    row r); one count a call (``one_launch`` counts the first kind).
    Member r's planes and scale are the single launch's on x[r], to the
    bit."""
    _slice_args(x, n_slices, 3)
    if not _on_card(x):
        return slice_field_members_ref(x, n_slices)
    R = x.shape[0]
    n = x[0].numel()
    if slice_one_launch(R, n):
        out, scale = _slice_one_launch(x, R, n_slices)
        _count(one_launch, 'slice_field_members')
    else:
        out, scale = _slice_members_two_launches(x, n_slices)
    _count(launches, 'slice_field_members')
    return out, scale


def _slice_members_two_launches(x, n_slices: int):
    """K5_members' max pass for all members and its slice pass: (planes,
    scales)."""
    R = x.shape[0]
    n = x[0].numel()
    scale = torch.empty((R,), dtype=torch.float64, device=x.device)
    inv = torch.empty((R,), dtype=torch.float32, device=x.device)
    partials = torch.empty((R * SLICE_MAX_BLOCKS,), dtype=torch.int64,
                           device=x.device)
    _call('ch_slice_scale_members', x.dtype, x.data_ptr(), n, R,
          partials.data_ptr(), SLICE_MAX_BLOCKS,
          _ticket(x.device, R).data_ptr(), scale.data_ptr(), inv.data_ptr(),
          _stream())
    return _slice_members_planes_launch(x, inv, n_slices), scale


# ----------------------------------------------------------------------
# K5 sharded: K5 on a rank's block of a pencil-sharded field at the whole
# field's scale (B6 on the JAX package's sharded ozaki route, where GSPMD
# takes the max over the sharded field): the max pass's max-only mode,
# the world max of its bits (``collectives.world_max``), then the slice
# pass's sharded mode, which forms the scale from that max itself
# ----------------------------------------------------------------------

def _slice_max_launch(x, R: int):
    """K5 sharded's first launch: the max pass's max-only mode, the bits
    of max|x| of each of x's R fields ((R,) int64)."""
    partials = torch.empty((R * SLICE_SHARDED_MAX_BLOCKS,),
                           dtype=torch.int64, device=x.device)
    bits = torch.empty((R,), dtype=torch.int64, device=x.device)
    _call('ch_slice_max', x.dtype, x.data_ptr(), x.numel() // R, R,
          partials.data_ptr(), SLICE_SHARDED_MAX_BLOCKS,
          _ticket(x.device, R).data_ptr(), bits.data_ptr(), _stream())
    return bits


def _slice_sharded_planes_launch(x, bits, R: int, n_slices: int):
    """K5 sharded's slice pass on R fields of x at the scales of ``bits``
    (R world maxima, their float64 bits): (planes (n_slices, *x.shape),
    scales (R,) float64)."""
    scale = torch.empty((R,), dtype=torch.float64, device=x.device)
    out = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.int8,
                      device=x.device)
    _call('ch_slice_sharded', x.dtype, x.data_ptr(), bits.data_ptr(),
          scale.data_ptr(), out.data_ptr(), x.numel() // R, R, n_slices,
          _stream())
    return out, scale


def _slice_members_planes_launch(x, inv, n_slices: int):
    """K5_members' slice pass: x (R, rows, cols) under R inverses."""
    out = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.int8,
                      device=x.device)
    _call('ch_slice_members', x.dtype, x.data_ptr(), inv.data_ptr(),
          out.data_ptr(), x[0].numel(), x.shape[0], n_slices, _stream())
    return out


def _world_max(mesh, amax, also_max):
    """The world max of ``amax`` (R float64 values) and, in the same
    all-reduce, of ``also_max`` (float64, or None): (amax, also_max)."""
    if also_max is None:
        return coll.world_max(mesh, amax), None
    flat = also_max.reshape(-1)
    both = coll.world_max(mesh, torch.cat([amax, flat]))
    return both[:amax.numel()], both[amax.numel():].reshape(also_max.shape)


def _slice_sharded(x, n_slices: int, mesh, R: int, also_max=None,
                   amax=None):
    """The launches of K5 sharded on R fields of x: (planes, scales, the
    world max of ``also_max``).  The max pass's words are the bits of
    non-negative doubles, so their max as float64 is their max as
    integers.  With ``amax`` (the world's max, R float64 values) the max
    pass and its all-reduce are left out: one launch."""
    also = None
    if amax is None:
        bits = _slice_max_launch(x, R).view(torch.float64)
        bits, also = _world_max(mesh, bits, also_max)
    else:
        bits = amax.reshape(-1).contiguous()
    planes, scale = _slice_sharded_planes_launch(x, bits, R, n_slices)
    return planes, scale, also


def _world_amax(mesh, x, dims, also_max=None):
    """max|x| over ``dims`` of this rank's block, then over the ranks
    (with ``also_max``, :func:`_world_max`)."""
    return _world_max(mesh, torch.abs(x).amax(dim=dims).reshape(-1),
                      also_max)


def slice_field_sharded(x, mesh, n_slices: int = MAX_SLICES, also_max=None,
                        amax=None):
    """K5 sharded on this rank's block ``x`` of a field over the grid
    ``mesh`` (a collective: every rank calls it): the planes of the block
    and the scale, 0-d, each the whole field's K5 result to the bit.  On
    the card two launches and one all-reduce MAX (one count a call).
    ``also_max`` (float64 on x's device) rides the same all-reduce: its
    world max comes back third.  ``amax``: the whole field's max|x| (0-d
    float64, the same on every rank), given by the caller, who took it
    in a collective of its own; then the call has no collective and no
    max pass (one launch)."""
    _slice_args(x, n_slices, 2)
    if amax is not None and also_max is not None:
        raise ValueError("also_max rides K5's own all-reduce, which a "
                         "given amax leaves out")
    if not _on_card(x):
        if amax is None:
            amax, also = _world_amax(mesh, x, (0, 1), also_max)
        out, scale = slice_field_ref(x, n_slices, amax.reshape(()))
    else:
        out, scale, also = _slice_sharded(x, n_slices, mesh, 1, also_max,
                                          amax)
        scale = scale.reshape(())
        _count(launches, 'slice_field_sharded')
    return (out, scale) if also_max is None else (out, scale, also)


def slice_field_members_sharded(x, mesh, n_slices: int = MAX_SLICES,
                                also_max=None, amax=None):
    """K5 sharded on every member's block of an (R, rows, cols) stack:
    (planes (n_slices, R, rows, cols), (R,) scales), member r's the
    whole field's K5 result on its block; one world max for all members
    (one count a call); ``also_max`` and ``amax`` ((R,)) as in
    :func:`slice_field_sharded`."""
    _slice_args(x, n_slices, 3)
    if amax is not None and also_max is not None:
        raise ValueError("also_max rides K5's own all-reduce, which a "
                         "given amax leaves out")
    if not _on_card(x):
        if amax is None:
            amax, also = _world_amax(mesh, x, (1, 2), also_max)
        out, scale = slice_field_members_ref(x, n_slices, amax)
    else:
        out, scale, also = _slice_sharded(x, n_slices, mesh, x.shape[0],
                                          also_max, amax)
        _count(launches, 'slice_field_members_sharded')
    return (out, scale) if also_max is None else (out, scale, also)


# ----------------------------------------------------------------------
# K6: float32 GEMM (replaces pallas_kernels.matmul, dct2_pallas and
# idct2_pallas): 3xTF32 on the tensor cores (csrc/gemm_sm90.cu)
# ----------------------------------------------------------------------

def matmul_ref(A, B):
    """A @ B in full float32 (TF32 off for the call, as the TPU kernel
    contracts at ``Precision.HIGHEST``).  The kernel computes the same
    product in three TF32 passes (hi/lo operand split), in the float32
    class: within 4x this version's error against float64.  Either
    operand may carry a member axis (R, ., .)."""
    cuda_mm = torch.backends.cuda.matmul
    prev = cuda_mm.allow_tf32
    cuda_mm.allow_tf32 = False
    try:
        return torch.matmul(A, B)
    finally:
        cuda_mm.allow_tf32 = prev


def _gemm_operand(X: torch.Tensor):
    """(transposed, leading dimension) of a 2-D operand stored row-major,
    or as the transpose of a row-major matrix (a ``.T`` view); raises on
    any other layout."""
    r, c = X.shape
    s0, s1 = X.stride()
    if s1 == 1 or c == 1:
        if s0 >= c or r == 1:
            return 0, max(s0, c)
    if s0 == 1 or r == 1:
        if s1 >= r or c == 1:
            return 1, max(s1, r)
    raise ValueError(f"matmul takes row-major operands or their "
                     f"transposes, got strides {X.stride()}")


def _batch(X: torch.Tensor):
    """(members, member stride, one member's 2-D view) of an operand:
    a 2-D matrix is shared by every member (stride 0)."""
    if X.dim() == 2:
        return 1, 0, X
    return X.shape[0], X.stride(0) if X.shape[0] > 1 else 0, X[0]


def matmul(A, B):
    """A @ B for float32 (M, K) and (K, N); either operand may be the
    ``.T`` view of a row-major matrix, and either may carry a member axis
    (R, M, K) / (R, K, N) with any member stride (a 2-D operand is shared
    by every member: split once, read by all), giving (R, M, N).  On the
    card the kernel first writes hi/lo TF32 copies of the operands, K-major
    and tiled, into a scratch buffer allocated here; one launch does every
    member."""
    if not (A.dim() in (2, 3) and B.dim() in (2, 3)) \
            or A.shape[-1] != B.shape[-2] or 0 in A.shape + B.shape \
            or (A.dim() == B.dim() == 3 and A.shape[0] != B.shape[0]):
        raise ValueError(f"matmul takes non-empty [R,] (M, K) @ [R,] (K, N),"
                         f" got {tuple(A.shape)} @ {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError(f"matmul inputs on different devices: "
                         f"{A.device} vs {B.device}")
    if A.dtype != B.dtype:
        raise TypeError(f"matmul inputs of different types: "
                        f"{A.dtype} vs {B.dtype}")
    if A.device.type == 'cpu':
        return matmul_ref(A, B)
    if A.device.type != 'cuda':
        raise ValueError(f"no kernel for device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"the matmul kernel takes float32, got {A.dtype}")
    if A.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {A.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    (M, Kd), N = A.shape[-2:], B.shape[-1]
    ra, sa, A2 = _batch(A)
    rb, sb, B2 = _batch(B)
    R = max(ra, rb)
    shape = (M, N) if A.dim() == B.dim() == 2 else (R, M, N)
    out = torch.empty(shape, dtype=A.dtype, device=A.device)
    ta, lda = _gemm_operand(A2)
    tb, ldb = _gemm_operand(B2)
    from .cuda_build import load_library
    ws = torch.empty((load_library().ch_matmul_workspace_f32(
        M, N, Kd, R if sa else 1, R if sb else 1),), dtype=torch.float32,
        device=A.device)
    _call('ch_matmul', A.dtype, A.data_ptr(), ta, lda, sa, B.data_ptr(), tb,
          ldb, sb, out.data_ptr(), N, M, N, Kd, R, ws.data_ptr(), _stream())
    _count(launches, 'matmul')
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (PTX ``cvt.rna.tf32.f32``, K6's split)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(A, B):
    """A @ B in one TF32 pass: on the card cuBLAS with TF32 on for this
    call only (the global switch stays off); on the CPU the float32
    product of the operands rounded to TF32 (:func:`tf32_round`), so CPU
    runs see the card's class of error.  cuBLAS may round its operands to
    TF32 in another mode: the card's products agree with this version
    within the error of one TF32 rounding of each operand."""
    if A.device.type == 'cpu':
        return torch.matmul(tf32_round(A), tf32_round(B))
    cuda_mm = torch.backends.cuda.matmul
    prev = cuda_mm.allow_tf32
    cuda_mm.allow_tf32 = True
    try:
        return torch.matmul(A, B)
    finally:
        cuda_mm.allow_tf32 = prev


def dct2_gemm(U, C):
    """2-D DCT-II C @ U @ C^T through :func:`matmul` (twin of
    ``dct2_pallas``; C^T is a view)."""
    return matmul(matmul(C, U), C.T)


def idct2_gemm(X, C):
    """2-D DCT-III C^T @ X @ C through :func:`matmul` (twin of
    ``idct2_pallas``)."""
    return matmul(matmul(C.T, X), C)


# ----------------------------------------------------------------------
# K7: shard-local field sums with halo vectors (replaces
# pallas_kernels._local_band_sums under fused_stats_sharded), and K8: the
# chemical potential of one block (replaces chemical_potential_sharded)
# ----------------------------------------------------------------------

def _halo_extended(Ub, up_row, dn_row, lf_col, rt_col):
    """(rows r-1, rows r+1, cols c-1, cols c+1) of the block as (bn, W)
    views built from the block and its four halo vectors — what the TPU
    kernel's caller builds with ``_neighbor_views``.  A member stack (R,
    bn, W) takes (R, W) rows and (R, bn) columns."""
    up = torch.cat([up_row.unsqueeze(-2), Ub[..., :-1, :]], dim=-2)
    dn = torch.cat([Ub[..., 1:, :], dn_row.unsqueeze(-2)], dim=-2)
    lf = torch.cat([lf_col.unsqueeze(-1), Ub[..., :, :-1]], dim=-1)
    rt = torch.cat([Ub[..., :, 1:], rt_col.unsqueeze(-1)], dim=-1)
    return up, dn, lf, rt


def _local_sums(Ub, up_row, dn_row, lf_col, rt_col, Eb, A0, A1,
                row_off: int, col_off: int, N, delx, RT, B, threshold):
    """The five sums of each block of ``Ub`` (2-D: (5,); a member stack:
    (R, 5)), A0 and A1 already in the field type (floats, or (R, 1, 1)
    tensors)."""
    f64 = torch.float64
    bn, W = Ub.shape[-2:]
    dims = (-2, -1)
    up, dn, lf, rt = _halo_extended(Ub, up_row, dn_row, lf_col, rt_col)
    dev = Ub.device
    rows = (torch.arange(bn, device=dev) + row_off).reshape(-1, 1)
    cols = (torch.arange(W, device=dev) + col_off).reshape(1, -1)
    dux = torch.where(rows == 0, (dn - Ub) / delx,
                      torch.where(rows == N - 1, (Ub - up) / delx,
                                  (dn - up) / (2.0 * delx)))
    duy = torch.where(cols == 0, (rt - Ub) / delx,
                      torch.where(cols == N - 1, (Ub - lf) / delx,
                                  (rt - lf) / (2.0 * delx)))
    du2 = dux * dux + duy * duy
    Uinv = 1.0 - Ub
    integrand = (RT * (Ub * (torch.log(Ub) - B) + Uinv * torch.log(Uinv))
                 + (A0 + A1 * (Uinv - Ub)) * Ub * Uinv)
    if Eb is None:
        s_e2 = torch.zeros(Ub.shape[:-2], dtype=f64, device=dev)
    else:
        s_e2 = (Eb * Eb).to(f64).sum(dims)
    return torch.stack([integrand.to(f64).sum(dims), du2.to(f64).sum(dims),
                        Ub.to(f64).sum(dims),
                        (Ub < threshold).to(f64).sum(dims), s_e2], dim=-1)


def local_band_sums_ref(Ub, up_row, dn_row, lf_col, rt_col,
                        Eb: Optional[torch.Tensor], A0, A1, row_off: int,
                        col_off: int, *, N, delx, RT, B, threshold):
    """(5,) float64: the sums of :func:`stats_sums_ref` over one block of
    an (N, N) field, the block's rows starting at global row ``row_off``
    and its columns at ``col_off``.  The np.gradient stencil reads the
    halo vectors across the block's edges and keys its one-sided
    differences on the GLOBAL row and column (``_stats_band_kernel_sh``)."""
    return _local_sums(Ub, up_row, dn_row, lf_col, rt_col, Eb,
                       _cast(A0, Ub.dtype), _cast(A1, Ub.dtype), row_off,
                       col_off, N, delx, RT, B, threshold)


def local_band_sums(Ub, up_row, dn_row, lf_col, rt_col,
                    Eb: Optional[torch.Tensor], A0, A1, row_off: int,
                    col_off: int, *, N, delx, RT, B, threshold):
    """K7: :func:`local_band_sums_ref` on the card, K3's kernel on the
    block.  The kernel reads the halo vectors where a stencil crosses the
    block's edge; no shifted copy of the block is made."""
    _block(Ub)
    bn, W = Ub.shape
    for name, v, n in (('up_row', up_row, W), ('dn_row', dn_row, W),
                       ('lf_col', lf_col, bn), ('rt_col', rt_col, bn)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(v.shape)}")
    _check_block(bn, W, N, row_off, col_off)
    ops = (Ub, up_row, dn_row, lf_col, rt_col)
    if Eb is not None:
        if Eb.shape != Ub.shape:
            raise ValueError("Eb and Ub differ in shape")
        ops += (Eb,)
    if not _on_card(*ops):
        return local_band_sums_ref(Ub, up_row, dn_row, lf_col, rt_col, Eb,
                                   A0, A1, row_off, col_off, N=N, delx=delx,
                                   RT=RT, B=B, threshold=threshold)
    rows = (Ub, up_row, dn_row) + (() if Eb is None else (Eb,))
    tile = stats_tile(bn, W, N, row_off, col_off, Ub.element_size(),
                      *(t.data_ptr() for t in rows))
    return _local_band_sums_launch(Ub, up_row, dn_row, lf_col, rt_col, Eb,
                                   A0, A1, row_off, col_off, tile, N=N,
                                   delx=delx, RT=RT, B=B,
                                   threshold=threshold)


def _local_band_sums_launch(Ub, up_row, dn_row, lf_col, rt_col, Eb, A0, A1,
                            row_off, col_off, tile, *, N, delx, RT, B,
                            threshold, prev=False):
    """K7's launch with ``tile`` (as :func:`_stats_sums_launch`)."""
    bn, W = Ub.shape
    vec, band, nblocks = tile
    partials = torch.empty((nblocks, 5), dtype=torch.float64,
                           device=Ub.device)
    sums = torch.empty((5,), dtype=torch.float64, device=Ub.device)
    _call('ch_local_stats', Ub.dtype, Ub.data_ptr(), up_row.data_ptr(),
          dn_row.data_ptr(), lf_col.data_ptr(), rt_col.data_ptr(),
          None if Eb is None else Eb.data_ptr(), bn, W, N, int(row_off),
          int(col_off), float(delx), float(RT), float(B), float(A0),
          float(A1), float(threshold), partials.data_ptr(), nblocks, vec,
          band, _ticket(Ub.device).data_ptr(), sums.data_ptr(), int(prev),
          _stream())
    _count(launches, 'local_band_sums')
    return sums


def fused_stats_sharded(mesh, Ub, Eb: Optional[torch.Tensor], A0, A1,
                        kappa_tilde, *, delx, RT, B, Amr, L, threshold):
    """(E, E2, PS, L2, Ra, SA), 0-d float64 tensors, the same bits on
    every rank, from this rank's block ``Ub`` (and ``Eb``; None on the
    prepare path gives L2 = 0) of an (N, N) field on a grid mesh.  The
    counterpart of ``pallas_kernels.fused_stats_sharded``: halo exchange,
    K7 on the block, the partials of every rank added in rank order, the
    float64 finalization, then K4 on the block with the global mean.  Ra
    reads the mid row N//2+1, gathered from its x-shard: the formula of
    the single-device ``_stats``."""
    mx, my = mesh.shape
    bn, W = Ub.shape
    N = bn * mx
    if W * my != N:
        raise ValueError(f"block {bn}x{W} does not tile an (N, N) field "
                         f"on a {mx}x{my} mesh")
    i, j = mesh.coords
    f64 = torch.float64
    n2 = float(N * N)
    Lsq = L ** 2
    up, dn, lf, rt = coll.halo(mesh, Ub)
    part = local_band_sums(Ub, up, dn, lf, rt, Eb, A0, A1, i * bn, j * W,
                           N=N, delx=delx, RT=RT, B=B, threshold=threshold)
    # the mid row's segment travels with the partials (float64 holds a
    # float32 exactly); ranks off the row send zeros
    mid_row = N // 2 + 1
    owner = mid_row // bn
    if i == owner:
        seg = Ub[mid_row - owner * bn].to(f64)
    else:
        seg = torch.zeros((W,), dtype=f64, device=Ub.device)
    g = coll.gather_world(mesh, torch.cat([part, seg]))     # (D, 5 + W)
    tot = coll.rank_sum(g[:, :5])
    mid = g[owner * my:(owner + 1) * my, 5:].reshape(N).to(Ub.dtype)
    E2 = 0.5 * Amr * kappa_tilde * Lsq * (tot[1] / n2)
    E = Amr * Lsq * (tot[0] / n2) + E2
    SA = tot[3] / n2
    L2 = torch.sqrt(tot[4]) / n2
    meanU = (tot[2] / n2).to(Ub.dtype)
    ps = absdev_sum(Ub, meanU)
    PS = coll.rank_sum(coll.gather_world(mesh, ps.reshape(1)))[0] / n2
    Ra = torch.mean(torch.abs(mid - torch.mean(mid))).to(f64)
    return E, E2, PS, L2, Ra, SA


def chemical_potential_sharded(mesh, Ub, RT, BRT, A0, A1):
    """K8: the chemical potential of this rank's block.  Pointwise, so no
    halo and no collective (``mesh`` is kept for the JAX signature): the
    TPU version runs K1's ``pallas_call`` per shard under ``shard_map``,
    and this wrapper launches K1's ``mu_kernel`` on the block."""
    del mesh
    _block(Ub)
    if not _on_card(Ub):
        return chemical_potential_ref(Ub, RT, BRT, A0, A1)
    out = _launch_mu(Ub, RT, BRT, A0, A1)
    _count(launches, 'chemical_potential_sharded')
    return out


# ----------------------------------------------------------------------
# K7_members: K7 on the members' blocks of a grid ensemble (B7 under the
# JAX ensemble's vmap), and the ensemble's fused_stats_sharded
# ----------------------------------------------------------------------

def _member_blocks(U: torch.Tensor) -> int:
    """R of an (R, bh, bw) stack of members' fields or blocks; raises
    otherwise."""
    if U.dim() != 3 or 0 in U.shape:
        raise ValueError(f"expected an (R, N, N) stack of members' fields "
                         f"or an (R, bh, bw) stack of their blocks, got "
                         f"{tuple(U.shape)}")
    return U.shape[0]


def local_band_sums_members_ref(Ub, up_row, dn_row, lf_col, rt_col,
                                Eb: Optional[torch.Tensor], A0s, A1s,
                                row_off: int, col_off: int, *, N, delx, RT,
                                B, threshold):
    """(R, 5) float64: :func:`local_band_sums_ref` of each member's block
    ``Ub[r]`` with its halo vectors ``up_row[r]``, ... and its A0s[r],
    A1s[r]; every block at the same (row_off, col_off)."""
    return _local_sums(Ub, up_row, dn_row, lf_col, rt_col, Eb,
                       _per_member(A0s, Ub.dtype), _per_member(A1s, Ub.dtype),
                       row_off, col_off, N, delx, RT, B, threshold)


def local_band_sums_members(Ub, up_row, dn_row, lf_col, rt_col,
                            Eb: Optional[torch.Tensor], A0s, A1s,
                            row_off: int, col_off: int, *, N, delx, RT, B,
                            threshold):
    """K7_members: K7 on every member's block in one launch (member r on
    grid layer r, the grid of one K7 launch on an (bn, W) block: member r
    gives the single launch's bits on its block, halo and scalars), its
    own ticket and fixed-order finish.  Where W allows the vector, each
    member's block and halo rows start a multiple of 16 bytes after the
    first (W * itemsize is), so the stack takes a fresh block's width."""
    R = _member_blocks(Ub)
    _, bn, W = Ub.shape
    _member_vector('A0s', A0s, R, Ub, torch.float64)
    _member_vector('A1s', A1s, R, Ub, torch.float64)
    for name, v, n in (('up_row', up_row, W), ('dn_row', dn_row, W),
                       ('lf_col', lf_col, bn), ('rt_col', rt_col, bn)):
        if tuple(v.shape) != (R, n):
            raise ValueError(f"{name} must have shape ({R}, {n}), got "
                             f"{tuple(v.shape)}")
    _check_block(bn, W, N, row_off, col_off)
    ops = (Ub, up_row, dn_row, lf_col, rt_col)
    if Eb is not None:
        if Eb.shape != Ub.shape:
            raise ValueError("Eb and Ub differ in shape")
        ops += (Eb,)
    if not _on_card(*ops):
        return local_band_sums_members_ref(
            Ub, up_row, dn_row, lf_col, rt_col, Eb, A0s, A1s, row_off,
            col_off, N=N, delx=delx, RT=RT, B=B, threshold=threshold)
    rows = (Ub, up_row, dn_row) + (() if Eb is None else (Eb,))
    tile = stats_tile(bn, W, N, row_off, col_off, Ub.element_size(),
                      *(t.data_ptr() for t in rows))
    return _local_band_sums_members_launch(
        Ub, up_row, dn_row, lf_col, rt_col, Eb, A0s, A1s, row_off, col_off,
        tile, N=N, delx=delx, RT=RT, B=B, threshold=threshold)


def _local_band_sums_members_launch(Ub, up_row, dn_row, lf_col, rt_col, Eb,
                                    A0s, A1s, row_off, col_off, tile, *, N,
                                    delx, RT, B, threshold, prev=False):
    """K7_members' launch with ``tile`` (as :func:`_stats_sums_launch`)."""
    R, bn, W = Ub.shape
    vec, band, nblocks = tile
    partials = torch.empty((R * nblocks, 5), dtype=torch.float64,
                           device=Ub.device)
    sums = torch.empty((R, 5), dtype=torch.float64, device=Ub.device)
    _call('ch_local_stats_members', Ub.dtype, Ub.data_ptr(),
          up_row.data_ptr(), dn_row.data_ptr(), lf_col.data_ptr(),
          rt_col.data_ptr(), None if Eb is None else Eb.data_ptr(), bn, W, N,
          R, int(row_off), int(col_off), float(delx), float(RT), float(B),
          A0s.data_ptr(), A1s.data_ptr(), float(threshold),
          partials.data_ptr(), nblocks, vec, band,
          _ticket(Ub.device, R).data_ptr(), sums.data_ptr(), int(prev),
          _stream())
    _count(launches, 'local_band_sums_members')
    return sums


def fused_stats_sharded_members(mesh, Ub, Eb: Optional[torch.Tensor], A0s,
                                A1s, kappas, *, delx, RT, B, Amr, L,
                                threshold):
    """(E, E2, PS, L2, Ra, SA), each an (R,) float64 tensor with the same
    bits on every rank of the grid, from this rank's blocks ``Ub`` (R, bn,
    W) of the members' fields (and ``Eb``; None: L2 = 0).  The member
    axis of :func:`fused_stats_sharded`: one halo exchange of every
    member's edges, K7_members on the blocks, one world gather of the R x
    (5 + W) partials and mid-row segments, rank-order sums per member,
    the float64 finish per member (``kappas`` (R,) float64), then
    K4_members on the blocks with each member's global mean, each
    member's Ra from the gathered mid row in its second pass."""
    mx, my = mesh.shape
    R, bn, W = Ub.shape
    N = bn * mx
    if W * my != N:
        raise ValueError(f"blocks {bn}x{W} do not tile an (N, N) field on "
                         f"a {mx}x{my} mesh")
    i, j = mesh.coords
    f64 = torch.float64
    n2 = float(N * N)
    Lsq = L ** 2
    up, dn, lf, rt = coll.halo(mesh, Ub)
    part = local_band_sums_members(Ub, up, dn, lf, rt, Eb, A0s, A1s, i * bn,
                                   j * W, N=N, delx=delx, RT=RT, B=B,
                                   threshold=threshold)
    mid_row = N // 2 + 1
    owner = mid_row // bn
    if i == owner:
        seg = Ub[:, mid_row - owner * bn].to(f64)
    else:
        seg = torch.zeros((R, W), dtype=f64, device=Ub.device)
    g = coll.gather_world(mesh, torch.cat([part, seg], dim=1))  # (D, R, 5+W)
    tot = coll.rank_sum(g[:, :, :5])                            # (R, 5)
    mid = (g[owner * my:(owner + 1) * my, :, 5:].transpose(0, 1)
           .reshape(R, 1, N).to(Ub.dtype))
    E2 = 0.5 * Amr * kappas * Lsq * (tot[:, 1] / n2)
    E = Amr * Lsq * (tot[:, 0] / n2) + E2
    SA = tot[:, 3] / n2
    L2 = torch.sqrt(tot[:, 4]) / n2
    meanU = (tot[:, 2] / n2).to(Ub.dtype)
    ps, Ra = absdev_ra_members(Ub, meanU, mid, 0)
    PS = coll.rank_sum(coll.gather_world(mesh, ps)) / n2
    return E, E2, PS, L2, Ra, SA


# ----------------------------------------------------------------------
# K11: each member's Ra (no Pallas counterpart: jnp.mean twice on the mid
# row in the JAX step's _stats, chsimpy_tpu/core/stepper.py:473)
# ----------------------------------------------------------------------

def row_absdev_members_ref(U, row: int):
    """(R,) float64: mean|U[r, row] - mean(U[r, row])| of each member, in
    U's dtype (the JAX step's Ra under ``vmap``)."""
    mid = U[:, row, :]
    return torch.mean(torch.abs(mid - torch.mean(mid, dim=-1, keepdim=True)),
                      dim=-1).to(torch.float64)


def row_absdev_members(U, row: int):
    """K11: :func:`row_absdev_members_ref` on the card in one launch, one
    block a member reading its row in place: the sums in float64, the
    mean rounded to U's dtype, in an order fixed by the row's length, so
    member r's bits do not depend on how many members the launch holds (a
    torch reduction over an (R, W) tensor's rows does: its grid depends
    on R).  U is (R, H, W): the members' fields, or their mid rows (R, 1,
    W)."""
    R = _member_blocks(U)
    _, H, W = U.shape
    if not 0 <= row < H:
        raise ValueError(f"row {row} is not in [0, {H})")
    if not _on_card(U):
        return row_absdev_members_ref(U, row)
    out = torch.empty((R,), dtype=torch.float64, device=U.device)
    _call('ch_row_absdev_members', U.dtype, U.data_ptr(), R, H * W, row * W,
          W, out.data_ptr(), _stream())
    _count(launches, 'row_absdev_members')
    return out


# ----------------------------------------------------------------------
# K9: per-step Sobol jitter (no Pallas counterpart; the JAX package's
# XLA-fused ops/sobol.py:46 sobol_points added in core/stepper.py:734-748)
# ----------------------------------------------------------------------

def sobol_jitter_ref(U, sv, shift, base, jitter, row_off: int = 0,
                     col_off: int = 0):
    """U += jitter * (2 r - 1) in place and returns U, where r[i, j] is
    point ``base + row_off + i`` (mod 2^32), dimension ``col_off + j`` of
    the scrambled Sobol sequence (:func:`~.sobol.sobol_points_ref`), cast
    to U's type; ``jitter`` is rounded to U's type, as the JAX step's
    Python scalar is."""
    bn, W = U.shape
    r = sobol_points_ref(sv[col_off:col_off + W], shift[col_off:col_off + W],
                         base + row_off, bn).to(U.dtype)
    U += jitter * (2.0 * r - 1.0)
    return U


def sobol_jitter(U, sv, shift, base, jitter, row_off: int = 0,
                 col_off: int = 0):
    """K9: :func:`sobol_jitter_ref` on the card, in place, with ``base``
    (a 0-d int64 tensor) read by the kernel from device memory.  ``sv``
    (d, 30) and ``shift`` (d,) are int64 tables (``sobol.sobol_tables``);
    U is a (bn, W) block whose columns are dimensions col_off.. of them."""
    _block(U)
    bn, W = U.shape
    if sv.dim() != 2 or sv.shape[1] != SOBOL_BITS \
            or tuple(shift.shape) != (sv.shape[0],) or base.dim() != 0:
        raise ValueError(f"sobol_jitter takes sv (d, {SOBOL_BITS}), shift "
                         f"(d,) and a 0-d base, got {tuple(sv.shape)}, "
                         f"{tuple(shift.shape)}, {tuple(base.shape)}")
    if not (0 <= row_off and 0 <= col_off and col_off + W <= sv.shape[0]):
        raise ValueError(f"a ({bn}, {W}) block at ({row_off}, {col_off}) "
                         f"does not lie in {sv.shape[0]} dimensions")
    for name, t in (('sv', sv), ('shift', shift), ('base', base)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.device != U.device:
            raise ValueError(f"{name} on {t.device}, U on {U.device}")
    if not _on_card(U):
        return sobol_jitter_ref(U, sv, shift, base, jitter, row_off, col_off)
    if not (sv.is_contiguous() and shift.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    _call('ch_sobol_jitter', U.dtype, U.data_ptr(), bn, W, sv.data_ptr(),
          shift.data_ptr(), base.data_ptr(), int(row_off), int(col_off),
          float(jitter), _stream())
    _count(launches, 'sobol_jitter')
    return U


# ----------------------------------------------------------------------
# K10: the device jitter's threefry stream (no Pallas counterpart; the JAX
# step draws it with jax.random.split and jax.random.uniform,
# chsimpy_tpu/core/stepper.py:750-751).  A key is two uint32 words held in
# an int64 tensor of shape (2,); every word is masked to 32 bits after each
# add and shift (torch's uint32 arithmetic is partial), as ops/sobol.py
# does.  JAX's defaults (jax_threefry_partitionable): the counter of
# element i of a flat draw is the pair (i >> 32, i & 0xFFFFFFFF).
# ----------------------------------------------------------------------

THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
THREEFRY_PARITY = 0x1BD11BDA


def threefry2x32_ref(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11; JAX's
    ``threefry2x32``): the hash of the counter pairs (x0, x1) under the key
    (k0, k1), int64 tensors holding uint32 words, broadcast together."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ THREEFRY_PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def threefry_split_ref(key):
    """``jax.random.split(key)`` as (next key, subkey): the hashes of the
    counters (0, 0) and (0, 1)."""
    ctr = torch.arange(2, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32_ref(key[0], key[1], torch.zeros_like(ctr), ctr)
    return torch.stack([b0[0], b1[0]]), torch.stack([b0[1], b1[1]])


def threefry_uniform_ref(sub, N: int, dtype, row_off: int = 0,
                         col_off: int = 0, bn: Optional[int] = None,
                         W: Optional[int] = None):
    """The (bn, W) block at (row_off, col_off) of
    ``jax.random.uniform(sub, (N, N), dtype)``: element (i, j) hashes the
    counter of its flat index i·N + j; float32 keeps the top 23 bits of
    bits1 ^ bits2, float64 the top 52 of (bits1 << 32) | bits2, as the
    mantissa of a number in [1, 2), minus 1."""
    bn = N if bn is None else bn
    W = N if W is None else W
    dev = sub.device
    i = torch.arange(row_off, row_off + bn, dtype=torch.int64, device=dev)
    j = torch.arange(col_off, col_off + W, dtype=torch.int64, device=dev)
    idx = i[:, None] * N + j[None, :]
    b0, b1 = threefry2x32_ref(sub[0], sub[1], idx >> 32, idx & MASK32)
    if dtype == torch.float32:
        m = ((b0 ^ b1) >> 9) | 0x3F800000
        return m.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        m = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return m.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, got {dtype}")


def threefry_jitter_ref(U, key, key_out, jitter, N: int, row_off: int = 0,
                        col_off: int = 0, go=None):
    """One step of the ``device`` jitter: ``key, sub = split(key)``, then
    U += jitter·(2r − 1) in place with r the (row_off, col_off) block of
    ``uniform(sub, (N, N))`` in U's type (``jitter`` rounded to U's type,
    as the JAX step's Python scalar is).  The next key goes into
    ``key_out``, or the key itself where the 0-d bool ``go`` is false (a
    step that is thrown away draws nothing).  Returns U."""
    nxt, sub = threefry_split_ref(key)
    bn, W = U.shape
    r = threefry_uniform_ref(sub, N, U.dtype, row_off, col_off, bn, W)
    U += jitter * (2.0 * r - 1.0)
    key_out.copy_(nxt if go is None else torch.where(go, nxt, key))
    return U


def threefry_jitter(U, key, key_out, jitter, N: int, row_off: int = 0,
                    col_off: int = 0, go=None):
    """K10: :func:`threefry_jitter_ref` on the card, in place on U, with
    the key read from device memory and the next key written to
    ``key_out``, a buffer other than ``key`` (no thread reads a key that
    another writes); ``go``, a 0-d bool on the card, is read there too: no
    host sync.  U is a (bn, W) block of an (N, N) field."""
    _block(U)
    bn, W = U.shape
    if not (0 <= row_off and 0 <= col_off and row_off + bn <= N
            and col_off + W <= N):
        raise ValueError(f"a ({bn}, {W}) block at ({row_off}, {col_off}) "
                         f"does not lie in an ({N}, {N}) field")
    for name, t in (('key', key), ('key_out', key_out)):
        if tuple(t.shape) != (2,) or t.dtype != torch.int64:
            raise ValueError(f"{name} must be a (2,) int64 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != U.device:
            raise ValueError(f"{name} on {t.device}, U on {U.device}")
    if go is not None and (go.dim() != 0 or go.dtype != torch.bool
                           or go.device != U.device):
        raise ValueError("go must be a 0-d bool tensor on U's device")
    if key_out.data_ptr() == key.data_ptr():
        raise ValueError("key_out must be another buffer than key")
    if not _on_card(U):
        return threefry_jitter_ref(U, key, key_out, jitter, N, row_off,
                                   col_off, go)
    if not (key.is_contiguous() and key_out.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    _call('ch_threefry_jitter', U.dtype, U.data_ptr(), bn, W, int(N),
          int(row_off), int(col_off), key.data_ptr(), key_out.data_ptr(),
          0 if go is None else go.data_ptr(), float(jitter), _stream())
    _count(launches, 'threefry_jitter')
    return U


# ----------------------------------------------------------------------
# K1-K4 member-batched (the ensemble's B1-B4 under vmap): one launch for
# the R fields of an (R, N, N) stack
# ----------------------------------------------------------------------

def _members(U: torch.Tensor) -> int:
    """R of an (R, N, N) stack of fields (N >= 2); raises otherwise."""
    if U.dim() != 3 or U.shape[0] < 1 or U.shape[1] != U.shape[2] \
            or U.shape[1] < 2:
        raise ValueError(f"expected an (R, N, N) stack of fields with "
                         f"N >= 2, got {tuple(U.shape)}")
    return U.shape[0]


def _member_vector(name: str, v: torch.Tensor, R: int, U: torch.Tensor,
                   dtype: torch.dtype) -> None:
    """``v`` must be an (R,) tensor of ``dtype`` on U's device."""
    if tuple(v.shape) != (R,) or v.dtype != dtype:
        raise ValueError(f"{name} must be an ({R},) {dtype} tensor, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if v.device != U.device:
        raise ValueError(f"{name} on {v.device}, the fields on {U.device}")
    if U.device.type == 'cuda' and not v.is_contiguous():
        raise ValueError("the kernels take contiguous tensors")


def _per_member(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An (R,) float64 vector cast to the field type, shaped to broadcast
    over (R, N, N): each member's scalar as ``_cast`` rounds it."""
    return v.to(dtype).reshape(-1, 1, 1)


def chemical_potential_members_ref(U, RT, BRT, A0s, A1s):
    """:func:`chemical_potential_ref` of each field of U (R, N, N) with
    its member's A0s[r], A1s[r] ((R,) float64)."""
    A0 = _per_member(A0s, U.dtype)
    A1 = _per_member(A1s, U.dtype)
    Uinv = 1.0 - U
    U1Uinv = U / Uinv
    U2inv = Uinv - U
    return (RT * torch.log(U1Uinv) - BRT
            + (A0 + A1 * U2inv) * U2inv
            - 2.0 * A1 * U * Uinv)


def chemical_potential_members(U, RT, BRT, A0s, A1s):
    """K1 on every field of U in one launch (``mu_kernel``, member r on
    grid row r), A0s/A1s read on the card.  Pointwise, so U may be the
    members' blocks of a grid ensemble (R, bh, bw): K8 under the member
    axis."""
    R = _member_blocks(U)
    _member_vector('A0s', A0s, R, U, torch.float64)
    _member_vector('A1s', A1s, R, U, torch.float64)
    if not _on_card(U):
        return chemical_potential_members_ref(U, RT, BRT, A0s, A1s)
    out = torch.empty_like(U)
    _call('ch_mu_members', U.dtype, U.data_ptr(), out.data_ptr(),
          U.shape[1] * U.shape[2], R,
          float(RT), float(BRT), A0s.data_ptr(), A1s.data_ptr(), _stream())
    _count(launches, 'chemical_potential_members')
    return out


def spectral_update_members_ref(hat_U, hat_E, Seig, CHeig):
    """:func:`spectral_update_ref` of each member; Seig and CHeig are
    (R, N, N) or one (N, N) grid for all members."""
    return (hat_U + Seig * hat_E) / CHeig


def spectral_update_members(hat_U, hat_E, Seig, CHeig):
    """K2 on every member in one launch; a shared (N, N) Seig or CHeig is
    read by every member (stride 0), not copied.  The members' blocks of
    a grid ensemble (R, bh, bw) take the grids' blocks."""
    R = _member_blocks(hat_U)
    shape = tuple(hat_U.shape[1:])
    if hat_E.shape != hat_U.shape:
        raise ValueError("hat_E and hat_U differ in shape")
    flags = []
    for name, g in (('Seig', Seig), ('CHeig', CHeig)):
        if tuple(g.shape) == (R,) + shape:
            flags.append(1)
        elif tuple(g.shape) == shape:
            flags.append(0)
        else:
            raise ValueError(f"{name} must be {(R,) + shape} or {shape}, "
                             f"got {tuple(g.shape)}")
    if not _on_card(hat_U, hat_E, Seig, CHeig):
        return spectral_update_members_ref(hat_U, hat_E, Seig, CHeig)
    out = torch.empty_like(hat_U)
    _call('ch_update_members', hat_U.dtype, hat_U.data_ptr(),
          hat_E.data_ptr(), Seig.data_ptr(), CHeig.data_ptr(), out.data_ptr(),
          shape[0] * shape[1], R, flags[0], flags[1], _stream())
    _count(launches, 'spectral_update_members')
    return out


def stats_sums_members_ref(U, EnergieEut: Optional[torch.Tensor], A0s, A1s,
                           *, delx, RT, B, threshold, fold: bool = False):
    """(R, 5) float64: :func:`stats_sums_ref` of each field of U with its
    member's A0s[r], A1s[r] (``fold``: the fields folded)."""
    U, EnergieEut = _unfolded(U, EnergieEut, fold)
    A0 = _per_member(A0s, U.dtype)
    A1 = _per_member(A1s, U.dtype)
    f64 = torch.float64
    dims = (-2, -1)
    DUx, DUy = gradient2d(U, delx)
    du2 = DUx * DUx + DUy * DUy
    Uinv = 1.0 - U
    integrand = (RT * (U * (torch.log(U) - B) + Uinv * torch.log(Uinv))
                 + (A0 + A1 * (Uinv - U)) * U * Uinv)
    if EnergieEut is None:
        s_e2 = torch.zeros(U.shape[0], dtype=f64, device=U.device)
    else:
        s_e2 = (EnergieEut * EnergieEut).to(f64).sum(dims)
    return torch.stack([integrand.to(f64).sum(dims), du2.to(f64).sum(dims),
                        U.to(f64).sum(dims),
                        (U < threshold).to(f64).sum(dims), s_e2], dim=-1)


def stats_sums_members(U, EnergieEut: Optional[torch.Tensor], A0s, A1s, *,
                       delx, RT, B, threshold, fold: bool = False):
    """K3 on every member in one launch: member r on grid layer r with
    the grid a single (N, N) field gets (:func:`stats_grid` of N and the
    stack's addresses: where N allows the vector, every member's field
    starts a multiple of 16 bytes after the first, so a contiguous stack
    and a fresh field take the same vector width), its own ticket and its
    own fixed-order finish; ``fold`` as :func:`stats_sums`."""
    R = _members(U)
    if fold and U.shape[1] % 2:
        raise ValueError(f"the folded layout needs an even N, got "
                         f"{U.shape[1]}")
    _member_vector('A0s', A0s, R, U, torch.float64)
    _member_vector('A1s', A1s, R, U, torch.float64)
    ops = (U,) if EnergieEut is None else (U, EnergieEut)
    if EnergieEut is not None and EnergieEut.shape != U.shape:
        raise ValueError("EnergieEut and U differ in shape")
    if not _on_card(*ops):
        return stats_sums_members_ref(U, EnergieEut, A0s, A1s, delx=delx,
                                      RT=RT, B=B, threshold=threshold,
                                      fold=fold)
    N = U.shape[1]
    tile = stats_tile(N, N, N, 0, 0, U.element_size(),
                      *(t.data_ptr() for t in ops), fold=fold)
    return _stats_sums_members_launch(U, EnergieEut, A0s, A1s, tile,
                                      delx=delx, RT=RT, B=B,
                                      threshold=threshold, fold=fold)


def _stats_sums_members_launch(U, EnergieEut, A0s, A1s, tile, *, delx, RT,
                               B, threshold, fold=False, prev=False):
    """K3_members' launch with ``tile`` (as :func:`_stats_sums_launch`)."""
    R, N = U.shape[0], U.shape[1]
    vec, band, nblocks = tile
    partials = torch.empty((R * nblocks, 5), dtype=torch.float64,
                           device=U.device)
    sums = torch.empty((R, 5), dtype=torch.float64, device=U.device)
    _call('ch_stats_members', U.dtype, U.data_ptr(),
          None if EnergieEut is None else EnergieEut.data_ptr(), N, R,
          float(delx), float(RT), float(B), A0s.data_ptr(), A1s.data_ptr(),
          float(threshold), partials.data_ptr(), nblocks, vec, band,
          _ticket(U.device, R).data_ptr(), sums.data_ptr(), int(fold),
          int(prev), _stream())
    _count(launches, 'stats_sums_members')
    return sums


def absdev_sum_members_ref(U, mean):
    """(R,) float64: Σ|U[r] − mean[r]|, ``mean`` (R,) in U's dtype."""
    return (U - mean.reshape(-1, 1, 1)).abs().to(torch.float64).sum((-2, -1))


def _absdev_members_buffers(U):
    """(n, nblocks, partials, sums) of K4_members on an (R, ...) stack."""
    R = U.shape[0]
    n = U.shape[1] * U.shape[2]
    nblocks = int(min(ABSDEV_MAX_BLOCKS,
                      max(1, -(-n // ABSDEV_ELEMS_PER_BLOCK))))
    partials = torch.empty((nblocks, R), dtype=torch.float64,
                           device=U.device)
    sums = torch.empty((R,), dtype=torch.float64, device=U.device)
    return n, nblocks, partials, sums


def absdev_sum_members(U, mean):
    """K4 on every member: one partials launch (member r on grid row r,
    the single launch's blocks) and one reduce over the (blocks, R)
    partials, block r taking column r in the single launch's order."""
    R = _member_blocks(U)
    _member_vector('mean', mean, R, U, U.dtype)
    if not _on_card(U, mean):
        return absdev_sum_members_ref(U, mean)
    n, nblocks, partials, out = _absdev_members_buffers(U)
    _call('ch_absdev_members', U.dtype, U.data_ptr(), n, R, mean.data_ptr(),
          partials.data_ptr(), nblocks, out.data_ptr(), _stream())
    _count(launches, 'absdev_sum_members')
    return out


def absdev_ra_members_ref(U, mean, rows, row: int):
    """(PS sums, Ra): :func:`absdev_sum_members_ref` of U and ``mean``,
    :func:`row_absdev_members_ref` of ``rows`` at ``row``."""
    return absdev_sum_members_ref(U, mean), row_absdev_members_ref(rows,
                                                                   row)


def absdev_ra_members(U, mean, rows, row: int):
    """K4_members with each member's Ra: (Σ|U[r] − mean[r]|, Ra[r]) as two
    (R,) float64 tensors, ``rows`` (R, H, W) holding member r's row
    ``row`` (the members' fields, or their mid rows as (R, 1, W)).  The
    two launches of :func:`absdev_sum_members`; in the second, block r
    runs K11's body on member r's row after its column: the sums are
    absdev_sum_members' bits and Ra row_absdev_members', and K11 has no
    launch of its own.  One count in ``launches['absdev_sum_members']``
    (the kernel is K4_members)."""
    R = _member_blocks(U)
    _member_vector('mean', mean, R, U, U.dtype)
    if _member_blocks(rows) != R:
        raise ValueError(f"rows hold {rows.shape[0]} members, U {R}")
    _, H, W = rows.shape
    if not 0 <= row < H:
        raise ValueError(f"row {row} is not in [0, {H})")
    if not _on_card(U, mean, rows):
        return absdev_ra_members_ref(U, mean, rows, row)
    n, nblocks, partials, out = _absdev_members_buffers(U)
    ra = torch.empty((R,), dtype=torch.float64, device=U.device)
    _call('ch_absdev_ra_members', U.dtype, U.data_ptr(), n, R,
          mean.data_ptr(), partials.data_ptr(), nblocks, out.data_ptr(),
          rows.data_ptr(), H * W, row * W, W, ra.data_ptr(), _stream())
    _count(launches, 'absdev_sum_members')
    return out, ra


def cdiv_check(delx: float, dtype: torch.dtype, n: int = 0, seed: int = 0,
               edges=()) -> dict:
    """The statistics kernel's divisions by h = delx and 2h (``cdiv`` in
    ``csrc/ch_kernels.cu``: a product by the reciprocal, corrected) held
    to the true division on the current card: float32 on every finite
    float x; float64 on ``n`` draws from ``seed`` and the ``edges``.
    {'h', 'h2': the inputs whose bits differ for each divisor, 'checked':
    the inputs checked for each, 'first': the smallest bit pattern of |x|
    that differed, or None}."""
    dev = torch.device('cuda', torch.cuda.current_device())
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    out[3] = -1
    if dtype == torch.float32:
        _call('ch_cdiv_check', dtype, float(delx), out.data_ptr(),
              _stream())
    else:
        e = torch.tensor(list(edges), dtype=torch.float64, device=dev)
        _call('ch_cdiv_check_random', dtype, float(delx), int(n), int(seed),
              e.data_ptr() if len(edges) else None, len(edges),
              out.data_ptr(), _stream())
    h, h2, checked, first = out.tolist()
    return {'h': h, 'h2': h2, 'checked': checked,
            'first': None if first == -1 else first}
