"""The step's four kernels: a hand-written CUDA kernel for a tensor on the
card, its plain PyTorch version for a tensor on the CPU.

Counterpart of ``chsimpy_tpu/ops/pallas_kernels.py``.  Each wrapper

* runs the plain version (``*_ref``) only when its input lies on the CPU;
* on a CUDA tensor launches the kernel of ``csrc/ch_kernels.cu`` on the
  current stream or raises — there is no fallback;
* adds one to ``launches[name]`` where it launches the kernel, and nowhere
  else (the CPU path does not count).

The ``*_ref`` functions keep the JAX package's formulas and operation
order.  Sums are returned as float64 tensors on the input's device: the
float32 stop predicate rests on a float64 accumulation of float32 terms.
"""

from __future__ import annotations

from typing import Optional

import torch

from .stencil import gradient2d

# kernel name -> number of launches on the card (see reset_launches)
launches = {'chemical_potential': 0, 'spectral_update': 0,
            'stats_sums': 0, 'absdev_sum': 0}

# grid of the two reduction kernels: fixed by the shape alone, so the
# summation order (and the result, to the bit) never depends on the card
STATS_ROWS_PER_BLOCK = 4
ABSDEV_ELEMS_PER_BLOCK = 8 * 256
ABSDEV_MAX_BLOCKS = 4096

_SUFFIX = {torch.float32: '_f32', torch.float64: '_f64'}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def chemical_potential(U, RT, BRT, A0, A1):
    if not _on_card(U):
        return chemical_potential_ref(U, RT, BRT, A0, A1)
    out = torch.empty_like(U)
    _call('ch_mu', U.dtype, U.data_ptr(), out.data_ptr(), U.numel(),
          float(RT), float(BRT), float(A0), float(A1), _stream())
    launches['chemical_potential'] += 1
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
    launches['spectral_update'] += 1
    return out


# ----------------------------------------------------------------------
# K3: fused field sums (replaces pallas_kernels.stats_band_sums)
# ----------------------------------------------------------------------

def stats_sums_ref(U, EnergieEut: Optional[torch.Tensor], A0, A1, *,
                   delx, RT, B, threshold):
    """(5,) float64: [Σ integrand, Σ|∇U|², ΣU, #(U<threshold), ΣEnergieEut²]
    — terms in the field type, sums in float64; the last is 0 when
    ``EnergieEut`` is None (the prepare path)."""
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


def stats_sums(U, EnergieEut: Optional[torch.Tensor], A0, A1, *,
               delx, RT, B, threshold):
    _square(U)
    ops = (U,) if EnergieEut is None else (U, EnergieEut)
    if not _on_card(*ops):
        return stats_sums_ref(U, EnergieEut, A0, A1, delx=delx, RT=RT, B=B,
                              threshold=threshold)
    if EnergieEut is not None and EnergieEut.shape != U.shape:
        raise ValueError("EnergieEut and U differ in shape")
    N = U.shape[0]
    nblocks = -(-N // STATS_ROWS_PER_BLOCK)
    partials = torch.empty((nblocks, 5), dtype=torch.float64,
                           device=U.device)
    sums = torch.empty((5,), dtype=torch.float64, device=U.device)
    _call('ch_stats', U.dtype, U.data_ptr(),
          None if EnergieEut is None else EnergieEut.data_ptr(), N,
          float(delx), float(RT), float(B), float(A0), float(A1),
          float(threshold), partials.data_ptr(), nblocks, sums.data_ptr(),
          _stream())
    launches['stats_sums'] += 1
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
    launches['absdev_sum'] += 1
    return out
