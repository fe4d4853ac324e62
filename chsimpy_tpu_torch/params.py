"""Simulation parameters.

The same fields and defaults as ``chsimpy_tpu/params.py`` (so a
``scalar_dict`` carries across, see convert.py), plus ``device``.  Fields
that select parts of the JAX package the port does not run yet keep their
defaults; :func:`check_solver_scope` and :func:`check_output_scope` refuse
any other value with an error that names the ROADMAP item that ports it.
YAML import/export is one of those parts (queue A item 13).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from . import material
from .version import __version__


@dataclass
class Parameters:
    """Initial simulation parameters (defaults = reference defaults)."""

    seed: int = 2023
    N: int = 512                      # [pixels] grid is N x N
    L: float = 2.0                    # [µm] domain edge length
    XXX: float = 0.875                # mean initial mole fraction of silica
    temp: float = 650.0 + 273.15      # temperature [K]
    B: float = 12.86                  # Gibbs-energy tuning parameter []
    R: float = 0.0083144626181532     # gas constant [kJ / (K mol)]
    N_A: float = 6.02214076e+23       # Avogadro constant [1/mol]

    delt: float = 3e-8                # time step
    delt_max: float = 9e-8            # max time step (adaptive mode)
    M_tilde: float = 1.71e-8          # mobility factor [µm^2/(kJ s)]
    kappa_tilde: Optional[float] = None  # None = derived via common tangent

    threshold: float = 0.875          # splits component A/B in U
    ntmax: int = int(1e6)             # max steps (early stop on energy fall)

    export_csv: Optional[str] = None
    png: bool = False
    png_anim: bool = False
    yaml: bool = False
    no_gui: bool = False
    file_id: str = 'auto'
    full_sim: bool = False
    compress_csv: bool = False
    time_max: Optional[float] = None  # minutes of simulated time
    generator: str = 'uniform'        # uniform | lcg (sobol | simplex: later)
    adaptive_time: bool = False
    jitter: Optional[float] = None
    update_every: Optional[int] = 100
    no_diagrams: bool = False
    Uinit_file: Optional[str] = None

    checkpoint_file: Optional[str] = None
    checkpoint_every: Optional[int] = None
    restore_file: Optional[str] = None

    # A0/A1 interaction model as data: constant override + UQ factor
    A0_const: Optional[float] = None
    A1_const: Optional[float] = None
    A0_factor: float = 1.0
    A1_factor: float = 1.0

    precision: str = 'float64'        # float64 (validation) | float32 (fast)
    chunk_size: int = 1024            # device steps per host round-trip
    mesh_shape: Optional[tuple] = None
    jitter_backend: str = 'host'
    # TPU tuning knobs of the JAX package; the port runs their defaults
    fold_field: Optional[bool] = None
    split_levels: Optional[int] = None
    kernel_backend: str = 'xla'
    matmul_precision: Optional[str] = None
    fwd_matmul_precision: Optional[str] = None
    ozaki_fwd_pairs: Optional[tuple] = None
    ozaki_inv_pairs: Optional[tuple] = None
    inv_band: Optional[int] = None
    otf_coeffs: Optional[int] = None
    spectral_bf16: bool = False
    transform_backend: str = 'auto'   # auto | matmul (split/fft/ozaki: later)

    version: str = __version__

    # the port's own field: where the run lives ('cuda' or 'cpu', never
    # chosen implicitly — device.resolve_device)
    device: str = 'cuda'

    # ------------------------------------------------------------------
    def func_A0(self, temp: float) -> float:
        """A0(T) [kJ/mol] honoring constant override and UQ factor."""
        if self.A0_const is not None:
            return float(self.A0_const)
        return material.A0(temp) * self.A0_factor

    def func_A1(self, temp: float) -> float:
        if self.A1_const is not None:
            return float(self.A1_const)
        return material.A1(temp) * self.A1_factor

    def scalar_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d['mesh_shape'] = list(self.mesh_shape) if self.mesh_shape else None
        return d

    def __str__(self):
        return str(dict(sorted(self.scalar_dict().items())))


KERNELS_MSG = ("--kernels has no counterpart in the port: on a CUDA tensor "
               "the hand-written kernels are the path (ROADMAP.md queue B)")


def not_ported(what: str, item) -> str:
    return (f"{what} is not ported to chsimpy_tpu_torch yet "
            f"(ROADMAP.md queue A item {item})")


def solver_scope_errors(p: Parameters) -> list:
    """Why the solver cannot run ``p`` yet (empty: it can)."""
    errs = []
    if p.adaptive_time:
        errs.append(not_ported('adaptive time stepping', 7))
    if p.jitter is not None:
        errs.append(not_ported('per-step jitter (--jitter)', 7))
    if p.jitter_backend != 'host':
        errs.append(not_ported('--jitter-backend device', 7))
    if p.generator in ('sobol', 'simplex'):
        errs.append(not_ported(f"the '{p.generator}' generator", 7))
    elif p.generator not in ('uniform', 'lcg'):
        errs.append(f"unknown generator '{p.generator}'")
    if p.restore_file is not None or p.checkpoint_file is not None \
            or p.checkpoint_every is not None:
        errs.append(not_ported('checkpoint and restore', 8))
    if p.mesh_shape is not None:
        errs.append(not_ported('grid sharding over a device mesh', 11))
    tb = p.transform_backend
    if tb in ('split', 'fft'):
        errs.append(not_ported(f'the {tb} transform route', 2))
    elif tb == 'ozaki':
        errs.append(not_ported('the ozaki int8 transform route', 10))
    elif tb not in ('auto', 'matmul'):
        errs.append(f"unknown transform '{tb}'")
    if p.kernel_backend != 'xla':
        errs.append(KERNELS_MSG)
    knobs = {'fold_field': p.fold_field, 'split_levels': p.split_levels,
             'matmul_precision': p.matmul_precision,
             'fwd_matmul_precision': p.fwd_matmul_precision,
             'ozaki_fwd_pairs': p.ozaki_fwd_pairs,
             'ozaki_inv_pairs': p.ozaki_inv_pairs,
             'inv_band': p.inv_band or None,
             'otf_coeffs': p.otf_coeffs or None,
             'spectral_bf16': p.spectral_bf16 or None}
    for name, value in knobs.items():
        if value is not None and value is not False:
            errs.append(not_ported(f'the TPU tuning knob {name}={value!r}',
                                   14))
    if p.precision not in ('float32', 'float64'):
        errs.append(f"unknown precision '{p.precision}'")
    return errs


def output_scope_errors(p: Parameters) -> list:
    """Why the simulator's outputs for ``p`` cannot run yet."""
    errs = []
    if not p.no_gui or p.png or p.png_anim:
        errs.append(not_ported('the live view and PNG output '
                               '(pass --no-gui)', 13))
    if p.export_csv is not None or p.compress_csv or p.yaml:
        errs.append(not_ported('CSV and YAML export', 13))
    if p.Uinit_file is not None:
        errs.append(not_ported('--Uinit-file (CSV import)', 13))
    return errs


def check_solver_scope(p: Parameters) -> None:
    errs = solver_scope_errors(p)
    if errs:
        raise NotImplementedError('; '.join(errs))


def check_output_scope(p: Parameters) -> None:
    errs = output_scope_errors(p)
    if errs:
        raise NotImplementedError('; '.join(errs))
