"""Simulation parameters.

The same fields and defaults as ``chsimpy_tpu/params.py`` (so a
``scalar_dict`` carries across, see convert.py), plus the port's own
``device`` and ``dist_backend``.  Two fields select what the port does not
run, and :func:`check_solver_scope` refuses any other value than their
defaults with the reason: ``kernel_backend`` (the hand kernels are the
port's path) and ``spectral_bf16`` (a probe knob of the JAX package,
measured negative).

YAML files (``yaml_export_scalars`` / ``yaml_import_scalars``) are the JAX
package's, byte for byte: the port's own fields stay out of them.
"""

from __future__ import annotations

import copy
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
    generator: str = 'uniform'        # uniform | lcg | sobol | simplex
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
    # fold depth of the split transform route; None resolves by size
    split_levels: Optional[int] = None
    # the float32 knobs (core/solver.py resolves each None): the split
    # route's level-1 folded field, the product precision of the
    # transforms and of the forward alone ('highest' | 'high' | 'default',
    # ops/dct.py)
    fold_field: Optional[bool] = None
    kernel_backend: str = 'xla'
    matmul_precision: Optional[str] = None
    fwd_matmul_precision: Optional[str] = None
    # (stage 1, stage 2) pair cutoffs of the ozaki route's forward and
    # rfold inverse transforms; None = (3, 5) (core/solver.py)
    ozaki_fwd_pairs: Optional[tuple] = None
    ozaki_inv_pairs: Optional[tuple] = None
    # the banded inverse's first tail index (0: uniform precision) and the
    # update's coefficients rebuilt per step (1 / 0)
    inv_band: Optional[int] = None
    otf_coeffs: Optional[int] = None
    spectral_bf16: bool = False
    # auto (core/solver.py auto_route) | matmul | split | fft | ozaki
    # (float64)
    transform_backend: str = 'auto'

    version: str = __version__

    # the port's own fields: where the run lives ('cuda' or 'cpu', never
    # chosen implicitly — device.resolve_device), and the torch.distributed
    # backend of a --mesh run (None: nccl on 'cuda', gloo on 'cpu')
    device: str = 'cuda'
    dist_backend: Optional[str] = None

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

    def deepcopy(self) -> 'Parameters':
        return copy.deepcopy(self)

    def scalar_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d['mesh_shape'] = list(self.mesh_shape) if self.mesh_shape else None
        return d

    def is_scalarwise_equal_with(self, other: 'Parameters') -> bool:
        """Equality over scalar fields, ignoring version (reference:
        ``parameters.py:105-115``)."""
        if not isinstance(other, Parameters):
            return False
        sd, od = self.scalar_dict(), other.scalar_dict()
        sd.pop('version', None)
        od.pop('version', None)
        return sd == od

    def __str__(self):
        return str(dict(sorted(self.scalar_dict().items())))

    # ------------------------------------------------------------------
    def yaml_export_scalars(self, fname: str) -> None:
        """The JAX package's parameter file (without ``PORT_FIELDS``)."""
        from .io import yamlio
        d = self.scalar_dict()
        for k in PORT_FIELDS:
            d.pop(k)
        yamlio.export_scalars(fname, d, tag='Parameters')

    def yaml_import_scalars(self, fname: str) -> None:
        """Load scalar fields from a YAML file (own format or reference's);
        unknown keys, ``version`` and callables-as-strings are skipped
        (reference: ``parameters.py:91-101``)."""
        from .io import yamlio
        data = yamlio.import_scalars(fname)
        names = {f.name for f in dataclasses.fields(self)}
        for k, v in data.items():
            if k not in names or k == 'version':
                continue
            if isinstance(v, str) and v.startswith('lambda'):
                continue
            if k in TUPLE_FIELDS and v is not None:
                v = tuple(v)
            setattr(self, k, v)


# the port's own fields (not in the JAX package's Parameters)
PORT_FIELDS = ('device', 'dist_backend')
# fields held as tuples (lists in YAML and JSON)
TUPLE_FIELDS = ('mesh_shape', 'ozaki_fwd_pairs', 'ozaki_inv_pairs')


KERNELS_MSG = ("--kernels has no counterpart in the port: on a CUDA tensor "
               "the hand-written kernels are the path (ROADMAP.md queue B)")
SPECTRAL_BF16_MSG = (
    "spectral_bf16 is not ported: a probe knob of the JAX package with no "
    "CLI, measured negative there (the N=2048 stop +24.9%, "
    "chsimpy_tpu/core/stepper.py:179-186; ROADMAP.md 'Not to port')")
PRECISIONS = ('highest', 'high', 'default')


def solver_scope_errors(p: Parameters) -> list:
    """Why the solver cannot run ``p`` yet (empty: it can)."""
    errs = []
    if p.generator not in ('uniform', 'lcg', 'sobol', 'simplex'):
        errs.append(f"unknown generator '{p.generator}'")
    if p.jitter_backend not in ('host', 'device'):
        errs.append(f"unknown jitter backend '{p.jitter_backend}'")
    if p.transform_backend not in ('auto', 'matmul', 'split', 'fft',
                                   'ozaki'):
        errs.append(f"unknown transform '{p.transform_backend}'")
    if p.kernel_backend != 'xla':
        errs.append(KERNELS_MSG)
    if p.spectral_bf16:
        errs.append(SPECTRAL_BF16_MSG)
    for name in ('matmul_precision', 'fwd_matmul_precision'):
        v = getattr(p, name)
        if v is not None and v not in PRECISIONS:
            errs.append(f"unknown {name} {v!r}; choose from {PRECISIONS}")
    if p.otf_coeffs not in (None, 0, 1):
        errs.append(f"otf_coeffs must be 0, 1 or None, got "
                    f"{p.otf_coeffs!r}")
    if p.precision not in ('float32', 'float64'):
        errs.append(f"unknown precision '{p.precision}'")
    return errs


def check_solver_scope(p: Parameters) -> None:
    errs = solver_scope_errors(p)
    if errs:
        raise NotImplementedError('; '.join(errs))

