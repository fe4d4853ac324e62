"""Derived physical constants for a run.

Pure host-side float64 math, the same as ``chsimpy_tpu/derived.py``; the
common-tangent solve for kappa is cached in material.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import material
from .params import Parameters


@dataclass(frozen=True)
class Derived:
    Am: float           # molar area [µm^2/mol]
    delx: float
    delx2: float
    RT: float
    BRT: float
    Amr: float          # 1/Am
    A0: float           # [kJ/mol]
    A1: float           # [kJ/mol]
    time_fac: float
    M: float
    kappa_base: Optional[float]
    kappa_tilde: float
    kappa: float

    @classmethod
    def from_params(cls, p: Parameters) -> 'Derived':
        Am = (25.13 * 1e6 / p.N_A) ** (2 / 3) * p.N_A
        delx = p.L / (p.N - 1)
        A0 = p.func_A0(p.temp)
        A1 = p.func_A1(p.temp)
        if p.kappa_tilde is None:
            kappa_base = material.get_distance_common_tangent(
                R=p.R, T=p.temp, B=p.B, a0=A0, a1=A1, at=p.XXX)
            kappa_tilde = kappa_base / (0.1602564 * 64) ** 2
        else:
            kappa_base = None
            kappa_tilde = p.kappa_tilde
        return cls(
            Am=Am,
            delx=delx,
            delx2=delx ** 2,
            RT=p.R * p.temp,
            BRT=p.B * p.R * p.temp,
            Amr=1 / Am,
            A0=A0,
            A1=A1,
            time_fac=(1 / p.M_tilde) * p.delt,
            M=p.M_tilde / Am,
            kappa_base=kappa_base,
            kappa_tilde=kappa_tilde,
            kappa=kappa_tilde * (1 / Am),
        )
