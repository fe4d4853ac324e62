"""Host-side solution container.

The same attribute names as ``chsimpy_tpu/solution.py``: derived scalar
constants, the concentration field U (a torch tensor on the run's device),
the TimeData series and the early-stop bookkeeping, and the YAML export of
the scalars (the JAX package's file, byte for byte).
"""

from __future__ import annotations

import numpy as np

from .derived import Derived
from .params import Parameters


class Solution:
    _TD_ATTRS = ('E', 'E2', 'SA', 'domtime', 'Ra', 'L2', 'PS',
                 'delt', 'it_range')

    def __init__(self, params: Parameters = None, derived: Derived = None):
        self.params = params if params is not None else Parameters()
        d = derived if derived is not None \
            else Derived.from_params(self.params)

        self.U = None
        self.timedata = None

        self.Am = d.Am
        self.delx = d.delx
        self.delx2 = d.delx2
        self.RT = d.RT
        self.BRT = d.BRT
        self.Amr = d.Amr
        self.A0 = d.A0
        self.A1 = d.A1
        self.time_fac = d.time_fac
        self.M = d.M
        if d.kappa_base is not None:
            self.kappa_base = d.kappa_base
        self.kappa_tilde = d.kappa_tilde
        self.kappa = d.kappa

        self.restime = 0
        self.tau0 = 0
        self.t0 = 0
        self.computed_steps = 0
        self.stop_reason = 'None'

    def __getattr__(self, name: str):
        # delegate time-series columns to timedata
        if name in Solution._TD_ATTRS:
            td = self.__dict__.get('timedata')
            if td is not None and hasattr(td, name):
                return getattr(td, name)
        # the spectral coefficient grids of the reference's Solution
        # (exportable as --export-csv CHeig,Seig), computed on demand in
        # the natural coefficient order, at the trace's last delt
        if name in ('CHeig', 'Seig'):
            p = self.__dict__.get('params')
            if p is not None:
                from .ops.coeffs import eigenvalue_axis
                delt = p.delt
                td = self.__dict__.get('timedata')
                if td is not None and len(td) > 0:
                    delt = float(td.delt[-1])
                e = eigenvalue_axis(p.N)
                leig = e[:, None] + e[None, :]
                lam1 = delt / self.delx2
                if name == 'Seig':
                    return lam1 * leig
                lam2 = self.kappa_tilde * lam1 / self.delx2
                return 1.0 + lam2 * (leig * leig)
        raise AttributeError("No such attribute: " + name)

    # ------------------------------------------------------------------
    def scalar_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith('_') or k in ('U', 'timedata', 'params'):
                continue
            if isinstance(v, np.floating):
                v = float(v)
            if isinstance(v, np.integer):
                v = int(v)
            if getattr(v, 'ndim', None):  # numpy arrays or tensors
                continue
            out[k] = v
        return out

    def yaml_export_scalars(self, fname: str) -> None:
        from .io import yamlio
        yamlio.export_scalars(fname, self.scalar_dict(), tag='Solution')

    def is_scalarwise_equal_with(self, other) -> bool:
        if isinstance(other, Solution):
            params_equal = self.params.is_scalarwise_equal_with(other.params)
            return params_equal and self.scalar_dict() == other.scalar_dict()
        if isinstance(other, dict):  # imported YAML mapping
            sd = self.scalar_dict()
            od = {k: v for k, v in other.items() if k in sd}
            return sd == od
        return False
