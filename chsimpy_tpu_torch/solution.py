"""Host-side solution container.

The same attribute names as ``chsimpy_tpu/solution.py``: derived scalar
constants, the concentration field U (a torch tensor on the run's device),
the TimeData series and the early-stop bookkeeping.  YAML export comes with
ROADMAP.md queue A item 13.
"""

from __future__ import annotations

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
        raise AttributeError("No such attribute: " + name)
