"""Run orchestrator: parameters -> solver -> solution.

Port of ``chsimpy_tpu/simulator.py`` without its views and exports (the
live view, PNG, CSV and YAML output come with ROADMAP.md queue A item 13):
a run asks for no view (``no_gui``) and the solve goes straight through
``Solver.solve_or_resume(ntmax)``, as the JAX simulator does when it has no
view.
"""

from __future__ import annotations

from . import sysinfo
from .core.solver import Solver
from .params import Parameters, check_output_scope


class Simulator:
    def __init__(self, params: Parameters = None, U_init=None):
        self.params = params if params is not None else Parameters()
        check_output_scope(self.params)
        self.solver = Solver(self.params, U_init)
        self.solution_file_id = None

    def solve(self):
        self.solution_file_id = sysinfo.get_or_create_file_id(
            self.params.file_id)
        if not self.solver._prepared:
            self.solver.prepare()
        return self.solver.solve_or_resume(self.params.ntmax)
