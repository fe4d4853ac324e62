"""Run orchestrator: parameters -> solver -> export.

Port of ``chsimpy_tpu/simulator.py`` without its views: a run asks for no
view (``no_gui``; the live view and PNG output are ROADMAP.md queue A
item 13) and the solve goes straight through
``Solver.solve_or_resume(ntmax)``, as the JAX simulator does when it has
no view.  As there, the run can start from a checkpoint (``restore_file``,
written by either package) or from an exported field (``Uinit_file``),
saves its checkpoint at the end (``checkpoint_file``), and exports the
solution's scalars to YAML and its arrays to CSV (``yaml``,
``export_csv``, ``compress_csv``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import sysinfo
from .core.solver import Solver
from .io import csvio
from .params import Parameters, check_output_scope

# run-control fields the command line keeps when --restore loads the
# physics parameters from the checkpoint; the port's device too
_RESTORE_CLI_FIELDS = ('ntmax', 'time_max', 'update_every', 'no_gui', 'png',
                       'png_anim', 'yaml', 'export_csv', 'compress_csv',
                       'file_id', 'no_diagrams', 'checkpoint_file',
                       'checkpoint_every', 'restore_file', 'device')


class Simulator:
    def __init__(self, params: Parameters = None, U_init=None):
        self.params = params if params is not None else Parameters()
        check_output_scope(self.params)
        if self.params.restore_file is not None:
            from .checkpoint import restore_solver
            solver = restore_solver(self.params.restore_file,
                                    device=self.params.device)
            # the checkpoint's physics parameters win; run control from
            # the caller
            for name in _RESTORE_CLI_FIELDS:
                setattr(solver.params, name, getattr(self.params, name))
            self.params = solver.params
            self.solver = solver
        else:
            if U_init is None and self.params.Uinit_file is not None:
                U_init = csvio.csv_import_matrix(self.params.Uinit_file)
            self.solver = Solver(self.params, U_init)
        self.solution_file_id = None

    def solve(self):
        self.solution_file_id = sysinfo.get_or_create_file_id(
            self.params.file_id)
        if not self.solver._prepared:
            # a solver restored from a checkpoint is already prepared:
            # prepare() would reset the trajectory
            self.solver.prepare()
        sol = self.solver.solve_or_resume(self.params.ntmax)
        if self.params.checkpoint_file is not None:
            from .checkpoint import save_checkpoint
            save_checkpoint(self.params.checkpoint_file, self.solver)
        return sol

    def export(self) -> str:
        """Write the requested YAML and CSV files; returns their stem
        ``<file id>.solution``."""
        fname_sol = f"{self.solution_file_id}.solution"
        solution = self.solver.solution
        if self.params.yaml:
            solution.yaml_export_scalars(fname=fname_sol + '.yaml')
        members = self.params.export_csv
        if members is not None:
            fext = 'csv.bz2' if self.params.compress_csv else 'csv'
            for member in members.replace(' ', '').split(','):
                varray = getattr(solution, member, None)
                if isinstance(varray, torch.Tensor):
                    varray = varray.cpu().numpy()
                if varray is not None and getattr(varray, 'ndim', 0) >= 1:
                    csvio.csv_export_matrix(
                        np.asarray(varray),
                        fname=f"{fname_sol}.{member}.{fext}")
        return fname_sol

    def export_requested(self) -> bool:
        p = self.params
        return bool(p.export_csv is not None or p.yaml or p.png
                    or p.png_anim)
