"""Run orchestrator: parameters -> solver -> views -> export.

Port of ``chsimpy_tpu/simulator.py``: wires Parameters into the Solver,
drives either one solve or the live view's chunked loop
(``update_every``), pushes the solution into the view, and writes the
YAML, CSV and PNG files.  As there, the run can start from a checkpoint
(``restore_file``, written by either package) or from an exported field
(``Uinit_file``), and saves its checkpoint at the end
(``checkpoint_file``).

* The live loop re-enters ``Solver.solve_or_resume(update_every)``; each
  entry recomputes the spectral image, as the reference does, so a live
  run equals a Solver resumed at the same boundaries, not a straight
  solve.
* The field lives on the card: a refresh copies it to the host once
  (:func:`host_field`) and every panel draws that copy.
* Under ``--mesh`` every rank runs the same chunk boundaries (each ends
  in the collective gather of the field, and the loop's predicate reads
  the stop reason, which is the same bits on every rank); rank 0 alone
  builds the view and writes the PNGs and the checkpoints (every rank
  gathers the field for them and waits for the write).
* The views import matplotlib when they are built, so a run without a
  view never touches it; a run that asks for one on a machine without
  matplotlib fails with an error naming it (``viz/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import sysinfo
from .core.solver import Solver
from .io import csvio
from .params import Parameters


def build_view(params: Parameters):
    """View factory: the six-panel diagnostics unless ``no_diagrams``."""
    if params.no_diagrams:
        from .viz.mapview import MapView
        return MapView(params.N)
    from .viz.plotview import PlotView
    return PlotView(params.N, params.XXX)


def solution_time_total(params: Parameters, solution) -> float:
    """Total simulated seconds represented by a solution's trace."""
    td = solution.timedata
    if td is None or len(td) == 0:
        return (1 / params.M_tilde
                * (solution.computed_steps - 1) * params.delt)
    return solution.domtime[-1] ** 3


def host_field(U) -> np.ndarray:
    """The field as a host array: one copy off the card for a tensor."""
    if isinstance(U, torch.Tensor):
        return U.detach().cpu().numpy()
    return np.asarray(U)


def push_solution_view(view, params: Parameters, solution,
                       time_total: float) -> None:
    """Populate a view's panels from a solution (the live solver's, an
    ensemble member's, an imported one).  The field is copied to the host
    once and shared by the map, the slice and the histogram."""
    U = host_field(solution.U)
    view.set_Umap(
        U=U, threshold=params.threshold,
        title=f"U <> {params.threshold}, total time = "
              f"{sysinfo.sec_to_min_if(time_total)}, "
              f"steps = {solution.computed_steps}")
    if params.no_diagrams:
        return  # MapView renders only the field

    n = solution.computed_steps
    view.set_Uline(U=U, title='Slice at U(N/2,:)')
    if params.adaptive_time:
        view.set_Eline_delt(E=solution.E, it_range=solution.it_range,
                            delt=solution.delt,
                            title='Total Energy', computed_steps=n)
    else:
        view.set_Eline(E=solution.E, it_range=solution.it_range,
                       title='Total Energy', computed_steps=n)
    view.set_SAlines(
        domtime=solution.domtime, SA=solution.SA,
        title=f"Area of high silica (U <> {params.threshold})",
        computed_steps=n, x2=time_total ** (1 / 3), t0=solution.t0)
    view.set_E2line(
        E2=solution.E2, it_range=solution.it_range,
        title=f"Surf.Energy | Separation t0 = "
              f"{sysinfo.sec_to_min_if(solution.t0)}",
        computed_steps=n, tau0=solution.tau0, t0=solution.t0)
    view.set_Uhist(U, "Solution Histogram")


def render_solution_png(params: Parameters, solution, fname: str) -> None:
    """One-shot offscreen PNG of a finished solution (the experiment's
    per-run render, reference ``chsimpy/experiment.py:104-109``)."""
    view = build_view(params)
    view.imode_off()
    push_solution_view(view, params, solution,
                       solution_time_total(params, solution))
    view.render_to(fname)
    try:
        view._plt.close(view.fig)
    except Exception:
        pass


# run-control fields the command line keeps when --restore loads the
# physics parameters from the checkpoint; the port's device and process
# group backend too (the file's mesh_shape holds, as in the JAX package,
# unless the caller gives --mesh: a world of another shape)
_RESTORE_CLI_FIELDS = ('ntmax', 'time_max', 'update_every', 'no_gui', 'png',
                       'png_anim', 'yaml', 'export_csv', 'compress_csv',
                       'file_id', 'no_diagrams', 'checkpoint_file',
                       'checkpoint_every', 'restore_file', 'device',
                       'dist_backend')


class Simulator:
    def __init__(self, params: Parameters = None, U_init=None):
        self.params = params if params is not None else Parameters()
        if self.params.restore_file is not None:
            from .checkpoint import restore_solver
            solver = restore_solver(self.params.restore_file,
                                    device=self.params.device,
                                    dist_backend=self.params.dist_backend,
                                    mesh_shape=self.params.mesh_shape)
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
        self.steps_total = 0
        self.solution_file_id = None
        if not self.gui_required():
            self.params.update_every = None  # nothing to refresh
        self.view = self._make_view()

    def _make_view(self):
        # under --mesh rank 0 alone draws and writes
        mesh = self.solver.mesh
        if not self.gui_required() or (mesh is not None and mesh.rank):
            return None
        return build_view(self.params)

    # ------------------------------------------------------------------
    # solving
    # ------------------------------------------------------------------
    def solve(self):
        self.solution_file_id = sysinfo.get_or_create_file_id(
            self.params.file_id)
        if not self.solver._prepared:
            # a solver restored from a checkpoint is already prepared:
            # prepare() would reset the trajectory
            self.solver.prepare()
        if self.params.update_every is None:
            sol = self.solver.solve_or_resume(self.params.ntmax)
        else:
            sol = self._live_solve()
        if self.params.checkpoint_file is not None:
            from .checkpoint import save_checkpoint
            save_checkpoint(self.params.checkpoint_file, self.solver)
        return sol

    def _live_solve(self):
        """Chunked solve with a view refresh (and an optional PNG frame)
        between chunks.  Every rank of a mesh runs the same chunks; only
        the rank with the view draws."""
        view = self.view
        if view is not None:
            view.prepare(show=self.gui_requested())
            if self.gui_requested():
                view.imode_on()
                view.show()
            else:
                view.imode_off()

        steps_end = self.params.ntmax
        if self.params.time_max is not None and self.params.time_max > 0:
            steps_end = sysinfo.get_int_max_value()
        dsteps = min(steps_end, self.params.update_every)
        assert dsteps > 0
        part = 0
        while self._live_should_continue(steps_end, dsteps):
            self.solver.solve_or_resume(dsteps)
            if view is not None:
                self._update_view()
                view.draw()
                if self.params.png_anim:
                    view.render_to(
                        f"{self.solution_file_id}.{part:05d}.png")
            self.steps_total += dsteps
            part += 1
            remaining = steps_end - self.steps_total
            if 0 < remaining < dsteps:
                dsteps = remaining
            elif remaining < 0:
                raise RuntimeError("steps_end or ntmax is too low")

        if view is not None:
            view.finish()
        solution = self.solver.solution
        if solution.tau0 == 0:
            # no energy fall happened: report the last step as tau0
            solution.tau0 = solution.computed_steps - 1
            solution.t0 = self.solver.time_passed
        return solution

    def _live_should_continue(self, steps_end, dsteps) -> bool:
        stop = self.solver.solution.stop_reason
        if stop == 'time-limit':
            return False
        if stop != 'None' and not self.params.full_sim:
            return False
        return (self.steps_total + dsteps) <= steps_end

    # ------------------------------------------------------------------
    # view data
    # ------------------------------------------------------------------
    def _update_view(self):
        solution = self.solver.solution
        push_solution_view(self.view, self.params, solution,
                           solution_time_total(self.params, solution))

    # ------------------------------------------------------------------
    # artifacts
    # ------------------------------------------------------------------
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

    def render(self):
        """Draw the final solution and write ``<file id>.png`` when asked
        (rank 0 of a mesh: the other ranks hold no view)."""
        if self.view is None:
            return
        self.view.imode_off()
        if self.gui_required():
            self._update_view()
        if self.params.png:
            self.view.render_to(f"{self.solution_file_id}.png")
        if self.gui_requested():
            self.view.show(block=sysinfo.is_notebook())
        self.view.imode_default()

    # ------------------------------------------------------------------
    def export_requested(self) -> bool:
        p = self.params
        return bool(p.export_csv is not None or p.yaml or p.png
                    or p.png_anim)

    def gui_requested(self) -> bool:
        return self.params.no_gui is False

    def gui_required(self) -> bool:
        return self.params.png or self.params.png_anim \
            or self.gui_requested()
