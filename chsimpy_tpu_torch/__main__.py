#!/usr/bin/env python
"""``python -m chsimpy_tpu_torch`` — single-run CLI entry point.

Parse flags, run the simulation (with the live view unless ``--no-gui``),
render the PNG and export the requested files, print the run summary and,
for a run on the card, how often each kernel was launched; then keep the
plot window open when the GUI was asked for.

With ``--mesh MxN`` the run is one rank of a sharded world (the grid
layout on the matmul route, the pencil layout on split and ozaki): start
M*N of them with ``torchrun --standalone --nproc-per-node M*N -m
chsimpy_tpu_torch --mesh MxN ...``.  Each joins the process group torchrun
describes and runs the live loop's chunks; only rank 0 draws, writes
(the exports and the checkpoints of ``--checkpoint-file``) and prints
(its launch counts are its own block's).  ``--restore`` under torchrun
joins the group too: the file's mesh shape holds unless ``--mesh`` gives
another."""

from __future__ import annotations

import json
import os

from . import sysinfo
from .cli import CLIParser
from .ops import kernels
from .parallel import distributed
from .simulator import Simulator


def _summarize(simulator: Simulator, solution) -> str:
    t0_human = sysinfo.sec_to_min_if(solution.t0)
    lines = [f"computed_steps = {solution.computed_steps}, "
             f"t0 = {solution.t0:g} s ({t0_human}), "
             f"stop reason = {solution.stop_reason}"]
    if simulator.export_requested():
        lines.append(f"File ID = {simulator.solution_file_id}")
    return "\n".join(lines)


def main(argv=None):
    parser = CLIParser()
    # torchrun's rank (a plain run is rank 0)
    lead = os.environ.get('RANK', '0') == '0'
    if lead:
        parser.print_info()
    params = parser.get_parameters(argv)
    if params.mesh_shape is not None or params.restore_file is not None:
        # a plain run outside torchrun joins nothing
        distributed.initialize(params.dist_backend, params.device)
    try:
        simulator = Simulator(params)
        mesh = simulator.solver.mesh
        if lead:
            print(str(params).replace(", '", "\n '"))
            if mesh is not None:
                print(mesh.describe())
            if simulator.solver.cfg.pencil:
                N, D = params.N, mesh.size
                print(f"pencil layout: the field in ({N}, {N // D}) column "
                      f"blocks, the spectral image in ({N // D}, {N}) row "
                      f"blocks")

        kernels.reset_launches()
        solution = simulator.solve()
        if lead:
            simulator.render()
            simulator.export()
            print(_summarize(simulator, solution))
            if simulator.solver.device.type == 'cuda':
                print(f"kernel launches: {json.dumps(kernels.launches)}")
            if simulator.gui_requested():
                simulator.view.show(block=True)
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    main()
