#!/usr/bin/env python
"""``python -m chsimpy_tpu_torch`` — single-run CLI entry point.

Parse flags, run the simulation, print the run summary and, for a run on
the card, how often each kernel was launched."""

from __future__ import annotations

import json

from . import sysinfo
from .cli import CLIParser
from .ops import kernels
from .simulator import Simulator


def _summarize(solution) -> str:
    t0_human = sysinfo.sec_to_min_if(solution.t0)
    return (f"computed_steps = {solution.computed_steps}, "
            f"t0 = {solution.t0:g} s ({t0_human}), "
            f"stop reason = {solution.stop_reason}")


def main(argv=None):
    parser = CLIParser()
    parser.print_info()
    params = parser.get_parameters(argv)
    simulator = Simulator(params)
    print(str(params).replace(", '", "\n '"))

    kernels.reset_launches()
    solution = simulator.solve()
    print(_summarize(solution))
    if simulator.solver.device.type == 'cuda':
        print(f"kernel launches: {json.dumps(kernels.launches)}")


if __name__ == '__main__':
    main()
