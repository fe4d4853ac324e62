"""Command-line interface.

The flags of the JAX CLI (``chsimpy_tpu/cli.py``) that the port runs, with
the same names, defaults and range checks, plus ``--device``.  Every other
flag of the JAX CLI is still recognized, and refused with an error that
names the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from .params import (KERNELS_MSG, Parameters, not_ported,
                     solver_scope_errors)
from .version import __version__


@dataclass(frozen=True)
class Flag:
    names: Sequence[str]            # CLI option strings
    group: str                      # argument group title
    help: str
    param: str                      # Parameters field to assign
    type: Any = None
    default: Any = None
    action: Optional[str] = None    # e.g. 'store_true'
    choices: Optional[Sequence[str]] = None
    valid_range: Optional[tuple] = None  # inclusive (lower, upper)


FLAGS = [
    Flag(('-N',), 'Simulation', 'Number of pixels in one domain (NxN)',
         param='N', type=int, default=512),
    Flag(('-n', '--ntmax'), 'Simulation',
         'Maximum number of simulation steps (might stop early, '
         'see --full-sim)', param='ntmax', type=int, default=int(1e6)),
    Flag(('-t', '--time-max'), 'Simulation',
         'Maximal simulated time in minutes (ignores ntmax)',
         param='time_max', type=float),
    Flag(('-z', '--full-sim'), 'Simulation',
         'Do not stop simulation early when energy falls',
         param='full_sim', action='store_true'),
    Flag(('--cinit',), 'Simulation',
         'Initial mean mole fraction of silica',
         param='XXX', type=float, default=0.875, valid_range=(0.85, 0.95)),
    Flag(('--threshold',), 'Simulation',
         'Threshold mole fraction value to determine c_A and c_B '
         '(should match --cinit)',
         param='threshold', type=float, default=0.875,
         valid_range=(0.85, 0.95)),
    Flag(('--temperature',), 'Simulation', 'Temperature in Kelvin',
         param='temp', type=float, default=923.15),
    Flag(('--A0',), 'Simulation', 'A0 value (ignores temperature) [kJ/mol]',
         param='A0_const', type=float),
    Flag(('--A1',), 'Simulation', 'A1 value (ignores temperature) [kJ/mol]',
         param='A1_const', type=float),
    Flag(('-K', '--kappa-tilde'), 'Simulation',
         'Value for kappa_tilde [kJ/mol] (unset: derived with sympy)',
         param='kappa_tilde', type=float),
    Flag(('--dt',), 'Simulation', 'Time delta of simulation',
         param='delt', type=float, default=3e-8, valid_range=(1e-12, 1e-6)),
    Flag(('-g', '--generator'), 'Simulation',
         'Generator for initial random deviations in concentration '
         '(sobol and simplex are not ported yet)',
         param='generator', choices=['uniform', 'simplex', 'sobol', 'lcg'],
         default='uniform'),
    Flag(('-s', '--seed'), 'Simulation',
         'Start seed for random number generators',
         param='seed', type=int, default=2023),
    Flag(('--precision',), 'Device',
         'float64 = validation mode (matches reference <=1e-10); '
         'float32 = fast mode',
         param='precision', choices=['float64', 'float32'],
         default='float64'),
    Flag(('--chunk-size',), 'Device', 'Device steps per host round-trip',
         param='chunk_size', type=int, default=1024),
    Flag(('--device',), 'Device',
         "Where the run lives: 'cuda' (the hand-written kernels; raises "
         "without a card) or 'cpu' (the plain PyTorch versions)",
         param='device', default='cuda'),
    Flag(('--transform',), 'Device',
         '2-D DCT route: matmul (auto resolves to matmul; split, fft and '
         'ozaki are not ported yet)', param='transform_backend',
         choices=['auto', 'matmul', 'split', 'fft', 'ozaki'],
         default='auto'),
    Flag(('-f', '--file-id'), 'Output',
         'Run id ("auto" creates a timestamp)',
         param='file_id', default='auto'),
    Flag(('--no-gui',), 'Output',
         'Do not show a plot window (required: the live view is not '
         'ported yet)', param='no_gui', action='store_true'),
]

# flags of the JAX CLI that the port refuses: names, value count, what
_LATER = [
    (('-a', '--adaptive-time'), 0, 'adaptive time stepping', 7),
    (('-j', '--jitter'), 1, 'per-step jitter', 7),
    (('--jitter-backend',), 1, 'per-step jitter', 7),
    (('--mesh',), 1, 'grid sharding over a device mesh', 11),
    (('--fold-field', '--no-fold-field'), 0, 'the TPU tuning knob '
     '--fold-field', 14),
    (('--split-levels',), 1, 'the split transform route', 2),
    (('--matmul-precision',), 1, 'the TPU tuning knob --matmul-precision',
     14),
    (('--fwd-matmul-precision',), 1,
     'the TPU tuning knob --fwd-matmul-precision', 14),
    (('--ozaki-fwd-pairs',), 1, 'the ozaki int8 transform route', 10),
    (('--ozaki-inv-pairs',), 1, 'the ozaki int8 transform route', 10),
    (('--inv-band',), 1, 'the TPU tuning knob --inv-band', 14),
    (('--otf-coeffs',), 1, 'the TPU tuning knob --otf-coeffs', 14),
    (('-p', '--parameter-file'), 1, 'YAML parameter files', 13),
    (('--Uinit-file',), 1, '--Uinit-file (CSV import)', 13),
    (('--restore',), 1, 'checkpoint and restore', 8),
    (('--checkpoint-file',), 1, 'checkpoint and restore', 8),
    (('--checkpoint-every',), 1, 'checkpoint and restore', 8),
    (('--png',), 0, 'the live view and PNG output', 13),
    (('--png-anim',), 0, 'the live view and PNG output', 13),
    (('--yaml',), 0, 'CSV and YAML export', 13),
    (('--export-csv',), 1, 'CSV and YAML export', 13),
    (('-C', '--compress-csv'), 0, 'CSV and YAML export', 13),
    (('--update-every',), 1, 'the live view and PNG output', 13),
    (('--no-diagrams',), 0, 'the live view and PNG output', 13),
]


def _refusal(message: str) -> type:
    class NotPorted(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{option_string}: {message}")
    return NotPorted


class CLIParser:
    def __init__(self, progname='chsimpy-tpu-torch'):
        self.parser = argparse.ArgumentParser(
            prog=progname,
            description='Simulation of Phase Separation in Na2O-SiO2 '
                        'Glasses under Uncertainty (solving the '
                        'Cahn-Hilliard (CH) equation with PyTorch and '
                        'hand-written CUDA kernels)',
            formatter_class=argparse.ArgumentDefaultsHelpFormatter,
            add_help=True,
        )
        self.parser.add_argument('--version', action='version',
                                 version=f"%(prog)s {__version__}")
        groups = {}
        for flag in FLAGS:
            if flag.group not in groups:
                groups[flag.group] = self.parser.add_argument_group(
                    flag.group)
            kw = {'help': flag.help}
            if flag.action:
                kw['action'] = flag.action
            else:
                if flag.type:
                    kw['type'] = flag.type
                if flag.choices:
                    kw['choices'] = flag.choices
                kw['default'] = flag.default
            groups[flag.group].add_argument(*flag.names, **kw)
        later = self.parser.add_argument_group(
            'Not ported yet (each names its ROADMAP.md item)')
        for names, nargs, what, item in _LATER:
            later.add_argument(*names, nargs=nargs,
                               action=_refusal(not_ported(what, item)),
                               default=argparse.SUPPRESS,
                               help=argparse.SUPPRESS)
        later.add_argument('--kernels', nargs=1, action=_refusal(KERNELS_MSG),
                           default=argparse.SUPPRESS, help=argparse.SUPPRESS)
        self.args = None

    # ------------------------------------------------------------------
    def get_parameters(self, argv=None) -> Parameters:
        self.args = self.parser.parse_args(argv)
        params = Parameters()

        for flag in FLAGS:
            dest = flag.names[-1].lstrip('-').replace('-', '_')
            value = getattr(self.args, dest)
            if flag.valid_range is not None:
                value = self.get_if_range_ok(value, *flag.valid_range,
                                             name=dest.replace('_', '-'))
            if flag.param in ('kappa_tilde', 'A0_const', 'A1_const',
                              'temp') and value is None:
                continue  # keep the Parameters default (incl. derived kappa)
            setattr(params, flag.param, value)

        errs = solver_scope_errors(params)
        if errs:
            self.parser.error('; '.join(errs))
        if not params.no_gui:
            self.parser.error('the live view is not ported to '
                              'chsimpy_tpu_torch yet (ROADMAP.md queue A '
                              'item 13): pass --no-gui')
        return params

    def print_info(self):
        print(f"{self.parser.prog} {__version__} "
              "('--help' for command parameters)")

    def get_if_range_ok(self, value, lower, upper, name=None):
        if lower <= value <= upper:
            return value
        name = 'value' if name is None else name
        self.parser.error(f"{name} is out of the range [{lower},{upper}].")
