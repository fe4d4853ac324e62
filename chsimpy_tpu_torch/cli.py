"""Command-line interface.

The flags of the JAX CLI (``chsimpy_tpu/cli.py``), with the same names,
choices, defaults, range checks and cross-flag errors, plus ``--device``
and ``--dist-backend``; a ``-p`` YAML file wins over the command line, as
there.  ``--kernels`` alone is recognized and refused: the hand-written
kernels are the port's path.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from .params import KERNELS_MSG, PRECISIONS, Parameters, solver_scope_errors
from .version import __version__


@dataclass(frozen=True)
class Flag:
    names: Sequence[str]            # CLI option strings
    group: str                      # argument group title
    help: str
    param: Optional[str] = None     # Parameters field to assign (None: skip)
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
    Flag(('-a', '--adaptive-time'), 'Simulation',
         'Use adaptive-time stepping (approximation, experimental)',
         param='adaptive_time', action='store_true'),
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
         'Generator for initial random deviations in concentration',
         param='generator', choices=['uniform', 'simplex', 'sobol', 'lcg'],
         default='uniform'),
    Flag(('-s', '--seed'), 'Simulation',
         'Start seed for random number generators',
         param='seed', type=int, default=2023),
    Flag(('-j', '--jitter'), 'Simulation',
         'Adds noise based on -g in every step by provided factor '
         '[0, 0.1) (much slower)', param='jitter', type=float),
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
         '2-D DCT route: matmul (C·U·Cᵀ), split (folded block products '
         'in a permuted spectral basis, even N), fft (Makhoul rFFT, even '
         'N), or ozaki (float64 only: exact int8 slice products); auto '
         'picks by N, precision and mesh from steps/s measured on the card',
         param='transform_backend',
         choices=['auto', 'matmul', 'split', 'fft', 'ozaki'],
         default='auto'),
    Flag(('--mesh',), 'Device',
         'Grid mesh of ranks, e.g. "2x2" (rows x cols), over mx*my '
         'torch.distributed processes, one per mesh device (start them '
         'with torchrun --nproc-per-node mx*my): the matmul transform '
         'tiles the field over the grid, split and ozaki take the pencil '
         'layout (column blocks over all mx*my ranks; N divisible by '
         'mx*my). With --restore: a world of another shape than the '
         "checkpoint's", param='mesh_shape'),
    Flag(('--jitter-backend',), 'Device',
         'host = bit-exact RNG streamed per chunk; device = on-device '
         'draws without the per-chunk slab uploads (-g sobol: the Sobol '
         'jitter kernel, BIT-exact with the scipy stream; -g uniform: '
         'torch.rand, not reference-exact)',
         param='jitter_backend', choices=['host', 'device'],
         default='host'),
    Flag(('--dist-backend',), 'Device',
         'torch.distributed backend of a --mesh run: nccl (one card per '
         'rank) or gloo (CPU tensors; ranks may share a card, every '
         'collective then staged through host memory); default nccl on '
         'cuda, gloo on cpu', param='dist_backend',
         choices=['nccl', 'gloo']),
    Flag(('--split-levels',), 'Device',
         'Fold depth of the split transform route (N divisible by '
         '2^levels); default: 4 at N>=4096 (5 under --fold-field), 3 at '
         'N>=2048, else 2. Pin it to make --fold-field a pure-layout A/B',
         param='split_levels', type=int, default=None),
    Flag(('--fold-field',), 'Device',
         'Keep the field in the level-1 folded layout between transforms '
         '(split route, single device or an ensemble over ranks of its '
         'own): drops 4 full-field reversals per step; the statistics '
         'kernel reads the folded field through the fold map. At equal '
         '--split-levels U is the natural run\'s to the bit; the default '
         'depth is one level deeper under the fold at N>=4096. Default: '
         'auto (core/solver.py resolve_fold_field); --no-fold-field forces '
         'the natural layout', param='fold_field',
         action=argparse.BooleanOptionalAction),
    Flag(('--matmul-precision',), 'Device',
         'float32 products of the DCT transforms: highest = full FP32 '
         '(cuBLAS, TF32 off; the TPU\'s 6-pass bf16), high = 3xTF32 on '
         'the tensor cores (the GEMM kernel; the TPU\'s 3-pass), default = '
         'one TF32 pass (the TPU\'s 1-pass bf16). float64 products are '
         'float64 whatever the name. Default: resolved per precision',
         param='matmul_precision', choices=list(PRECISIONS), default=None),
    Flag(('--fwd-matmul-precision',), 'Device',
         'The same for the FORWARD (nonlinear-term) transform only; the '
         'semi-implicit damping makes it far less error-sensitive than '
         'the inverse (unset = auto gate, else --matmul-precision)',
         param='fwd_matmul_precision', choices=list(PRECISIONS),
         default=None),
    Flag(('--inv-band',), 'Device',
         'Banded-precision inverse (float32, matmul and split routes): '
         'spectral rows/cols >= this index contract at one TF32 pass, the '
         'dominant low band keeps --matmul-precision; 0 = uniform '
         'precision (default: auto gate)',
         param='inv_band', type=int, default=None),
    Flag(('--otf-coeffs',), 'Device',
         'Rebuild the Seig/CHeig update coefficients per step from the '
         '1-D eigenvalue axis inside the update kernel instead of reading '
         'two (N,N) grids (1 = on, 0 = off; default: auto gate)',
         param='otf_coeffs', type=int, default=None, choices=[0, 1]),
    Flag(('--ozaki-fwd-pairs',), 'Device',
         'Stage pair cutoffs "S1,S2" for the FORWARD float64 ozaki '
         'transform (default 3,5 — E at the floor with 2 slots of '
         'margin; 2,4 = fastest contract-passing; 5,7 = untrimmed)',
         param='ozaki_fwd_pairs'),
    Flag(('--ozaki-inv-pairs',), 'Device',
         'Stage pair cutoffs "S1,S2" for the INVERSE float64 ozaki '
         'transform, rfold route (default 3,5 — same measured margin '
         'structure as the forward, all exact-stop goldens hold; '
         '5,7 = untrimmed)',
         param='ozaki_inv_pairs'),
    Flag(('-p', '--parameter-file'), 'Input',
         'Input yaml file with parameter values (overwrites CLI '
         'parameters)'),
    Flag(('--Uinit-file',), 'Input',
         'Initial U matrix file (csv or bz2 format).',
         param='Uinit_file'),
    Flag(('--restore',), 'Input',
         'Resume from a checkpoint file (see --checkpoint-file; one '
         'written by either package): continues the exact trajectory — '
         "field, trace, counters, RNG stream. The checkpoint's physics "
         'parameters win; run-control flags (-n, output flags, --device) '
         'come from this command line.', param='restore_file'),
    Flag(('-f', '--file-id'), 'Output',
         'Filenames have an id like "<ID>...yaml" ("auto" creates a '
         'timestamp). Existing files will be OVERWRITTEN!',
         param='file_id', default='auto'),
    Flag(('--no-gui',), 'Output',
         'Do not show plot window (if --png or --png-anim).',
         param='no_gui', action='store_true'),
    Flag(('--png',), 'Output',
         'Export solution plot to PNG image file (see --file-id).',
         param='png', action='store_true'),
    Flag(('--png-anim',), 'Output',
         'Export live plotting to series of PNGs (--update-every '
         'required) (see --file-id).', param='png_anim',
         action='store_true'),
    Flag(('--yaml',), 'Output',
         'Export the solution scalars to a yaml file (see --file-id).',
         param='yaml', action='store_true'),
    Flag(('--export-csv',), 'Output',
         'Solution matrix names to be exported to csv (e.g. ...="U,E2")',
         param='export_csv'),
    Flag(('-C', '--compress-csv'), 'Output',
         'Compress csv files with bz2',
         param='compress_csv', action='store_true'),
    Flag(('--update-every',), 'Output',
         'Every n simulation steps data is plotted or rendered (>=2) '
         '(slowdown).', param='update_every', type=int),
    Flag(('--no-diagrams',), 'Output',
         'No diagrams or axes, it only renders the image map of U.',
         param='no_diagrams', action='store_true'),
    Flag(('--checkpoint-file',), 'Output',
         'Save the full resumable solver state (npz: field, trace, '
         'counters, RNG stream position) here at the end of the run '
         '(and periodically with --checkpoint-every); resume with '
         '--restore.', param='checkpoint_file'),
    Flag(('--checkpoint-every',), 'Output',
         'Also save the checkpoint about every n steps (snapped to '
         'device-chunk boundaries).', param='checkpoint_every', type=int),
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
        self.parser.add_argument('--kernels', nargs=1,
                                 action=_refusal(KERNELS_MSG),
                                 default=argparse.SUPPRESS,
                                 help=argparse.SUPPRESS)
        self.args = None

    # ------------------------------------------------------------------
    def get_parameters(self, argv=None) -> Parameters:
        self.args = self.parser.parse_args(argv)
        params = Parameters()

        for flag in FLAGS:
            if flag.param is None:
                continue
            dest = flag.names[-1].lstrip('-').replace('-', '_')
            value = getattr(self.args, dest)
            if flag.valid_range is not None:
                value = self.get_if_range_ok(value, *flag.valid_range,
                                             name=dest.replace('_', '-'))
            if flag.param in ('kappa_tilde', 'A0_const', 'A1_const',
                              'temp') and value is None:
                continue  # keep the Parameters default (incl. derived kappa)
            setattr(params, flag.param, value)

        if params.mesh_shape is not None:
            try:
                params.mesh_shape = tuple(
                    int(v) for v in params.mesh_shape.lower().split('x'))
            except ValueError:
                self.parser.error('--mesh must look like "2x4"')

        for pflag in ('ozaki_fwd_pairs', 'ozaki_inv_pairs'):
            raw = getattr(params, pflag)
            if isinstance(raw, str):
                flag = '--' + pflag.replace('_', '-')
                try:
                    s1, s2 = (int(v) for v in raw.split(','))
                except ValueError:
                    self.parser.error(f'{flag} must look like "3,5"')
                if not (0 <= s1 <= 7 and 0 <= s2 <= 7):
                    self.parser.error(f'{flag} cutoffs must be in [0, 7]')
                setattr(params, pflag, (s1, s2))

        # cross-flag validation (reference cli_parser.py:146-153)
        if params.update_every is not None and params.update_every < 2:
            self.parser.error('--update-every should be >=2')
        if params.png_anim and params.update_every is None:
            self.parser.error('--png-anim requires --update-every.')
        if params.export_csv is not None and (
                params.export_csv == ''
                or params.export_csv.lower() == 'none'):
            self.parser.error('--export-csv does not contain valid entries.')
        if params.compress_csv and params.export_csv is None:
            self.parser.error('--compress-csv has no effect '
                              '(no --export-csv given).')
        if params.checkpoint_every is not None \
                and params.checkpoint_file is None:
            self.parser.error('--checkpoint-every has no effect '
                              '(no --checkpoint-file given).')

        # YAML parameter file overrides CLI (reference order,
        # cli_parser.py:155-156)
        if self.args.parameter_file is not None:
            params.yaml_import_scalars(self.args.parameter_file)

        errs = solver_scope_errors(params)
        if errs:
            self.parser.error('; '.join(errs))
        return params

    def print_info(self):
        print(f"{self.parser.prog} {__version__} "
              "('--help' for command parameters)")

    def get_if_range_ok(self, value, lower, upper, name=None):
        if lower <= value <= upper:
            return value
        name = 'value' if name is None else name
        self.parser.error(f"{name} is out of the range [{lower},{upper}].")
