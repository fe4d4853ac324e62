"""The readings a cell's limits are set from, on the card, in one process.

    python -m chbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control]

Runs the cell as ``run.py`` does (its window shortened to ``--seconds``,
which still holds the mix's longest answers), once a seed, and prints one
JSON line a seed: the numbers the check compares, each compared column's
gap (E, E2, PS, Ra), the end-to-end metrics.  ``--control`` puts the
cell's control in the program's place (its file's ``check.control``): the
program's own lower-precision path, or the reference one precision below
the configuration's.  A limit lies above the sound runs' largest reading
and below the control's smallest (PERF.md gives both).
"""

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m chbench.calibrate')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--control', action='store_true')
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chbench.calibrate: needs a CUDA card')
    torch.set_num_threads(1)
    from .harness import run_cell
    for seed in (int(s) for s in a.seeds.split(',')):
        detail = {}
        t0 = time.perf_counter()
        result, check = run_cell(a.workload, seed, a.seconds,
                                 t_proc0=t0, control=a.control,
                                 detail=detail)
        print(json.dumps({
            'workload': a.workload, 'seed': seed, 'control': a.control,
            'correct': result['correct'],
            'numbers': {k: v for k, (v, _) in check.items()},
            'columns': {k: (np.asarray(v).tolist() if k != 'chunk' else v)
                        for k, v in detail.items()},
            'metrics': {k: m['value'] for k, m in result['metrics'].items()},
            'wall_s': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
