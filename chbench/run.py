"""The benchmark of the port: one run of one cell.

    python -m chbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs the cell of ``chbench/workloads/<cell>.json`` on the card: set-up
(imports, the kernels loaded from their build cache, the solver's
constants, the warm-up), a window of ``--seconds``, then the check
against the plain reference.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with its limit); the numbers compared are also the last
lines of standard error.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.  ``setup_s`` runs from
this module's first line.

Exits with 2 and prints no result where no card is there (or fewer than
the cell asks for), and with 3 where JAX or the JAX package was loaded.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m chbench.run',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    t_args = time.perf_counter()
    import torch
    t_torch = time.perf_counter()
    # one process with few threads: the window's host work is one Python
    # thread launching kernels; idle pool threads only compete with it
    torch.set_num_threads(1)
    from .harness import forbidden_modules, run_cell
    from .spec import Bench

    chips = next((w.get('chips', 1)
                  for w in Bench().benchmark.get('workloads', [])
                  if w.get('name') == a.workload), 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"chbench: the cell needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    t_look = time.perf_counter()
    import chsimpy_tpu_torch  # noqa: F401  (no program: no result)
    t_port = time.perf_counter()
    result, check, parts = run_cell(a.workload, a.seed, a.seconds,
                                    bool(a.trace), 'cuda', T_PROC0,
                                    setup_parts=True)
    # where the set-up went (seconds): the runner's own parts after ours
    parts = {'arguments': t_args - T_PROC0,
             'import torch': t_torch - t_args,
             'look for a card': t_look - t_torch,
             'import chsimpy_tpu_torch': t_port - t_look,
             'harness imports': parts.pop('before the runner') - (
                 t_port - T_PROC0), **parts}
    print('setup_parts ' + json.dumps(parts), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"chbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, (v, lim) in check.items():
        print(f"check {k} = {float(v)!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
