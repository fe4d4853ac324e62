"""Small cells for the CPU tests: a copy of the benchmark's data files
under a temporary root, with cells cut to sizes a test can hold (each
added as files, as a later change adds a cell), and a ``BENCHMARK.json``
of their own beside the root that lists them and their metrics."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from chbench.spec import ROOT

DIRS = ('configs', 'traffic', 'workloads', 'kernels', 'classes', 'metrics')


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


# a float32 study run (the `single` runner) at N=64; its
# limits from CPU readings at N=64 (four seeds, sound largest / control
# smallest): start rows 2.6e-5 / 1.95e-3, start U 9.6e-7 / 2.6e-4, chunk
# U 1.03e-6 / 1.02e-4, chunk rows 5.81e-5 / 6.38e-3
FAST_TINY = {
    'source': 'upstream chsimpy default material, float32, N=64 (tests)',
    'runner': 'single',
    'params': {
        'N': 64, 'precision': 'float32', 'full_sim': True,
        'transform_backend': 'auto', 'kappa_tilde': 0.00029891134208698706,
        'L': 2.0, 'XXX': 0.875, 'threshold': 0.875, 'temp': 923.15,
        'B': 12.86, 'R': 0.0083144626181532, 'N_A': 6.02214076e+23,
        'delt': 3e-08, 'M_tilde': 1.71e-08, 'chunk_size': 128,
        'generator': 'uniform', 'no_gui': True},
    'reduced': []}
FAST_CHECK = {
    'control': {'reference': 'tf32'},
    'limits': {'start_rows_gap': 2e-4, 'start_U_gap': 1e-5,
               'chunk_U_gap': 1e-5, 'chunk_rows_gap': 5e-4}}

SINGLE_METRICS = (('device_ops_per_step.single', 'ops/step'),
                  ('transform_ms_per_step.single', 'ms'),
                  ('eager_ms_per_step.single', 'ms'),
                  ('kernels_roofline.single', '%'),
                  ('device_idle_share.single', '%'))


def benchmark(cells: dict) -> dict:
    """The ``BENCHMARK.json`` of the small cells ({cell: runner})."""
    single = [c for c, r in cells.items() if r == 'single']
    ens = [c for c, r in cells.items() if r == 'ensemble']
    listed = json.loads((ROOT.parent / 'BENCHMARK.json').read_text())
    uq = [dict(m, workloads=ens) for m in listed['per_layer']
          if m['name'].endswith('.uq')]
    sg = [{'name': n, 'unit': unit, 'better': 'lower',
           'source': 'device_trace', 'layer': 'test',
           'moves': 'steps_per_s', 'workloads': single}
          for n, unit in SINGLE_METRICS]
    return {
        'workloads': [{'name': c, 'chips': 1} for c in cells],
        'end_to_end': [
            {'name': 'steps_per_s', 'unit': 'steps/s', 'workloads': single},
            {'name': 'member_steps_per_s', 'unit': 'steps/s',
             'workloads': ens},
            {'name': 'setup_s', 'unit': 's'}],
        'per_layer': uq + sg}


def make_root(tmp: Path) -> Path:
    """A benchmark root with small cells besides the real ones, at N=64:
    ``fast_tiny.n64`` (a float32 single run, ``full_sim``: the
    reference in TF32 as control) and ``uq_tiny.p_auto``
    (``uq512_f64.p_auto``'s design with 3 runs, so batches of 3 and 6
    members: the program's float32 path as control)."""
    root = Path(tmp) / 'bench'
    for d in DIRS:
        shutil.copytree(ROOT / d, root / d)
    uq = json.loads((ROOT / 'configs' / 'uq512_f64.json').read_text())
    # a larger time step and the default mean fraction: stops after
    # ~200 steps at N=64
    uq['params'].update(N=64, chunk_size=64, delt=1e-6, XXX=0.875,
                        threshold=0.875)
    uq['runs'] = 3
    _write(root / 'configs' / 'uq_tiny.json', uq)
    _write(root / 'configs' / 'fast_tiny.json', FAST_TINY)
    _write(root / 'traffic' / 'n64.json', {'warmup_steps': 17})
    cell = json.loads(
        (ROOT / 'workloads' / 'uq512_f64.p_auto.json').read_text())
    cell.update(config='uq_tiny')
    _write(root / 'workloads' / 'uq_tiny.p_auto.json', cell)
    _write(root / 'workloads' / 'fast_tiny.n64.json',
           {'config': 'fast_tiny', 'traffic': 'n64', 'check': FAST_CHECK})
    _write(root.parent / 'BENCHMARK.json',
           benchmark({'fast_tiny.n64': 'single',
                      'uq_tiny.p_auto': 'ensemble'}))
    return root
