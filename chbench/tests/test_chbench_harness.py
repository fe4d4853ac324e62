"""The harness: cells found by name, BENCHMARK.json against the
benchmark's contract, no JAX in a run, the result line."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from chbench.harness import forbidden_modules, run_cell
from chbench.spec import NAME, Bench

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())


def test_a_cell_added_as_one_file_is_found_and_runs(tiny_root):
    # a cell nobody listed: one new file, no other file touched; it runs,
    # is checked and reports the metric every cell reports
    cell = {'config': 'fast_tiny', 'traffic': 'n64',
            'check': json.loads((tiny_root / 'workloads'
                                 / 'fast_tiny.n64.json').read_text())['check']}
    (tiny_root / 'workloads' / 'dummy.json').write_text(json.dumps(cell))
    bench = Bench(tiny_root)
    assert 'dummy' in bench.names('workloads')
    found = bench.cell('dummy')
    assert found['config']['runner'] == 'single'
    assert found['config']['params']['N'] == 64
    result, check = run_cell('dummy', 7, 0.5, device='cpu',
                             root=tiny_root)
    assert result['correct'], check
    assert set(result['metrics']) == {'setup_s'}
    assert list(result)[-1] == 'check'
    # named in a metric's list, the cell reports that metric too
    listed = json.loads((tiny_root.parent / 'BENCHMARK.json').read_text())
    for m in listed['end_to_end']:
        if m['name'] == 'steps_per_s':
            m['workloads'].append('dummy')
    bench = Bench(tiny_root, benchmark=listed)
    assert set(bench.end_to_end('dummy', {
        'steps_per_s': (1.0, 'steps/s'), 'setup_s': (2.0, 's')})) == {
        'steps_per_s', 'setup_s'}
    assert bench.readers('dummy') == {}


def test_every_listed_cell_metric_and_config_has_its_file():
    bench = Bench()
    for w in BENCH['workloads']:
        cell = bench.cell(w['name'])
        assert cell['config']['name'] == w['config']
        assert cell['traffic']['name'] == w['traffic']
    for c in BENCH['configs']:
        assert (REPO / c['file']).exists()
    for m in BENCH['per_layer']:
        assert (bench.root / 'metrics' / f"{m['name']}.py").exists()


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n)
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    layers = {}
    for m in BENCH['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
        assert re.fullmatch(r'[A-Za-z0-9_/%.-]{1,16}', m['unit'])
        for w in m['workloads']:
            assert w in e2e[m['moves']].get('workloads', [w])
        layers.setdefault(m['layer'], m['layer'])
    cells = [w['name'] for w in BENCH['workloads']]
    for w in BENCH['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200
        per_layer = [m for m in BENCH['per_layer']
                     if w['name'] in m['workloads']]
        other = [m for m in BENCH['end_to_end'] if m['name'] != 'setup_s'
                 and w['name'] in m.get('workloads', cells)]
        assert per_layer and other
    for c in BENCH['configs']:
        assert c['file'].startswith('chbench/')
        assert c['reduced'] == []
        assert len(c['source']) <= 200 and c['source'].startswith('https://')
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert 'chsimpy_tpu_torch' not in forbidden_modules()
    monkeypatch.setitem(sys.modules, 'chsimpy_tpu.core', object())
    assert forbidden_modules() == ['chsimpy_tpu']


def test_a_run_loads_no_jax(tiny_root):
    code = (
        'import sys\n'
        'from chbench.harness import run_cell, forbidden_modules\n'
        f'r, c = run_cell("fast_tiny.n64", 3, 0.2, device="cpu", '
        f'root={str(tiny_root)!r})\n'
        'assert r["correct"], c\n'
        'print(forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run([sys.executable, '-m', 'chbench.run', '--workload',
                          'uq512_f64.p_auto', '--seed', '1', '--seconds', '1',
                          '--trace', '0'], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    if out.returncode == 0:
        pytest.skip('a card is there')
    assert out.stdout == ''


@pytest.mark.parametrize('independent', [False, True])
def test_the_design_is_the_experiment_s(independent):
    # the members and batch widths upstream's script gets from the port's
    # experiment with its defaults (-R 10, -P -1, the host pool on)
    import numpy as np

    from chbench.inputs import batch_width, design_factors
    from chsimpy_tpu_torch import experiment
    cfg = json.loads((REPO / 'chbench/configs/uq512_f64.json').read_text())
    ep = experiment.ExperimentParams()
    ep.runs, ep.A_seed, ep.independent = cfg['runs'], cfg['A_seed'], \
        independent
    ep.jitter_Arellow, ep.jitter_Arelhigh = cfg['A_factors']
    want = experiment.generate_A_factors(ep)
    got = design_factors(cfg['runs'], *cfg['A_factors'], cfg['A_seed'],
                         'independent' if independent else 'uniform')
    np.testing.assert_array_equal(got, want)
    assert batch_width(len(want), -1, cfg['host_pool']) \
        == experiment._auto_batch_width(len(want), ep) \
        == (10 if independent else 5)


def test_every_seed_runs_every_batch_each_time_round():
    from chbench.inputs import MemberStream
    bench = Bench()
    cell = bench.cell('uq512_f64.p_auto')
    for seed in (1, 2 ** 31 + 5):
        stream = MemberStream(cell['config'], cell['traffic'], seed)
        assert sorted(len(A) for A, _ in stream.batches) == [5, 5, 10, 10]
        assert stream.widths() == [5, 10]
        seen = [stream.batch()[0] for _ in range(8)]
        for turn in (seen[:4], seen[4:]):
            assert sorted(a[0, 0] for a in turn) == sorted(
                A[0, 0] for A, _ in stream.batches)
