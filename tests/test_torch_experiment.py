"""The UQ experiment driver of chsimpy_tpu_torch (``experiment.py``)
against the JAX package's (``chsimpy_tpu/experiment.py``) on the CPU, and
its numpy aggregate against the committed JAX artifacts.

The same command line goes to both packages' ``main`` in two directories.
Bounds: the A factors bit-equal; ``results.csv``, ``results-agg.csv`` and
every per-run YAML byte-equal (they hold the stop steps, t0, the sympy
values and the factors); each per-run E2 CSV within 1e-12 relative (the
two packages' float64 matmuls sum in other orders, so E2 differs in its
last bits).  The port against itself (the host pool against the
synchronous pipeline, a resumed experiment against an uninterrupted one):
the same bytes."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from chsimpy_tpu import checkpoint as jck
from chsimpy_tpu import experiment as jexp

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import checkpoint as tck
from chsimpy_tpu_torch import ensemble, experiment as texp, material
from test_torch_ensemble_ozaki import STOP_DRIFT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAPPA = 2.98911291966116e-4
# N=32, delt 1.4e-5 (beyond --dt's range: a -p file sets it), the lcg
# field: every member stops in 30-60 steps
RUN = ['-N', '32', '-n', '60', '-p', 'dt.yaml', '-g', 'lcg',
       '--export-csv', 'E2', '--host-procs', '1']
CASES = {
    'sympy_kappas': ['-R', '4', '--A-source', 'sobol'],
    'two_batches': ['-R', '4', '-P', '2', '-K', repr(KAPPA)],
    'file_source': ['-R', '3', '--A-source', 'pairs.csv', '-K',
                    repr(KAPPA)],
}
ARTIFACTS = {'r5_f64': 'artifacts/r5/uq_f64/tpu64-results',
             'r4_f32': 'artifacts/r4/uq/tpu-results'}


def _run(mod, argv, where, monkeypatch):
    _inputs(where)
    monkeypatch.chdir(where)
    mod.main(argv)
    return {f: open(os.path.join(where, f), 'rb').read()
            for f in sorted(os.listdir(where))
            if f not in ('pairs.csv', 'dt.yaml')}


def _port(argv, where, monkeypatch):
    return _run(texp, argv + ['--device', 'cpu'], where, monkeypatch)


def _jax(argv, where, monkeypatch):
    return _run(jexp, argv + ['--no-gui'], where, monkeypatch)


def _inputs(where):
    """The runs' input files: the -p file and the file-sourced pairs."""
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, 'dt.yaml'), 'w') as f:
        f.write('delt: 1.4e-05\n')
    p = ctt.Parameters()
    A = np.array([[p.func_A0(p.temp) * f0, p.func_A1(p.temp) * f1]
                  for f0, f1 in ((1.0, 1.0), (1.003, 0.998),
                                 (0.996, 1.004), (1.001, 1.001))])
    np.savetxt(os.path.join(where, 'pairs.csv'), A, delimiter=',')


def _exp_params(source, independent=False, runs=5):
    ep, jp = texp.ExperimentParams(), jexp.ExperimentParams()
    for e in (ep, jp):
        e.runs, e.A_source, e.A_seed = runs, source, 85972
        e.independent = independent
    return ep, jp


@pytest.mark.parametrize('independent', [False, True])
@pytest.mark.parametrize('source', ['uniform', 'sobol', 'grid'])
def test_A_factors_equal_jax(source, independent):
    for runs in (1, 5, 16):
        ep, jp = _exp_params(source, independent, runs)
        got, want = texp.generate_A_factors(ep), jexp.generate_A_factors(jp)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert ep.runs == jp.runs


@pytest.mark.parametrize('case', list(CASES))
def test_experiment_files_equal_jax(case, tmp_path, monkeypatch):
    argv = RUN + CASES[case] + ['-f', 'uq']
    port = _port(argv, str(tmp_path / 'port'), monkeypatch)
    jax_ = _jax(argv, str(tmp_path / 'jax'), monkeypatch)
    assert sorted(port) == sorted(jax_)
    runs = sorted(f for f in port if f.endswith('.yaml'))
    assert len(runs) == {'file_source': 3}.get(case, 4)
    for name, data in port.items():
        if name.endswith('E2.csv'):
            a = np.loadtxt(str(tmp_path / 'port' / name))
            b = np.loadtxt(str(tmp_path / 'jax' / name))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        elif not name.endswith('metadata.csv'):
            assert data == jax_[name], name
    rows = port['uq-results.csv'].decode().splitlines()
    tau0 = [int(r.split(',')[7]) for r in rows[1:]]
    assert all(0 < t < 60 for t in tau0)      # every member stopped
    if case == 'file_source':
        assert rows[1].endswith(',0,,')       # None factors: empty cells


@pytest.mark.parametrize('source', ['sobol', 'uniform'])
def test_ozaki_experiment_files_equal_jax(source, tmp_path, monkeypatch):
    """``--transform ozaki`` (float64, the member-batched route): the
    results, the aggregate and every per-run YAML byte-equal to the JAX
    package's.  Each member's E2 is held to the drift the two packages'
    single ozaki runs show at this stiff delt (STOP_DRIFT,
    tests/test_torch_ensemble_ozaki.py)."""
    argv = RUN + ['-R', '2', '--A-source', source, '-K', repr(KAPPA),
                  '--precision', 'float64', '--transform', 'ozaki', '-f',
                  'uq']
    port = _port(argv, str(tmp_path / 'port'), monkeypatch)
    jax_ = _jax(argv, str(tmp_path / 'jax'), monkeypatch)
    assert sorted(port) == sorted(jax_)
    runs = sorted(f for f in port if f.endswith('.yaml'))
    assert len(runs) == 2
    for name, data in port.items():
        if name.endswith('E2.csv'):
            a, b = (np.loadtxt(str(tmp_path / d / name))
                    for d in ('port', 'jax'))
            assert a.shape == b.shape
            assert np.max(np.abs(a / b - 1)) <= STOP_DRIFT[0], name
        elif not name.endswith('metadata.csv'):
            assert data == jax_[name], name
    rows = port['uq-results.csv'].decode().splitlines()
    tau0 = [int(r.split(',')[7]) for r in rows[1:]]
    assert all(0 < t < 60 for t in tau0)      # every member stopped


def test_host_pool_gives_the_same_bytes(tmp_path, monkeypatch):
    """--host-procs 2 (spawn workers: export and sympy in the pool) and
    the synchronous pipeline write the same files."""
    argv = RUN[:-2] + ['-R', '3', '--A-source', 'sobol', '-f', 'uq']
    sync = _port(argv + ['--host-procs', '1'], str(tmp_path / 'a'),
                 monkeypatch)
    pool = _port(argv + ['--host-procs', '2'], str(tmp_path / 'b'),
                 monkeypatch)
    sync.pop('uq-metadata.csv')
    pool.pop('uq-metadata.csv')
    assert sync == pool


class _Crash(Exception):
    pass


def _crash_after_save(monkeypatch, mod, in_batch):
    """Make ``mod.save_ensemble_checkpoint`` raise after its first save in
    the batch that starts at ``in_batch``: the run dies there."""
    orig = mod.save_ensemble_checkpoint

    def save(fname, ens, extra_header=None):
        orig(fname, ens, extra_header=extra_header)
        if extra_header['start'] == in_batch:
            raise _Crash()
    monkeypatch.setattr(mod, 'save_ensemble_checkpoint', save)


@pytest.mark.parametrize('first', ['jax', 'port'])
def test_experiment_checkpoint_resumes_in_the_other_package(
        first, tmp_path, monkeypatch):
    """A two-batch experiment dies after its first save in batch 2; the
    other package resumes it (batch 1 from the header's rows, batch 2 from
    the saved members): results.csv is the uninterrupted run's, byte for
    byte."""
    ck = str(tmp_path / 'ck.npz')
    argv = RUN + ['-R', '4', '-P', '2', '-K', repr(KAPPA), '--chunk-size',
                  '16', '-f', 'uq']
    full = _port(argv, str(tmp_path / 'full'), monkeypatch)
    save = argv + ['--checkpoint-file', ck, '--checkpoint-every', '16']
    crash, resume = ((_jax, _port) if first == 'jax' else (_port, _jax))
    _crash_after_save(monkeypatch, jck if first == 'jax' else tck, 2)
    with pytest.raises(_Crash):
        crash(save, str(tmp_path / 'crash'), monkeypatch)
    monkeypatch.undo()
    got = resume(argv + ['--restore', ck], str(tmp_path / 'crash'),
                 monkeypatch)
    assert got['uq-results.csv'] == full['uq-results.csv']
    assert got['uq-results-agg.csv'] == full['uq-results-agg.csv']


def _read_results(path):
    """The rows of a committed results.csv, read exactly: tau0, tsep and
    id as ints, every other cell as Python's float (correctly rounded),
    an empty cell as None."""
    lines = open(path).read().splitlines()
    assert lines[0] == ',' + ','.join(texp.RESULT_COLUMNS)
    ints = {texp.RESULT_COLUMNS.index(c) for c in ('tau0', 'tsep', 'id')}
    rows = []
    for line in lines[1:]:
        cells = line.split(',')[1:]
        rows.append(tuple(None if c == '' else int(c) if k in ints
                          else float(c) for k, c in enumerate(cells)))
    return rows


@pytest.mark.parametrize('name', list(ARTIFACTS))
def test_aggregate_reproduces_the_committed_artifacts(name):
    stem = os.path.join(ROOT, ARTIFACTS[name])
    rows = _read_results(stem + '.csv')
    assert texp.results_csv_text(rows) == open(stem + '.csv').read()
    agg = texp.agg_csv_text(texp.aggregate(rows))
    assert agg == open(stem + '-agg.csv').read()


@pytest.mark.parametrize('kind', ['factors', 'file_source', 'nan_row'])
def test_aggregate_equals_pandas(kind, tmp_path, monkeypatch):
    """The numpy aggregate against the JAX package's pandas one on the
    same rows: both files byte-equal."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(11):
        r = rng.random(12) * 10.0 ** rng.integers(-6, 6, size=12)
        fac = (None, None) if kind == 'file_source' else (r[10], r[11])
        rows.append((-r[0] * 150, -r[1] * 85, r[2], r[3], r[4], r[5],
                     float(int(1000 + 400 * r[6])), r[7] * 2000,
                     int(r[8] * 1000), i, *fac))
    if kind == 'nan_row':
        rows[3] = rows[3][:2] + (float('nan'),) + rows[3][3:]
    monkeypatch.chdir(tmp_path)
    texp.aggregate_results(rows, 'port')
    jexp.aggregate_results(rows, 'jax')
    for suffix in ('-results.csv', '-results-agg.csv'):
        assert (open('port' + suffix, 'rb').read()
                == open('jax' + suffix, 'rb').read()), suffix


@pytest.mark.parametrize('flags,message', [
    (['--coordinator', 'localhost:1234', '-f', 'x'],
     '--coordinator requires --num-processes and --process-id'),
    (['--coordinator', 'localhost:1234', '--num-processes', '2',
      '--process-id', '0', '-f', 'x', '--live-view', '--update-every', '10'],
     '--live-view is single-process only'),
    (['--coordinator', 'localhost:1234', '--num-processes', '2',
      '--process-id', '0', '-f', 'x', '--checkpoint-file', 'c.npz'],
     'experiment checkpointing is single-process only'),
    (['--coordinator', 'localhost:1234', '--num-processes', '2',
      '--process-id', '0'], 'need an explicit --file-id'),
])
def test_refusals_name_their_items(flags, message, capsys):
    """The multi-process flags' CLI errors (the JAX package's,
    ``chsimpy_tpu/experiment.py:131-149``)."""
    with pytest.raises(SystemExit):
        texp.ExperimentCLIParser().get_parameters(['-R', '2', *flags])
    assert message in capsys.readouterr().err


def test_the_experiment_refuses_to_run_in_a_host_worker(monkeypatch):
    monkeypatch.setenv(texp.HOST_WORKER_ENV, '1')
    ep, _ = _exp_params('uniform', runs=2)
    with pytest.raises(RuntimeError, match='host-pipeline worker'):
        texp.run_experiment_batch(ctt.Parameters(device='cpu'), ep)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_material_table_is_sympys_and_the_artifacts():
    """chip_smoke.py's SOBOL_MATERIAL (the card's machine has no sympy):
    keyed by the experiment's 16 sobol pairs; each entry the port's sympy
    gap, EPP roots and kappa_tilde, and the JAX package's on-chip float64
    run's (tpu64-results.csv, tpu64-run*.solution.yaml), to the bit."""
    cs = _chip_smoke()
    ep, _ = _exp_params('sobol', runs=16)
    facs = texp.generate_A_factors(ep)
    p = ctt.Parameters(XXX=0.89, threshold=0.89)
    pairs = [(float(f0 * p.func_A0(p.temp)), float(f1 * p.func_A1(p.temp)))
             for f0, f1 in facs]
    assert list(cs.SOBOL_MATERIAL) == pairs
    stem = os.path.join(ROOT, 'artifacts/r5/uq_f64/tpu64')
    rows = _read_results(stem + '-results.csv')
    for r, (a0, a1) in enumerate(pairs):
        ca, cb, sa, sb, kappa = cs.SOBOL_MATERIAL[(a0, a1)]
        assert (ca, cb) == material.get_miscibility_gap(p.R, p.temp, p.B,
                                                        a0, a1)
        assert [sa, sb] == material.get_roots_of_EPP(p.R, p.temp, a0, a1)
        assert kappa == ensemble.derive_member_constants(p, a0, a1)
        assert rows[r][:6] == (a0, a1, ca, cb, sa, sb)
        yml = open(f'{stem}-run{r}.solution.yaml').read()
        assert float(re.search(r'kappa_tilde: (\S+)', yml).group(1)) == kappa


def test_chip_smoke_k10_literals_are_jax_random():
    """The K10 values chip_smoke.py holds the kernel to at steps 1 and 2 of
    seed 2023 (a zero field, jitter 0.5: r - 0.5) are jax.random's."""
    import jax
    cs = _chip_smoke()
    key = jax.random.PRNGKey(2023)
    for step in (1, 2):
        key, sub = jax.random.split(key)
        for dtype, (first, last) in cs.K10_LITERALS[step].items():
            r = np.asarray(jax.random.uniform(
                sub, (cs.K10_LITERAL_N, cs.K10_LITERAL_N),
                {'float32': np.float32, 'float64': np.float64}[dtype]))
            v = 0.5 * (2.0 * r - 1.0)
            assert (float(v[0, 0]), float(v[-1, -1])) == (first, last)
