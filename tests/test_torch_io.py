"""The port's CSV and YAML files (chsimpy_tpu_torch/io, no pandas and no
PyYAML) against the JAX package's, byte for byte, and the port's export,
``-p`` and ``--Uinit-file`` paths on the CPU; validate.py against the JAX
package's."""

import bz2
import math

import numpy as np
import pytest
import torch
import yaml

import chsimpy_tpu as ct
from chsimpy_tpu import validate as jvalidate
from chsimpy_tpu.io import csvio as jcsv
from chsimpy_tpu.io import yamlio as jyaml

import chsimpy_tpu_torch as ctt
from chsimpy_tpu_torch import validate as tvalidate
from chsimpy_tpu_torch.io import csvio, yamlio

torch.set_num_threads(2)

KAPPA = 2.98911291966116e-4

# values the scalar dicts hold, and strings PyYAML quotes for one reason
# or another
SCALARS = {
    'floats': [1.0, 1e-5, 3e-8, 1.71e-08, 6.02214076e+23, 1e17, 1e16, -0.0,
               0.1, 123456789.0, math.inf, -math.inf, math.nan, 5e-324,
               np.float64(0.875), np.float32(0.1)],
    'ints_bools_null': [None, True, False, 0, -3, 10 ** 20, np.int64(7),
                        np.bool_(True)],
    'plain_strings': ['auto', 'None', 'energy', 'float64', '0.1.0',
                      'a:b', 'a#b', '-x', 'x]', '1:30a', 'lambda x'],
    'quoted_strings': ['', 'true', 'yes', 'Off', 'null', '~', '1.0', '12',
                       '0x1F', '1e5', '1.0e+5', '2023-01-01', 'a: b',
                       'a #b', '#x', '- x', '-', ':x', '? x', "it's",
                       ' lead', 'trail ', 'café', 'tab\there', '[x]',
                       '{a}', '&a', '*a', '!a', '|a', '>a', "'a", '"a',
                       '%a', '@a', '`a', '---x', '...', '<<', '=', '.inf',
                       '.nan', 'NaN', '1_000', '0b11', '07', '1:30'],
    'lists': [[1, 2], [], (3, 5), ['a', None, 1.5, 'true']],
}


def _pyyaml(mapping, tag):
    clean = {k: (float(v) if isinstance(v, np.floating)
                 else int(v) if isinstance(v, np.integer)
                 else bool(v) if isinstance(v, np.bool_)
                 else list(v) if isinstance(v, tuple) else v)
             for k, v in mapping.items()}
    return f"--- !{tag}\n" + yaml.dump(clean, Dumper=yaml.SafeDumper,
                                       default_flow_style=False, width=1000)


@pytest.mark.parametrize('kind', sorted(SCALARS))
def test_yaml_scalars_are_pyyaml_safe_dumper_bytes(kind):
    """Each value as PyYAML's SafeDumper writes it, and read back as
    PyYAML reads it (with the JAX package's loader)."""
    mapping = {f'k{i:02d}': v for i, v in enumerate(SCALARS[kind])}
    text = yamlio.dumps_scalars(mapping, 'Solution')
    assert text == _pyyaml(mapping, 'Solution')
    ours = yamlio.loads_scalars(text)
    ref = yaml.load(text, Loader=jyaml._RefLoader)
    assert ours.keys() == ref.keys()
    for k in ref:
        a, b = ours[k], ref[k]
        if isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a)
        else:
            assert a == b and type(a) is type(b), (k, a, b)


def test_yaml_refuses_what_it_cannot_write_on_one_line():
    with pytest.raises(ValueError, match='one-line'):
        yamlio.dumps_scalars({'s': 'a\nb'}, 'Solution')
    with pytest.raises(TypeError):
        yamlio.dumps_scalars({'d': {'x': 1}}, 'Solution')


def _jax_params(**kw):
    p = ct.Parameters()
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.mark.parametrize('kw', [
    {}, {'mesh_shape': (2, 4), 'ozaki_fwd_pairs': (3, 5), 'file_id': '1.0',
         'kappa_tilde': KAPPA, 'jitter': 0.01, 'A0_const': -151.25}],
    ids=['default', 'set'])
def test_parameter_file_bytes_equal_jax(kw, tmp_path):
    jf, tf = tmp_path / 'j.yaml', tmp_path / 't.yaml'
    _jax_params(**kw).yaml_export_scalars(str(jf))
    p = ctt.Parameters(**kw)
    p.yaml_export_scalars(str(tf))
    assert tf.read_bytes() == jf.read_bytes()
    q = ctt.Parameters()
    q.yaml_import_scalars(str(jf))
    assert q.is_scalarwise_equal_with(p)


def _solutions(tmp_path, **kw):
    """(port, JAX) simulators of the same short run, solved."""
    base = dict(N=16, ntmax=5, full_sim=True, generator='lcg',
                kappa_tilde=KAPPA, no_gui=True, update_every=None)
    base.update(kw)
    jp = _jax_params(**base)
    tp = ctt.Parameters(device='cpu', **base)
    js, ts = ct.Simulator(jp), ctt.Simulator(tp)
    js.solve()
    ts.solve()
    return ts, js


@pytest.mark.parametrize('compress', [False, True])
def test_solution_yaml_and_csv_bytes_equal_jax(compress, tmp_path,
                                               monkeypatch):
    """The export of the same solution by both packages: the initial field
    (ntmax=1: the solve stops at prepare, where both hold the seeded
    field's bits), the coefficient grids and the scalars.  The bz2 files
    are compared decompressed."""
    ts, js = _solutions(tmp_path, file_id='run', export_csv='U,CHeig,Seig',
                        yaml=True, compress_csv=compress, ntmax=1)
    for sim, sub in ((ts, 'port'), (js, 'jax')):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.chdir(d)
        sim.export()
    ext = 'csv.bz2' if compress else 'csv'
    read = bz2.decompress if compress else (lambda b: b)
    for name in ('U', 'CHeig', 'Seig'):
        fname = f'run.solution.{name}.{ext}'
        assert read((tmp_path / 'port' / fname).read_bytes()) == \
            read((tmp_path / 'jax' / fname).read_bytes()), name
    yml = 'run.solution.yaml'
    assert (tmp_path / 'port' / yml).read_bytes() == \
        (tmp_path / 'jax' / yml).read_bytes()
    data = yamlio.import_scalars(str(tmp_path / 'jax' / yml))
    assert ts.solver.solution.is_scalarwise_equal_with(data)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_csv_text_equals_jax(dtype, tmp_path):
    rng = np.random.default_rng(4)
    V = (rng.random((7, 5)) * 10.0 ** rng.integers(-8, 8, (7, 5))
         ).astype(dtype)
    V[0, 0], V[1, 1], V[2, 2] = np.nan, np.inf, -0.0
    for ext in ('csv', 'csv.bz2'):
        j, t = tmp_path / f'j.{ext}', tmp_path / f't.{ext}'
        jcsv.csv_export_matrix(V, str(j))
        csvio.csv_export_matrix(V, str(t))
        read = bz2.decompress if ext.endswith('bz2') else (lambda b: b)
        assert read(t.read_bytes()) == read(j.read_bytes())
        # the port reads every value back exactly; pandas' default parser
        # (the JAX package's bz2 reader) is not correctly rounded and
        # lands up to ~1e-13 relative off
        ours = csvio.csv_import_matrix(str(j))
        np.testing.assert_array_equal(ours.astype(dtype), V)
        ref = np.asarray(jcsv.csv_import_matrix(str(j)), np.float64)
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
    col = np.arange(4.0)
    csvio.csv_export_matrix(col, str(tmp_path / 'c.csv.bz2'))
    jcsv.csv_export_matrix(col, str(tmp_path / 'd.csv.bz2'))
    assert bz2.decompress((tmp_path / 'c.csv.bz2').read_bytes()) == \
        bz2.decompress((tmp_path / 'd.csv.bz2').read_bytes()) == \
        b'0.0\n1.0\n2.0\n3.0\n'


def test_reference_yaml_tags_parse(tmp_path):
    f = tmp_path / 'ref.yaml'
    f.write_text(
        "--- !Parameters\n"
        "N: 256\n"
        "seed: 11\n"
        "delt: !numpy.float64 3.0e-08\n"
        "func_A0: 'lambda temp: utils.A0(temp)'\n"
        "mesh_shape:\n- 2\n- 2\n")
    p = ctt.Parameters()
    p.yaml_import_scalars(str(f))
    assert (p.N, p.seed, p.delt, p.mesh_shape) == (256, 11, 3e-8, (2, 2))
    g = tmp_path / 'nd.yaml'
    U = np.round(0.85 + 0.05 * np.random.default_rng(7).random((4, 4)), 6)
    text = np.array2string(U, separator=',', threshold=2147483647)
    g.write_text("--- !Solution\ncomputed_steps: 42\n"
                 "t0: !numpy.float64 12.5\nU: !ndarray |-\n"
                 + ''.join('  ' + ln + '\n' for ln in text.split('\n')))
    for load in (yamlio.import_scalars, jyaml.import_scalars):
        data = load(str(g))
        assert data['computed_steps'] == 42 and data['t0'] == 12.5
        np.testing.assert_array_equal(data['U'], U)
    evil = tmp_path / 'evil.yaml'
    evil.write_text("--- !Solution\nU: !ndarray |\n"
                    "  __import__('os').system('true')\n")
    with pytest.raises(ValueError):
        yamlio.import_scalars(str(evil))
    bad = tmp_path / 'bad.yaml'
    bad.write_text("--- !Solution\nU: !python/object x\n")
    with pytest.raises(ValueError, match='tag'):
        yamlio.import_scalars(str(bad))


def test_cli_reads_a_jax_parameter_file(tmp_path, capsys):
    from chsimpy_tpu_torch.cli import CLIParser
    f = tmp_path / 'p.yaml'
    _jax_params(N=16, ntmax=7, no_gui=True, generator='lcg',
                kappa_tilde=KAPPA, full_sim=True).yaml_export_scalars(str(f))
    # the YAML file wins over the command line (reference order)
    p = CLIParser().get_parameters(['-N', '32', '--no-gui', '--device',
                                    'cpu', '-p', str(f)])
    assert (p.N, p.ntmax, p.generator, p.kappa_tilde, p.device) == \
        (16, 7, 'lcg', KAPPA, 'cpu')
    sol = ctt.Simulator(p).solve()
    assert sol.computed_steps == 7
    # a file that asks for the live view and a PNG: the port's CLI takes
    # it (item 13 is ported), the file winning over --no-gui
    _jax_params(no_gui=False, png=True, update_every=20).yaml_export_scalars(
        str(f))
    p = CLIParser().get_parameters(['--no-gui', '-p', str(f)])
    assert (p.no_gui, p.png, p.update_every) == (False, True, 20)


def test_cli_exports_read_back(tmp_path, capsys, monkeypatch):
    from chsimpy_tpu_torch.__main__ import main
    monkeypatch.chdir(tmp_path)
    main(['-N', '16', '-n', '6', '--no-gui', '-g', 'lcg', '-K', str(KAPPA),
          '-z', '--device', 'cpu', '--export-csv', 'U,E2', '-C', '--yaml',
          '-f', 'vt'])
    out = capsys.readouterr().out
    assert 'computed_steps = 6' in out and 'File ID = vt' in out
    p = ctt.Parameters(N=16, ntmax=6, no_gui=True, generator='lcg',
                       kappa_tilde=KAPPA, full_sim=True, device='cpu')
    sol = ctt.Simulator(p).solve()
    U = csvio.csv_import_matrix('vt.solution.U.csv.bz2')
    np.testing.assert_array_equal(U, sol.U.numpy())
    E2 = csvio.csv_import_matrix('vt.solution.E2.csv.bz2')
    np.testing.assert_array_equal(E2[:, 0], sol.E2)
    data = yamlio.import_scalars('vt.solution.yaml')
    assert sol.is_scalarwise_equal_with(data)
    assert data['computed_steps'] == 6


def test_uinit_file_starts_the_run_as_in_jax(tmp_path):
    f = str(tmp_path / 'U0.csv')
    U0 = 0.875 + 0.01 * (np.random.default_rng(3).random((16, 16)) - 0.5)
    csvio.csv_export_matrix(U0, f)
    base = dict(N=16, ntmax=5, full_sim=True, kappa_tilde=KAPPA,
                no_gui=True, update_every=None, Uinit_file=f)
    ts = ctt.Simulator(ctt.Parameters(device='cpu', **base))
    js = ct.Simulator(_jax_params(**base))
    np.testing.assert_array_equal(ts.solver.U_init, U0)
    tsol, jsol = ts.solve(), js.solve()
    np.testing.assert_allclose(tsol.timedata.E, jsol.timedata.E, rtol=1e-12)


def test_validate_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.random((20, 9))
    b = a * (1 + 1e-11 * rng.standard_normal(a.shape))
    b[:, 0] = a[:, 0]
    for x, y in ((a, b), (a, a), (a, a[:5])):
        ours, ref = tvalidate.compare_traces(x, y), \
            jvalidate.compare_traces(x, y)
        assert (ours.ok, ours.n_rows, ours.per_column, ours.failures) == \
            (ref.ok, ref.n_rows, ref.per_column, ref.failures)
        assert str(ours) == str(ref)
    U = rng.random((8, 8))
    V = U * (1 + 1e-9)
    assert tvalidate.compare_fields(V, U) == jvalidate.compare_fields(V, U)
    f, g = str(tmp_path / 'u.csv'), str(tmp_path / 'v.csv')
    csvio.csv_export_matrix(U, f)
    csvio.csv_export_matrix(V, g)
    assert tvalidate.compare_solution_csvs(g, f) == \
        jvalidate.compare_solution_csvs(g, f)
    assert tvalidate.TRACE_TOLERANCES == jvalidate.TRACE_TOLERANCES
    x = tmp_path / 'x.txt'
    x.write_text('a\nb\n')
    assert tvalidate.validate_solution_files(str(x), str(x))
    assert not csvio.validate_solution_files(str(x), g)
