"""The views and the live chunk loop of chsimpy_tpu_torch (``viz/``,
``simulator.py``, the CLI's view flags, the experiment's ``--png`` and
``--live-view``) against the JAX package's on the CPU, with matplotlib's
Agg backend, N=32 float64.

Bounds: one host solution pushed through both packages' views gives the
same RGBA pixels; the port's live loop equals the port's Solver resumed
at the same boundaries to the bit; against the JAX live loop the same
stop, tau0, PNG names and panel titles, E within 1e-12 relative (the two
packages' float64 matmuls sum in other orders).
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib import image as mpimg  # noqa: E402
from matplotlib import pyplot as plt  # noqa: E402

import chsimpy_tpu as ct  # noqa: E402
from chsimpy_tpu import simulator as jsim  # noqa: E402

import chsimpy_tpu_torch as ctt  # noqa: E402
from chsimpy_tpu_torch import experiment as texp  # noqa: E402
from chsimpy_tpu_torch import simulator as tsim  # noqa: E402
from chsimpy_tpu_torch.cli import CLIParser  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAPPA = 2.98911291966116e-4
BASE = dict(N=32, ntmax=30, no_gui=True, update_every=None, full_sim=True,
            generator='lcg', kappa_tilde=KAPPA)
# the stiff step of tests/test_torch_ensemble.py: the lcg field stops on
# the energy fall at step 35
STOP = dict(full_sim=False, delt=1.4e-5, ntmax=60)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


def port_params(**kw):
    return ctt.Parameters(**dict(BASE, device='cpu', **kw))


def jax_params(**kw):
    p = ct.Parameters()
    for k, v in dict(BASE, **kw).items():
        setattr(p, k, v)
    return p


def _pixels(path):
    return mpimg.imread(str(path))


def _titles(view):
    return [ax.get_title() for ax in view.fig.axes]


# ----------------------------------------------------------------------
# the same solution gives the same pixels
# ----------------------------------------------------------------------

@pytest.mark.parametrize('case', ['plotview', 'mapview', 'adaptive'])
def test_same_solution_same_pixels(case, tmp_path):
    kw = {'plotview': {}, 'mapview': dict(no_diagrams=True),
          'adaptive': dict(adaptive_time=True)}[case]
    p = port_params(**kw)
    sol = ctt.Simulator(p).solve()
    U_tensor = sol.U
    sol.U = U_tensor.numpy()        # the host solution both packages draw
    jp = jax_params(**kw)
    out = {}
    for tag, mod, params in (('jax', jsim, jp), ('port', tsim, p)):
        view = mod.build_view(params)
        view.imode_off()
        mod.push_solution_view(view, params, sol,
                               mod.solution_time_total(params, sol))
        view.render_to(str(tmp_path / f'{tag}.png'))
        out[tag] = _titles(view)
    assert out['jax'] == out['port']
    want = _pixels(tmp_path / 'jax.png')
    assert want.shape[-1] == 4 and want.std() > 0
    np.testing.assert_array_equal(_pixels(tmp_path / 'port.png'), want)
    # the card's tensor is copied to the host by the port: the same pixels
    sol.U = U_tensor
    tsim.render_solution_png(p, sol, str(tmp_path / 'tensor.png'))
    np.testing.assert_array_equal(_pixels(tmp_path / 'tensor.png'), want)


def test_push_copies_the_field_once(monkeypatch):
    sol = ctt.Simulator(port_params(ntmax=5)).solve()
    calls = []
    real = tsim.host_field

    def counting(U):
        calls.append(type(U))
        return real(U)
    monkeypatch.setattr(tsim, 'host_field', counting)
    view = tsim.build_view(port_params())
    tsim.push_solution_view(view, port_params(), sol, 1.0)
    assert calls == [torch.Tensor]
    # the three panels that draw U got the same host array
    got = view.umap.image.get_array()
    np.testing.assert_array_equal(got, sol.U.numpy())
    np.testing.assert_array_equal(view.uline.line.get_ydata(),
                                  sol.U.numpy()[17, :])


# ----------------------------------------------------------------------
# the live loop
# ----------------------------------------------------------------------

def _resumed(p, every):
    """The port's Solver entered at the live loop's boundaries."""
    s = ctt.Solver(p)
    s.prepare()
    done = 0
    while done + every <= p.ntmax:
        s.solve_or_resume(every)
        done += every
        if s.solution.stop_reason != 'None' and not p.full_sim:
            break
    return s.solution


@pytest.mark.parametrize('case', ['full_sim', 'stop'])
def test_live_loop_equals_resumed_solver(case, tmp_path, monkeypatch):
    """The live loop re-enters the solve every update_every steps and each
    entry recomputes the spectral image (reference solver.py:159): the
    Solver resumed at the same boundaries gives the same bits."""
    monkeypatch.chdir(tmp_path)
    kw = {} if case == 'full_sim' else STOP
    sim = ctt.Simulator(port_params(png=True, update_every=10,
                                    file_id='x', **kw))
    sol = sim.solve()
    ref = _resumed(port_params(**kw), 10)
    assert sol.computed_steps == ref.computed_steps == \
        (30 if case == 'full_sim' else 35)
    assert torch.equal(sol.U, ref.U)
    assert np.array_equal(sol.timedata.data(), ref.timedata.data())
    # and not a straight solve: the entries show in the bits
    straight = ctt.Simulator(port_params(**kw)).solve()
    assert not torch.equal(sol.U, straight.U)


@pytest.mark.parametrize('case', ['anim', 'stop', 'mapview', 'adaptive'])
def test_live_loop_matches_jax(case, tmp_path, monkeypatch):
    kw = {'anim': dict(png_anim=True),
          'stop': dict(STOP, png_anim=True),
          'mapview': dict(no_diagrams=True, ntmax=20),
          'adaptive': dict(adaptive_time=True)}[case]
    kw.update(png=True, update_every=10, file_id='live')
    got = {}
    for tag, mod, params in (('jax', ct, jax_params(**kw)),
                             ('port', ctt, port_params(**kw))):
        where = tmp_path / tag
        where.mkdir()
        monkeypatch.chdir(where)
        sim = mod.Simulator(params)
        sol = sim.solve()
        sim.render()
        got[tag] = (sol, sorted(os.listdir(where)), _titles(sim.view))
    (s, names, titles), (j, jnames, jtitles) = got['port'], got['jax']
    assert (s.computed_steps, s.stop_reason, s.tau0) == \
        (j.computed_steps, j.stop_reason, j.tau0)
    np.testing.assert_allclose(s.t0, j.t0, rtol=1e-12)
    assert names == jnames and 'live.png' in names
    if kw.get('png_anim'):
        n = -(-s.computed_steps // 10)
        assert names == [f'live.{i:05d}.png' for i in range(n)] + \
            ['live.png']
    assert titles == jtitles
    np.testing.assert_allclose(s.timedata.data()[:, 1],
                               j.timedata.data()[:, 1], rtol=1e-12)


# ----------------------------------------------------------------------
# behaviour
# ----------------------------------------------------------------------

def test_png_anim_series(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = ctt.Simulator(port_params(png_anim=True, update_every=10,
                                    file_id='anim', ntmax=20))
    sim.solve()
    sim.render()
    assert sorted(os.listdir(tmp_path)) == ['anim.00000.png',
                                            'anim.00001.png']
    a, b = (_pixels(tmp_path / f'anim.{i:05d}.png') for i in (0, 1))
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_tau0_fallback_without_an_energy_fall(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = ctt.Simulator(port_params(png=True, update_every=10,
                                    file_id='live'))
    sol = sim.solve()
    assert sol.computed_steps == 30 and sol.stop_reason == 'None'
    # no energy fall: the last step is reported (simulator.py)
    assert sol.tau0 == sol.computed_steps - 1
    assert sol.t0 == sim.solver.time_passed > 0
    sim.render()
    assert (tmp_path / 'live.png').exists()
    assert isinstance(sim.view, __import__(
        'chsimpy_tpu_torch.viz.plotview', fromlist=['x']).PlotView)
    # without the live loop the straight solve keeps tau0 at 0
    assert ctt.Simulator(port_params()).solve().tau0 == 0


def test_no_view_without_png_or_gui():
    sim = ctt.Simulator(port_params(update_every=10))
    assert sim.view is None and sim.params.update_every is None
    assert not sim.gui_required() and not sim.export_requested()
    sim = ctt.Simulator(port_params(png=True))
    assert sim.view is not None and sim.gui_required()
    assert not sim.gui_requested() and sim.export_requested()
    # the default run asks for the GUI: a view, the update cadence kept
    sim = ctt.Simulator(ctt.Parameters(N=16, device='cpu',
                                       kappa_tilde=KAPPA))
    assert sim.gui_requested() and sim.view is not None
    assert sim.params.update_every == 100


def test_a_view_without_matplotlib_names_it(tmp_path, monkeypatch, capsys):
    """No fallback: a run that asks for a view fails when matplotlib is
    missing, and says what to do."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    for kw in (dict(png=True), dict(no_gui=False),
               dict(png_anim=True, update_every=5)):
        with pytest.raises(ModuleNotFoundError,
                           match='matplotlib.*--no-gui'):
            ctt.Simulator(port_params(**kw))
    from chsimpy_tpu_torch.__main__ import main
    with pytest.raises(ModuleNotFoundError, match='matplotlib'):
        main(['-N', '16', '-n', '5', '--png', '--no-gui', '-K',
              str(KAPPA), '--device', 'cpu'])
    # the experiment fails before its solve, not after it
    ep = texp.ExperimentParams()
    ep.runs = 2
    with pytest.raises(ModuleNotFoundError, match='matplotlib'):
        texp.run_experiment_batch(port_params(png=True), ep,
                                  progress=False)
    assert os.listdir(tmp_path) == []
    # a run without a view does not need it
    assert ctt.Simulator(port_params()).solve().computed_steps == 30


# ----------------------------------------------------------------------
# the command line and the experiment
# ----------------------------------------------------------------------

def test_cli_view_flags(capsys):
    p = CLIParser().get_parameters(['--png', '--png-anim', '--update-every',
                                    '5', '--no-diagrams'])
    assert (p.png, p.png_anim, p.update_every, p.no_diagrams,
            p.no_gui) == (True, True, 5, True, False)
    p = CLIParser().get_parameters([])
    assert (p.png, p.png_anim, p.update_every, p.no_gui) == \
        (False, False, None, False)
    for argv, msg in ((['--update-every', '1'], '>=2'),
                      (['--png-anim'], 'requires --update-every'),
                      (['--fold-field', '--inv-band', 'x'],
                       'invalid int value')):
        with pytest.raises(SystemExit) as exc:
            CLIParser().get_parameters(argv)
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err, argv
    # the benchmark runs headless, as the JAX package's does
    from chsimpy_tpu_torch.benchmarks.bench import parse_bench_args
    assert parse_bench_args(['-N', '16'])[1].no_gui is True
    with pytest.raises(SystemExit):
        parse_bench_args(['--png'])
    assert 'headless' in capsys.readouterr().err


@pytest.mark.parametrize('flags,files', [
    (['--png'], ['vc.png']),
    (['--png-anim', '--update-every', '4', '--no-diagrams'],
     ['vc.00000.png', 'vc.00001.png']),
])
def test_cli_writes_the_pngs_jax_writes(flags, files, tmp_path, capsys,
                                        monkeypatch):
    from chsimpy_tpu.__main__ import main as jmain

    from chsimpy_tpu_torch.__main__ import main
    argv = ['-N', '16', '-n', '8', '--no-gui', '-g', 'lcg', '-K',
            str(KAPPA), '-f', 'vc'] + flags
    for tag, fn, extra in (('port', main, ['--device', 'cpu']),
                           ('jax', jmain, [])):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        if tag == 'jax':
            monkeypatch.setattr(sys, 'argv', ['chsimpy_tpu'] + argv)
            with pytest.raises(SystemExit):
                fn()
        else:
            fn(argv + extra)
        assert sorted(os.listdir(tmp_path / tag)) == files
    out = capsys.readouterr().out
    assert 'File ID = vc' in out
    for f in files:
        np.testing.assert_array_equal(_pixels(tmp_path / 'port' / f),
                                      _pixels(tmp_path / 'jax' / f))


def test_experiment_png_renders_per_run(tmp_path, monkeypatch):
    """--png writes one PNG per run (the reference renders each member,
    chsimpy/experiment.py:104-109): the pixels the JAX package's renderer
    draws for the same member."""
    monkeypatch.chdir(tmp_path)
    p = port_params(N=32, ntmax=15)
    p.file_id, p.yaml, p.export_csv, p.png = 'pngexp', False, None, True
    ep = texp.ExperimentParams()
    ep.runs, ep.A_seed, ep.host_procs = 2, 85972, 1
    assert len(texp.run_experiment_batch(p, ep, progress=False)) == 2
    fac = texp.generate_A_factors(ep)
    pairs = fac * [p.func_A0(p.temp), p.func_A1(p.temp)]
    ens = texp.EnsembleSolver(port_params(N=32, ntmax=15), pairs)
    ens.prepare()
    for r, sol in enumerate(ens.solve_or_resume(15)):
        png = tmp_path / f'pngexp-run{r}.png'
        assert png.exists() and png.stat().st_size > 1000
        sol.U = sol.U.numpy()
        jsim.render_solution_png(jax_params(N=32), sol,
                                 str(tmp_path / f'jax{r}.png'))
        np.testing.assert_array_equal(_pixels(png),
                                      _pixels(tmp_path / f'jax{r}.png'))


class _Recorder:
    """A stand-in MapView that records each refresh."""
    made = []

    def __init__(self, N):
        self.N = N
        self.frames = []
        self.draws = 0
        _Recorder.made.append(self)

    def prepare(self, show=True):
        pass

    def imode_on(self):
        pass

    def show(self, block=False):
        pass

    def finish(self):
        self.finished = True

    def set_Umap(self, U, threshold, title):
        self.frames.append((U, threshold, title))

    def draw(self):
        self.draws += 1


@pytest.mark.parametrize('N,stride', [(16, 1), (1030, 3)])
def test_experiment_live_view_refreshes(N, stride, monkeypatch):
    """--live-view: member 0's map once a chunk of update_every steps, at
    most 512 pixels a side; the rows do not change with the chunk."""
    from chsimpy_tpu_torch.viz import mapview
    _Recorder.made = []
    monkeypatch.setattr(mapview, 'MapView', _Recorder)
    ntmax = 21 if N == 16 else 3

    def run(live):
        p = port_params(N=N, ntmax=ntmax, update_every=5 if N == 16 else 2)
        p.yaml, p.export_csv = False, None
        ep = texp.ExperimentParams()
        ep.runs, ep.A_seed, ep.host_procs, ep.live_view = 2, 85972, 1, live
        return texp.run_experiment_batch(p, ep, progress=False)
    rows = run(True)
    (view,) = _Recorder.made
    steps = [6, 11, 16, 21] if N == 16 else [3]
    assert view.draws == len(view.frames) == len(steps)
    assert [t for _, _, t in view.frames] == \
        [f'member 0 | step {s}' for s in steps]
    side = -(-N // stride)
    assert all(isinstance(U, np.ndarray) and U.shape == (side, side)
               for U, _, _ in view.frames)
    assert view.finished
    if N == 16:
        assert rows == run(False)


def test_experiment_refuses_png_anim_and_needs_update_every(capsys):
    for argv, msg in ((['--png-anim', '--update-every', '5'],
                       '--png-anim is not allowed'),
                      (['--live-view'], '--live-view requires')):
        with pytest.raises(SystemExit):
            texp.ExperimentCLIParser().get_parameters(['-R', '2', *argv])
        assert msg in capsys.readouterr().err
    ep, p = texp.ExperimentCLIParser().get_parameters(
        ['-R', '2', '--png', '--live-view', '--update-every', '5'])
    assert (ep.live_view, p.png, p.update_every, p.no_gui) == \
        (True, True, 5, True)


def test_imports_bring_in_no_jax_and_no_matplotlib():
    code = ("import sys\n"
            "import chsimpy_tpu_torch.simulator\n"
            "import chsimpy_tpu_torch.experiment\n"
            "import chsimpy_tpu_torch.__main__\n"
            "import chsimpy_tpu_torch.viz.plotview\n"
            "import chsimpy_tpu_torch.viz.mapview\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'chsimpy_tpu', 'matplotlib', 'seaborn')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT,
                   env=env, timeout=120)
