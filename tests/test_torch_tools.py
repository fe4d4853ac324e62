"""The distributed tools of chsimpy_tpu_torch on the CPU: the ensemble
chunk's collective audit (``parallel/audit.py`` ``audit_ensemble_chunk``,
the JAX package's ``chsimpy_tpu/parallel/audit.py:115-160``), the scaling
benchmark under torchrun (``benchmarks/scaling.py``) and the host and
card description without psutil (``sysinfo.py``)."""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chsimpy_tpu_torch import sysinfo
from chsimpy_tpu_torch.parallel.audit import audit_ensemble_chunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('XLA_FLAGS', None)
    return env


def test_ensemble_audit_moves_scalars_only():
    """chsimpy_tpu/parallel/audit.py:115-160: on an ('ens',)-only mesh
    the members step without a collective; the chunk's sync moves the
    same bytes at N=64 and N=128, less than a field."""
    a, b = (audit_ensemble_chunk(N, 2, device='cpu', timeout=120)
            for N in (64, 128))
    assert a['n_collectives'] > 0
    assert a['total_bytes'] == b['total_bytes']
    assert a['bytes_per_step'] == b['bytes_per_step']
    assert a['max_single_collective_bytes'] < a['field_bytes']
    assert a['per_op_bytes']['all-to-all'] == 0



def test_scaling_cli_on_a_two_rank_world():
    """``--distributed`` under torchrun, gloo on the CPU: rank 0 alone
    prints one JSON line with the JAX benchmark's keys."""
    def run(axis):
        return subprocess.run(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc-per-node', '2', '-m',
             'chsimpy_tpu_torch.benchmarks.scaling', '--distributed',
             '--axis', axis, '-N', '32', '-n', '8', '--device', 'cpu',
             '--dist-backend', 'gloo'], cwd=REPO, env=_env(),
            capture_output=True, text=True, timeout=300)

    outs = {}
    with ThreadPoolExecutor(2) as pool:
        procs = dict(zip(('grid', 'ens'), pool.map(run, ('grid', 'ens'))))
    for axis, proc in procs.items():
        assert proc.returncode == 0, proc.stdout + proc.stderr
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{')]
        assert len(lines) == 1, proc.stdout
        outs[axis] = json.loads(lines[0])
    g, e = outs['grid'], outs['ens']
    assert set(g) == {'axis', 'N', 'devices', 'mesh', 'steps_per_s_1dev',
                      'steps_per_s_mesh', 'speedup', 'scaling_efficiency'}
    assert g['mesh'] == [1, 2] and g['devices'] == 2
    assert set(e) == {'axis', 'N', 'devices', 'members',
                      'member_steps_per_s_1dev', 'member_steps_per_s_mesh',
                      'speedup', 'scaling_efficiency'}
    assert e['members'] == 2
    for d in (g, e):
        assert d['speedup'] > 0 and d['scaling_efficiency'] > 0


def test_sysinfo_topology_without_psutil():
    """The card topology's keys (``chsimpy_tpu/sysinfo.py:17-90``) from
    torch, os, resource and /proc; no psutil."""
    code = ("import sys\n"
            "from chsimpy_tpu_torch import sysinfo\n"
            "info = sysinfo.get_system_info() + "
            "sysinfo.get_device_info('cpu')\n"
            "print(sysinfo.get_mem_usage(), sysinfo.get_current_localtime())\n"
            "assert 'psutil' not in sys.modules\n"
            "print('\\n'.join(info))\n")
    proc = subprocess.run([sys.executable, '-c', code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    keys = [ln.split(',')[0] for ln in proc.stdout.splitlines()[1:]]
    for k in ('cores_phys', 'cores_total', 'localtime', 'device-count',
              'local-device-count', 'process-count', 'device-kind'):
        assert k in keys, keys
    assert proc.stdout.split()[0].endswith('MiB')
    assert sysinfo.get_number_physical_cores() >= 1
    lines = dict(ln.split(', ', 1) for ln in sysinfo.get_device_info('cpu'))
    assert lines['process-count'] == '1'
    assert lines['device-kind'] == 'cpu'


def test_rank_profile_reads_a_solver_step():
    """``benchmarks/rank_profile.py`` on one CPU solver: no device
    activity, so the whole window is host gaps, given to the host's
    operations (the ozaki route's int8 products among them) and to the
    port's spans."""
    import torch

    import chsimpy_tpu_torch as ctt
    from chsimpy_tpu_torch.benchmarks.rank_profile import profile_solver
    torch.set_num_threads(2)
    s = ctt.Solver(ctt.Parameters(N=32, device='cpu', no_gui=True,
                                  kappa_tilde=2.98911291966116e-4,
                                  transform_backend='ozaki'))
    s.prepare()
    s.solve_or_resume(2)
    out = profile_solver(s, steps=2)
    assert out['device_events'] == 0 and out['device_idle_share'] == 1.0
    assert abs(out['host_gap_ms'] - out['window_ms']) < 1e-9
    gaps = dict(out['host_gaps'])
    assert 'aten::_int_mm' in gaps
    assert sum(gaps.values()) <= out['window_ms'] * (1 + 1e-9)
    assert out['wall_ms_per_step'] > 0 and out['transform'] == 'ozaki'
    named = set(gaps) | {k for k, _ in out['top_host']}
    assert named & {'ch.step', 'ch.dct2'}


def test_rank_profile_gives_each_gap_to_the_innermost_host_operation():
    """Device busy 10-20 and 30-40 us in a 0-50 window; the host in a
    collective 0-35 with a copy 22-28 inside it, a launch 40-45: the
    gaps 0-10, 20-22, 28-30 to the collective, 22-28 to the copy, 40-45
    to the launch, 45-50 to no operation."""
    from chsimpy_tpu_torch.benchmarks.rank_profile import summarize
    ev = [('gloo:all_gather', 0, 35, False), ('aten::copy_', 22, 28, False),
          ('cudaLaunchKernel', 40, 45, False), ('python tail', 50, 50, False),
          ('mu_kernel', 10, 20, True), ('slice_kernel', 30, 40, True)]
    out = summarize(ev)
    assert out['window_ms'] == 0.05 and out['device_busy_ms'] == 0.02
    assert abs(out['device_idle_share'] - 0.6) < 1e-12
    gaps = {k: round(v * 1e3, 9) for k, v in out['host_gaps']}
    assert gaps == {'gloo:all_gather': 14.0, 'aten::copy_': 6.0,
                    'cudaLaunchKernel': 5.0, '(python)': 5.0}
    assert out['top_device'] == [['mu_kernel', 0.01, 1],
                                 ['slice_kernel', 0.01, 1]]
    own = {k: round(v * 1e3, 9) for k, v in out['top_host']}
    assert own == {'gloo:all_gather': 29.0, 'aten::copy_': 6.0,
                   'cudaLaunchKernel': 5.0}
