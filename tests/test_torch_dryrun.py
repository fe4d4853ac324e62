"""The dry run of the distributed solve (``parallel/dryrun.py``
``dryrun_multichip``, the port's counterpart of ``__graft_entry__.py``'s)
on a world of 8 gloo ranks on the CPU: stage 1 (the ensemble on an
('ens' 2, 2, 2) mesh against the unsharded ensemble), the flagship routes
on a 2x4 grid across the energy stop at step 534, and ens-only."""

import torch

from chsimpy_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(2)


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    lines = dryrun_multichip(8, device='cpu', backend='gloo', timeout=600,
                             threads=1)
    out = capsys.readouterr().out
    assert lines[0].startswith('dryrun stage 1 ok') and "(2, 2, 2)" in lines[0]
    for label in ('pencil split f64', 'pencil ozaki f64', 'grid matmul f64',
                  'pencil split f32'):
        line = next(ln for ln in lines if ln.startswith(label))
        assert 'PASS (mesh (2, 4)' in line, line
    assert 'energy stop at step 534 == one device' in lines[1]
    assert lines[-1].startswith('ens-only f64: PASS (ens=8')
    assert all(ln in out for ln in lines)
