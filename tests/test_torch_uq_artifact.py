"""The JAX package's on-chip float64 UQ run (artifacts/r5/uq_f64/tpu64-*,
the TPU's float64 arithmetic) against the JAX package's float64 run of
each member on the CPU.

``chip_smoke.py`` phase 11 (a) holds the port's E2 on the card to the
artifact's within 1e-10 plus the artifact's own distance from the CPU run
(``TPU64_E2_OWN_REL``).  This file measures that distance: as a script,
for all 16 members (the table's source, ~40 s a member)

    JAX_PLATFORMS=cpu python tests/test_torch_uq_artifact.py

and as a test for four of them (the two largest among them), pinning the
table to 1e-3 relative (the CPU run's last bits may differ between
CPUs)."""

import importlib.util
import os

import numpy as np
import pytest

import chsimpy_tpu as ct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def own_distance(cs, member) -> float:
    """The largest relative distance over the rows of the member's E2 in
    the artifact from the JAX package's float64 run on the CPU."""
    a0, a1 = list(cs.SOBOL_MATERIAL)[member]
    p = ct.Parameters()
    p.no_gui = True
    p.update_every = None
    for k, v in dict(N=512, XXX=0.89, threshold=0.89, A0_const=a0,
                     A1_const=a1,
                     kappa_tilde=cs.SOBOL_MATERIAL[(a0, a1)][4]).items():
        setattr(p, k, v)
    sol = ct.Simulator(p).solve()
    tpu = np.loadtxt(os.path.join(
        ROOT, cs.UQ64_DIR, f'tpu64-run{member}.solution.E2.csv'))
    E2 = sol.timedata.data()[:, 2]
    assert E2.shape == tpu.shape          # the same stop step
    return float(np.max(np.abs(tpu / E2 - 1)))


@pytest.mark.parametrize('member', [0, 3, 7, 9])
def test_tpu64_e2_own_distance_from_the_cpu_run(member):
    cs = _chip_smoke()
    dist = own_distance(cs, member)
    assert abs(dist / cs.TPU64_E2_OWN_REL[member] - 1) <= 1e-3, dist


if __name__ == '__main__':
    cs = _chip_smoke()
    for m in range(16):
        print(m, repr(own_distance(cs, m)), flush=True)
