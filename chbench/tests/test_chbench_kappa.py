"""The benchmark's NumPy common-tangent solve against upstream's sympy
solve (``chsimpy_tpu_torch.material``)."""

import pytest

from chbench.inputs import a_fit
from chbench.kappa import kappa_tilde

R, T, B = 0.0083144626181532, 923.15, 12.86


def test_the_default_run_s_kappa():
    a0, a1 = a_fit(T)
    assert kappa_tilde(R, T, B, a0, a1, 0.875) == pytest.approx(
        0.00029891134208698706, rel=1e-11)


@pytest.mark.parametrize('f0, f1', [(0.995, 1.005), (1.005, 0.995),
                                    (1.0, 1.0), (0.9972, 1.0031)])
def test_members_kappa_is_sympy_s(f0, f1):
    pytest.importorskip('sympy')
    from chsimpy_tpu_torch import material
    a0, a1 = a_fit(T)
    want = material.get_distance_common_tangent(
        R=R, T=T, B=B, a0=a0 * f0, a1=a1 * f1, at=0.89) \
        / (0.1602564 * 64) ** 2
    assert kappa_tilde(R, T, B, a0 * f0, a1 * f1, 0.89) == pytest.approx(
        want, rel=1e-11)
