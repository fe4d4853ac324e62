"""The plain reference against an explicit cosine sum and against the
port's CPU run (the tests may import the port; the reference may not)."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from chbench.inputs import a_fit, initial_field
from chbench.reference.ch import Physics, Reference, cosine_matrix, round_tf32


def test_dct_is_the_cosine_sum():
    N = 12
    U = torch.rand((N, N), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    C = cosine_matrix(N)
    X = C @ U @ C.T
    want = np.zeros((N, N))
    for k in range(N):
        for l in range(N):
            sk = math.sqrt((1 if k == 0 else 2) / N)
            sl = math.sqrt((1 if l == 0 else 2) / N)
            want[k, l] = sk * sl * sum(
                U[m, n].item() * math.cos(math.pi * (2 * m + 1) * k / (2 * N))
                * math.cos(math.pi * (2 * n + 1) * l / (2 * N))
                for m in range(N) for n in range(N))
    np.testing.assert_allclose(X.numpy(), want, rtol=0, atol=1e-13)
    np.testing.assert_allclose((C.T @ X @ C).numpy(), U.numpy(), atol=1e-14)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12)], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                      -(1.0 + 2 ** -10)]


def test_reference_imports_nothing_of_the_port():
    for f in (Path(__file__).parents[1] / 'reference').glob('*.py'):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split('.')[0] not in ('chsimpy_tpu_torch', 'jax',
                                              'chsimpy_tpu'), (f, n)


@pytest.mark.parametrize('N', [64, 128])
def test_single_run_matches_the_port(N):
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.params import Parameters
    kt = 0.00029891134208698706
    p = Parameters(N=N, precision='float64', full_sim=True, kappa_tilde=kt,
                   device='cpu', chunk_size=16)
    U0 = initial_field(N, p.XXX, 11, 'cpu')
    s = Solver(p, U_init=U0.numpy())
    s.prepare()
    s.solve_or_resume(25)
    s.solve_or_resume(16)
    prog = s.solution.timedata.data()
    A0, A1 = a_fit(p.temp)
    ref = Reference(Physics(N=N), [A0], [A1], [kt], full_sim=True)
    r = ref.run(U0, 40, entries=(25,))
    rows = r['rows'][0]
    assert rows.shape == prog.shape
    np.testing.assert_array_equal(rows[:, 0], prog[:, 0])
    for col in (1, 2, 3, 5, 6, 7):       # E, E2, SA, Ra, L2, PS
        np.testing.assert_allclose(rows[:, col], prog[:, col], rtol=1e-11,
                                   atol=0)
    assert float((r['U'][0] - s.solution.U).abs().max()) < 1e-12


@pytest.mark.parametrize('N, delt', [(64, 1e-6), (128, 2.5e-7)])
def test_members_stop_where_the_port_stops(N, delt):
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.params import Parameters
    from chbench.kappa import kappa_tilde
    # a larger time step than the cells': stops after a few hundred steps
    p = Parameters(N=N, precision='float64', delt=delt, device='cpu',
                   chunk_size=256)
    A0, A1 = a_fit(p.temp)
    A = np.array([[A0 * 0.996, A1 * 1.004], [A0 * 1.003, A1 * 0.998]])
    kap = np.array([kappa_tilde(p.R, p.temp, p.B, a0, a1, p.XXX)
                    for a0, a1 in A])
    U0 = initial_field(N, p.XXX, 5, 'cpu')
    ens = EnsembleSolver(p, A, U_init=U0.numpy(), kappas=kap)
    ens.prepare()
    sols = ens.solve_or_resume(5000)
    ref = Reference(Physics(N=N, delt=delt), A[:, 0], A[:, 1], kap)
    r = ref.run(U0, 5000)
    for i, sol in enumerate(sols):
        assert sol.stop_reason == 'energy' and r['stopped'][i]
        assert sol.tau0 == r['tau0'][i]
        prog = sol.timedata.data()
        rows = r['rows'][i, :r['n_rows'][i]]
        assert rows.shape == prog.shape
        np.testing.assert_allclose(rows[:, [1, 2, 5, 7]],
                                   prog[:, [1, 2, 5, 7]], rtol=1e-10)
