"""The check's control: the reference (or the program's own path) one
precision below the configuration's, put in the program's place, has to
come out as not correct.  Here at N=64 on the CPU; on the card at the
cells' own sizes by ``python -m chbench.calibrate``."""

import pytest

from chbench.harness import run_cell


@pytest.mark.parametrize('cell', ['fast_tiny.n64', 'uq_tiny.p_auto'])
@pytest.mark.parametrize('seed', [1, 2])
def test_the_control_fails(cell, seed, tiny_root):
    seconds = 3.0 if cell.startswith('uq') else 0.5
    result, check = run_cell(cell, seed, seconds, device='cpu',
                             root=tiny_root, control=True)
    assert result['correct'] is False, check
