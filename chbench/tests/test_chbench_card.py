"""Every listed cell, run on the card with a short window, is correct,
and its traced run reads every per-layer metric it lists.

    python -m pytest chbench/tests/test_chbench_card.py
"""

import json
from pathlib import Path

import pytest

from chbench.harness import run_cell

pytestmark = pytest.mark.cuda

BENCH = json.loads(
    (Path(__file__).resolve().parents[2] / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('cell', CELLS)
def test_a_short_traced_run_is_correct(cell, card):
    result, check = run_cell(cell, 77, 6.0, trace=True, device=card)
    assert result['correct'], check
    want = {m['name'] for m in BENCH['per_layer']
            if cell in m['workloads']}
    assert set(result['metrics']) == want
    dev = result['device']
    assert dev['platform'] == 'gpu' and 0 < dev['busy_s'] <= dev['window_s']
