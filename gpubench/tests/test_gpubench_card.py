"""On the card: one short run of each cell through run.py's command
line, correct, with its result line.  Skips where there is no card."""
import json
import subprocess
import sys

import pytest

from gpubench.harness import manifest

CELLS = [w['name'] for w in manifest.load()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the benchmark runs only on the card')
    out = subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', name, '--seed',
         str(2**31 + 101), '--seconds', '2', '--trace', '0'],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    obj = json.loads(out.stdout.strip().splitlines()[-1])
    assert obj['correct'] and obj['device']['platform'] == 'gpu'


def test_run_refuses_without_a_card():
    """Without a card run.py exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ''
