"""The port's upload A/B tool (openjph_tpu_torch.tools.ab_upload, the
JAX package's tools/ab_upload.py on the port): its copy of the
benchmark's frames and burst size against bench.py's, a tiny run of all
three strategies on the CPU (the kernels' plain versions), and the
refusal of a CUDA request without a card.  The card runs it at full size
in chip_smoke.py's ab_upload phase."""
import math

import numpy as np
import pytest
import torch

import bench
from openjph_tpu_torch.tools import ab_upload


def test_frames_are_the_benchmarks(monkeypatch):
    assert (ab_upload.W, ab_upload.H, ab_upload.NFRAMES, ab_upload.MP) == \
        (bench.W, bench.H, bench.NFRAMES, bench.MP)
    # the same code at a smaller frame size, in both modules
    for mod in (ab_upload, bench):
        monkeypatch.setattr(mod, 'W', 96)
        monkeypatch.setattr(mod, 'H', 40)
    mine, theirs = ab_upload.make_frames(), bench.make_frames()
    assert [len(s) for s in mine] == [len(s) for s in theirs] == [8, 8]
    for a, b in zip(sum(mine, []), sum(theirs, [])):
        assert a.dtype == b.dtype and a.shape == b.shape == (40, 96)
        np.testing.assert_array_equal(a, b)


def test_ab_upload_runs_tiny_on_the_cpu():
    rng = np.random.RandomState(3)
    frames = [[rng.randint(0, 256, (16, 24)).astype(np.int32)
               for _ in range(2)] for _ in range(2)]
    lines = []
    res = ab_upload.main(frames=frames, rounds=1, device='cpu',
                         log=lines.append)
    assert res['last_equal']
    assert res['mp_per_burst'] == 2 * 16 * 24 / 1e6
    row, = res['rounds']
    assert sorted(row) == sorted(ab_upload.STRATEGIES)
    assert all(v > 0 and math.isfinite(v) for v in row.values())
    assert lines[0].startswith('encoded 4 frames')
    assert lines[2] == '-- round 0' and len(lines) == 6


def test_ab_upload_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        ab_upload.main(frames=[[np.zeros((8, 8), np.int32)]] * 2)
