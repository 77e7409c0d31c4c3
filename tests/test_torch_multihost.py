"""The port's frame fan-out across processes
(openjph_tpu_torch.parallel.multihost) on the CPU, as
tests/test_multihost.py runs the JAX package's: two gloo processes on
localhost encode a burst spread across them and decode it spread across
them; each holds the gathered bursts to its own single-process
encode_gpu_batch / decode_gpu_batch and to the frames, and the gathered
codestreams equal the JAX package's encode of the same frames.
"""
import os

import numpy as np

from openjph_tpu import encode

from openjph_tpu_torch.parallel._testing import start_ranks, wait_ranks
from openjph_tpu_torch.parallel.multihost import (_pack_planes,
                                                  _unpack_planes,
                                                  seeded_frames)

FRAMES, W, H = 5, 96, 64


def test_two_process_frame_fanout(tmp_path):
    procs = start_ranks('openjph_tpu_torch.parallel.multihost', 2,
                        ['--frames', str(FRAMES), '--size', f'{W}x{H}',
                         '--out', str(tmp_path)])
    ref = [encode([f], reversible=True, num_decomps=2)
           for f in seeded_frames(FRAMES, W, H)]
    outs = wait_ranks(procs, timeout=300)
    for out in outs:
        assert 'multihost OK' in out, out
    for t, s in enumerate(ref):
        with open(os.path.join(tmp_path, f'frame{t}.j2c'), 'rb') as fh:
            assert fh.read() == s


def test_planes_round_trip_through_a_blob():
    planes = [np.arange(12, dtype=np.uint8).reshape(3, 4),
              -np.arange(6, dtype=np.int32).reshape(2, 3),
              np.zeros((1, 5), np.uint16)]
    back = _unpack_planes(_pack_planes(planes))
    assert [b.dtype for b in back] == [p.dtype for p in planes]
    assert all(np.array_equal(a, b) for a, b in zip(back, planes))
