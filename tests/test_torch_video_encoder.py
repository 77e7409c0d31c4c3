"""The port's video encode (openjph_tpu_torch.VideoEncoder and
encode_gpu_batch) on the CPU, held against the JAX package's
encode_tpu_batch and openjph_tpu.encode (tests/test_video_encoder.py's
frames): every codestream byte-identical.
"""
import numpy as np
import pytest

from openjph_tpu import decode, encode, encode_tpu_batch

import openjph_tpu_torch
from openjph_tpu_torch.core.message import OjphError
from openjph_tpu_torch.gpu import encode_pipeline as te


@pytest.fixture(scope='module')
def rng():
    return np.random.RandomState(13)


def test_burst_byte_identical(rng):
    frames = [rng.randint(0, 256, (96, 160, 3)).astype(np.int32)
              for _ in range(8)]
    got = openjph_tpu_torch.encode_gpu_batch(frames, device='cpu',
                                             reversible=True, num_decomps=3)
    want = encode_tpu_batch(frames, reversible=True, num_decomps=3)
    assert got == want
    for i, (s, f) in enumerate(zip(got, frames)):
        assert s == encode(f, reversible=True, num_decomps=3), \
            f'frame {i} differs from openjph_tpu.encode'


def test_bucketed_odd_count(rng):
    """Seven frames: bursts of 4, 2 and 1."""
    frames = [rng.randint(0, 256, (64, 96)).astype(np.int32)
              for _ in range(7)]
    got = openjph_tpu_torch.encode_gpu_batch(frames, device='cpu',
                                             reversible=True, num_decomps=2)
    assert got == encode_tpu_batch(frames, reversible=True, num_decomps=2)
    for s, f in zip(got, frames):
        assert np.array_equal(decode(s)[0], f)


def test_pipelined_submit_collect(rng):
    ve = te.VideoEncoder(device='cpu', reversible=True, num_decomps=2)
    bursts = [[rng.randint(0, 256, (64, 96)).astype(np.int32)
               for _ in range(2)] for _ in range(3)]
    for b in bursts:
        ve.submit(b)
    assert ve.depth == 3
    for b in bursts:
        for s, f in zip(ve.collect(), b):
            assert s == encode(f, reversible=True, num_decomps=2)
    assert ve.depth == 0
    assert ve.fused_bursts == 3 and ve.fallback_bursts == 0
    ve.close()


def test_multi_tile_frame_encodes_frame_by_frame(rng):
    frames = [rng.randint(0, 256, (128, 128)).astype(np.int32)
              for _ in range(2)]
    ve = te.VideoEncoder(device='cpu', reversible=True, num_decomps=2,
                         tile_size=(64, 64))
    ve.submit(frames)
    got = ve.collect()
    assert ve.fallback_bursts == 1 and ve.fused_bursts == 0
    for s, f in zip(got, frames):
        assert s == encode(f, reversible=True, num_decomps=2,
                           tile_size=(64, 64))
    ve.close()


def test_encode_errors_surface_at_collect(rng):
    """A configuration the encoder refuses (four HT passes) raises its
    error at collect, not inside the worker; a multi-pass one (ROADMAP
    12, once refused here) gives the JAX package's codestreams."""
    frame = rng.randint(0, 256, (32, 32)).astype(np.int32)
    ve = te.VideoEncoder(device='cpu', reversible=True, num_decomps=2,
                         ht_passes=4)
    ve.submit([frame])
    with pytest.raises(OjphError, match='ht_passes must be 1, 2 or 3'):
        ve.collect()
    ve.close()
    ve = te.VideoEncoder(device='cpu', reversible=True, num_decomps=2,
                         ht_passes=2)
    ve.submit([frame, frame[::-1].copy()])
    got = ve.collect()
    ve.close()
    assert ve.fused_bursts == 1
    assert got == [encode(f, reversible=True, num_decomps=2, ht_passes=2)
                   for f in (frame, frame[::-1])]
