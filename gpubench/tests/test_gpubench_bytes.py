"""The roofline's byte counts (harness/roofline.py) against hand counts
on small codestreams of the reference encoder."""
import numpy as np

from gpubench.harness import roofline
from gpubench.reference.htj2k import codec

KW = dict(bit_depth=8, reversible=True, num_decomps=1, block_size=(64, 64))


def test_block_geometry_by_hand():
    """128x64, one level, 64x64 blocks: LL, HL, LH and HH are 64x32,
    a block each."""
    img = np.random.default_rng(1).integers(0, 256, (64, 128))
    blocks = roofline.cleanup_blocks(codec.encode(img, **KW))
    assert sorted((w, h) for w, h, _ in blocks) == [(64, 32)] * 4


def test_zero_frame_reads_samples_and_writes_nothing():
    img = np.full((64, 128), 128, np.int32)  # zero after the DC shift
    stream = codec.encode(img, **KW)
    assert roofline.k2_bytes(stream) == 0
    assert roofline.k3_bytes(stream) == 4 * 64 * 128


def test_noise_frame_counts_each_byte_once():
    img = np.random.default_rng(2).integers(0, 256, (64, 128))
    stream = codec.encode(img, **KW)
    blocks = roofline.cleanup_blocks(stream)
    segs = sum(n for _, _, n in blocks)
    assert all(n > 0 for _, _, n in blocks)
    assert 0 < segs < len(stream)
    assert roofline.k2_bytes(stream) == segs + 4 * 64 * 128
    assert roofline.k3_bytes(stream) == roofline.k2_bytes(stream)
    assert roofline.least_seconds(3.35e12) == 1.0


def test_rgb_counts_three_planes():
    img = np.random.default_rng(3).integers(0, 256, (64, 128, 3))
    stream = codec.encode(img, bit_depth=8, reversible=False,
                          num_decomps=1, base_delta=0.002)
    blocks = roofline.cleanup_blocks(stream)
    assert len(blocks) == 12
    assert roofline.k3_bytes(stream) == 4 * 64 * 128 * 3 + sum(
        n for _, _, n in blocks)
