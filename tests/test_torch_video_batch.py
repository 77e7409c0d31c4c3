"""The port's batch decode (openjph_tpu_torch.decode_gpu_batch) on the
CPU, held against the JAX package's decode_tpu_batch: seven frames of
one geometry (bursts of 4, 2 and 1) and the committed 2-pass causal
stream, bit-exact.  The frames are small (48x40, one level) because the
reference traces one graph per burst size.  Also bursts that mix pass
counts or hold a cut frame, against the port's frame-by-frame decode.
"""
import os

import numpy as np
import pytest

from openjph_tpu import encode
from openjph_tpu.tpu.pipeline import decode_tpu_batch

import openjph_tpu_torch
from openjph_tpu_torch.gpu import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUSAL2 = os.path.join(REPO, 'openjph_tpu_torch', 'testdata',
                       'gray_512x256_rev_p2_causal.j2c')


def test_decode_gpu_batch_matches_decode_tpu_batch():
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 256, (40, 48)).astype(np.int32)
              for _ in range(7)]
    streams = [encode([f], reversible=True, num_decomps=1,
                      block_size=(32, 32)) for f in frames]
    # one key: the reference batches them 4 + 2 + 1 too
    assert len({tp._build_plan(tp.GpuDecoder(s, device='cpu')).key
                for s in streams}) == 1
    with open(CAUSAL2, 'rb') as fh:
        batch = streams + [fh.read()]
    want = decode_tpu_batch(batch)
    got = openjph_tpu_torch.decode_gpu_batch(batch, device='cpu')
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape and np.array_equal(a, b)
    for g, f in zip(got, frames):
        assert np.array_equal(g[0], f)


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_decode_gpu_batch_merges_pass_counts_and_damage(raw):
    """Frame by frame equals one burst: the 2-pass causal stream with a
    single-pass frame of its geometry (the burst takes the refinement
    word buckets), and resilient frames with a cut one."""
    with open(CAUSAL2, 'rb') as fh:
        causal = fh.read()
    img = np.load(os.path.join(REPO, 'bench_data', 'gray_2048x1080.npy'))
    single = encode(img[:256, :512].astype(np.int32), reversible=True,
                    num_decomps=5)
    plans = [tp._build_plan(tp.GpuDecoder(s, device='cpu'))
             for s in (causal, single)]
    assert tp._geometry_key(plans[0].key) == tp._geometry_key(plans[1].key)
    assert plans[0].has_refine and not plans[1].has_refine
    rng = np.random.RandomState(4)
    small = [encode([rng.randint(0, 256, (40, 48)).astype(np.int32)],
                    reversible=True, num_decomps=1, block_size=(32, 32))
             for _ in range(2)]
    small[1] = small[1][:len(small[1]) * 3 // 4]
    batch = [causal, single] + small
    got = openjph_tpu_torch.decode_gpu_batch(batch, device='cpu', raw=raw,
                                             resilient=True)
    for g, s in zip(got, batch):
        want = openjph_tpu_torch.decode_gpu(s, device='cpu', raw=raw,
                                            resilient=True)
        assert len(g) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(g, want))
