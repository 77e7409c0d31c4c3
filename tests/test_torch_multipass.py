"""Multi-pass (SigProp / MagRef) streams through the port's fused frame
decode (openjph_tpu_torch.decode_gpu) on the CPU, in both runner modes,
held against the JAX package's fused decode (openjph_tpu.decode_tpu) and
its host decoder (openjph_tpu.decode, clipped to the sample range as the
fused paths clip): reversible streams bit-exact, 9/7 within +-1 (the JAX
package's own tolerance for irreversible decode).  Also a two-frame
runner call on a refine plan, and the committed multi-pass fixtures
(openjph_tpu_torch/testdata/) against the encoder that made them.

Each stream compiles to one or two lane groups: the JAX reference
compiles its fused graph per lane-group shape, and that compile is most
of this file's time.
"""
import functools
import os

import numpy as np
import pytest
import torch

from openjph_tpu import decode, decode_tpu, encode

import openjph_tpu_torch
from openjph_tpu_torch.gpu import block_refine_cuda as R
from openjph_tpu_torch.gpu import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')


def _mixed(seed, h, w):
    """Noise with half its samples zero: many magnitude-1 samples for
    SigProp to reach and many significant ones for MagRef."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w)).astype(np.int32)
    img[rng.rand(h, w) < 0.5] = 0
    return img


# name -> (stream builder, exact)
STREAMS = {
    'p2': (lambda: encode(_mixed(1, 64, 64), reversible=True, num_decomps=1,
                          ht_passes=2, block_size=(32, 32)), True),
    'p3': (lambda: encode(_mixed(2, 64, 64), reversible=True, num_decomps=1,
                          ht_passes=3, block_size=(32, 32)), True),
    'p2_causal': (lambda: encode(_mixed(3, 64, 64), reversible=True,
                                 num_decomps=1, ht_passes=2,
                                 vert_causal=True, block_size=(32, 32)),
                  True),
    'p3_causal': (lambda: encode(_mixed(4, 64, 64), reversible=True,
                                 num_decomps=1, ht_passes=3,
                                 vert_causal=True, block_size=(32, 32)),
                  True),
    # edge codeblocks 3 wide and 1 tall: partial 4x4 groups
    'p3_edges': (lambda: encode(_mixed(5, 66, 70), reversible=True,
                                num_decomps=1, ht_passes=3,
                                block_size=(32, 32)), True),
    'p3_97': (lambda: encode(_mixed(6, 64, 64), reversible=False,
                             num_decomps=1, ht_passes=3,
                             block_size=(32, 32)), False),
    # multi-tile, CPRL progression (as tests/test_multipass.py builds it)
    'p3_tiles_cprl': (lambda: encode(_mixed(7, 64, 64), reversible=True,
                                     num_decomps=1, ht_passes=3,
                                     tile_size=(32, 32), block_size=(16, 16),
                                     prog_order=4), True),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    build, exact = STREAMS[name]
    stream = build()
    return (stream, exact, decode_tpu(stream),
            [np.clip(p, 0, 255) for p in decode(stream)])


def _assert_close(got, ref, exact):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if exact:
            assert np.array_equal(g, r)
        else:
            assert np.abs(g.astype(np.int64) - r).max() <= 1


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
@pytest.mark.parametrize('name', list(STREAMS))
def test_multipass_decode_matches_jax(name, raw):
    stream, exact, ref_tpu, ref_host = _case(name)
    plan = tp._build_plan(tp.GpuDecoder(stream, device='cpu'))
    assert plan.has_refine
    got = openjph_tpu_torch.decode_gpu(stream, device='cpu', raw=raw)
    _assert_close(got, ref_tpu, exact)
    _assert_close(got, ref_host, exact)


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_two_frame_refine_runner_matches_decode_tpu(raw):
    """Two different 3-pass frames of one geometry in one runner call."""
    s1 = _case('p3')[0]
    s2 = encode(_mixed(12, 64, 64), reversible=True, num_decomps=1,
                ht_passes=3, block_size=(32, 32))
    pairs = []
    for s in (s1, s2):
        d = tp.GpuDecoder(s, device='cpu', raw=raw)
        pairs.append((d, tp._build_plan(d)))
    assert pairs[0][1].key == pairs[1][1].key
    assert pairs[0][1].has_refine
    args = tp._pack_device(pairs) if raw else tp._pack_dense(pairs)
    assert len(args) == (1 if raw else 3)
    runner = tp._make_runner(pairs[0][1], 2, 'cpu', raw)
    R.reset_launches()
    errs, outs = runner(*tp.upload(args, 'cpu'))
    assert not errs.any()
    assert sum(R.LAUNCHES.values()) == 0
    for f, s in enumerate((s1, s2)):
        ref = decode_tpu(s)[0]
        assert outs[0][0].dtype == torch.uint8
        assert np.array_equal(outs[0][0][f].numpy().astype(np.int32), ref)


def test_cuda_is_the_default_for_multipass():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.decode_gpu(_case('p2')[0])


def _gray():
    return np.load(os.path.join(REPO, 'bench_data', 'gray_2048x1080.npy')) \
        .astype(np.int32)


FIXTURES = {
    'gray_2048x1080_rev_p3.j2c': lambda: encode(
        _gray(), reversible=True, num_decomps=5, ht_passes=3),
    'gray_512x256_rev_p2_causal.j2c': lambda: encode(
        _gray()[:256, :512], reversible=True, num_decomps=5, ht_passes=2,
        vert_causal=True),
}


@pytest.mark.parametrize('name', list(FIXTURES))
def test_fixture_is_the_encoders_output(name):
    with open(os.path.join(TESTDATA, name), 'rb') as fh:
        assert fh.read() == FIXTURES[name]()


def test_causal_fixture_decodes_on_cpu():
    with open(os.path.join(TESTDATA, 'gray_512x256_rev_p2_causal.j2c'),
              'rb') as fh:
        stream = fh.read()
    got = openjph_tpu_torch.decode_gpu(stream, device='cpu')
    _assert_close(got, [np.clip(p, 0, 255) for p in decode(stream)], True)
