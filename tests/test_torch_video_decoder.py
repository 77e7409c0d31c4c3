"""The port's video decode (openjph_tpu_torch.VideoDecoder) on the CPU,
held against the JAX package's VideoDecoder on the same streams: 96x80
gray frames, 32x32 blocks, 3 levels (tests/test_video_decoder.py's).
Reversible decode is bit-exact; damaged bursts raise where the reference
raises and decode as it does under resilience.  Also: frames of one
geometry whose word buckets differ share one runner, two decoders run
from two threads, and the entry points raise without CUDA.
"""
import functools
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from openjph_tpu import encode
from openjph_tpu.tpu.pipeline import VideoDecoder as JaxVideoDecoder

import openjph_tpu_torch
from openjph_tpu_torch.gpu import pipeline as tp
from openjph_tpu_torch.gpu.staging import Stager

def _stream(frame):
    return encode([frame], bit_depth=8, reversible=True, num_decomps=3,
                  block_size=(32, 32))


@functools.lru_cache(maxsize=None)
def _video():
    """Eight seeded noise frames (their plans share one key) and their
    streams."""
    rng = np.random.RandomState(25)
    frames = [rng.randint(0, 256, (80, 96)).astype(np.int32)
              for _ in range(8)]
    return frames, [_stream(f) for f in frames]


def _damaged(at: float) -> bytes:
    """Frame 1's stream with 24 bytes from ``at`` of its length on
    overwritten with 0xA5."""
    bad = bytearray(_video()[1][1])
    k = int(len(bad) * at)
    bad[k:k + 24] = b'\xa5' * 24
    return bytes(bad)


def _collect(vd, bursts):
    """Submit every burst, then collect each: (frames per burst, or the
    exception's type)."""
    for b in bursts:
        vd.submit(b)
    try:
        return [vd.collect() for _ in bursts]
    except (ValueError, EOFError) as e:
        return type(e)


@functools.lru_cache(maxsize=None)
def _reference(bursts, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return _collect(JaxVideoDecoder(**kwargs), bursts)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_two_bursts_in_flight_match_the_reference(raw):
    frames, streams = _video()
    bursts = (tuple(streams[:4]), tuple(streams[:3:-1]))
    want = _reference(bursts)
    vd = tp.VideoDecoder(device='cpu', raw=raw)
    got = _collect(vd, bursts)
    assert vd.depth == 0 and vd.fused_bursts == 2
    for g, w in zip(got, want):
        _equal(g, w)
    for k in range(4):
        assert np.array_equal(got[0][k][0], frames[k])
        assert np.array_equal(got[1][k][0], frames[7 - k])
    vd.close()


def test_collect_on_device_returns_tensors():
    frames, streams = _video()
    ref = JaxVideoDecoder(to_device=True)
    ref.submit(streams[:4])
    want = np.asarray(ref.collect_on_device()[0][0])
    ref.drain_errors()
    vd = tp.VideoDecoder(device='cpu', to_device=True)
    vd.submit(streams[:4])
    outs = vd.collect_on_device()
    vd.drain_errors()
    got = outs[0][0]
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == (4, 80, 96) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert all(np.array_equal(want[k], frames[k]) for k in range(4))
    # a burst decoded frame by frame is collected on the host only
    vd.submit(streams[:3])
    with pytest.raises(ValueError, match='frame by frame'):
        vd.collect_on_device()


@pytest.mark.parametrize('at,raw', [(0.5, True), (0.5, False),
                                    (0.7, True)])
def test_damaged_burst_raises_and_resilient_matches(at, raw):
    """A burst holding a damaged frame: strict decode raises where the
    reference raises (here and, on the device path, at drain_errors),
    and resilient decode equals the reference's."""
    _, streams = _video()
    burst = (streams[0], _damaged(at), streams[2], streams[3])
    want = _reference((burst,))
    vd = tp.VideoDecoder(device='cpu', raw=raw)
    got = _collect(vd, (burst,))
    if isinstance(want, type):
        assert got is want
        dev = tp.VideoDecoder(device='cpu', to_device=True, raw=raw)
        dev.submit(burst)
        with pytest.raises(want):
            dev.collect_on_device()
            dev.drain_errors()
    else:
        _equal(got[0], want[0])
    want = _reference((burst,), resilient=True)
    vd = tp.VideoDecoder(device='cpu', resilient=True, raw=raw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = _collect(vd, (burst,))
    _equal(got[0], want[0])
    assert vd.fused_bursts == 1
    # one warning for the burst's zeroed blocks
    assert sum('0x00080006' in str(w.message) for w in caught) == \
        int(any(vd.zeroed))
    # the same lanes zeroed as frame by frame
    singles = [tp.GpuDecoder(s, device='cpu', resilient=True, raw=raw)
               for s in burst]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for d in singles:
            d.decode()
    assert vd.zeroed == tuple(sum(z) for z in zip(*(d.zeroed
                                                     for d in singles)))


def test_mixed_geometry_burst_decodes_frame_by_frame(rng):
    frames, streams = _video()
    small = rng.randint(0, 256, (40, 56)).astype(np.int32)
    vd = tp.VideoDecoder(device='cpu')
    got = _collect(vd, ([streams[0], streams[1], _stream(small),
                         streams[3]],))[0]
    assert vd.fallback_bursts == 1 and vd.fused_bursts == 0
    for g, f in zip(got, (frames[0], frames[1], small, frames[3])):
        assert np.array_equal(g[0], f)


def test_skip_res_matches_the_reference():
    _, streams = _video()
    bursts = (tuple(streams[4:]),)
    want = _reference(bursts, skip_res=1)
    got = _collect(tp.VideoDecoder(device='cpu', skip_res=1), bursts)
    _equal(got[0], want[0])
    assert got[0][0][0].shape == (40, 48)


def test_differing_word_buckets_share_a_runner():
    """A smooth frame and noise frames: one geometry, different word
    buckets, one fused burst at the larger buckets, frames as the
    sources."""
    frames, streams = _video()
    ramp = ((np.arange(96)[None, :] + np.arange(80)[:, None]) // 4) \
        .astype(np.int32)
    plans = [tp._build_plan(tp.GpuDecoder(s, device='cpu'))
             for s in (streams[0], _stream(ramp))]
    assert plans[0].key != plans[1].key
    assert tp._geometry_key(plans[0].key) == tp._geometry_key(plans[1].key)
    for raw in (True, False):
        vd = tp.VideoDecoder(device='cpu', raw=raw)
        got = _collect(vd, ([streams[0], _stream(ramp)],))[0]
        assert vd.fused_bursts == 1
        assert np.array_equal(got[0][0], frames[0])
        assert np.array_equal(got[1][0], ramp)


def test_two_decoders_in_two_threads():
    frames, streams = _video()
    results = {}

    def run(k):
        vd = tp.VideoDecoder(device='cpu', raw=bool(k),
                             stage_uploads=bool(k))
        results[k] = _collect(vd, (streams[4 * k:4 * k + 4],
                                   streams[4 * (1 - k):4 * (1 - k) + 4]))
        vd.close()

    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for k in (0, 1):
        for b, base in enumerate((4 * k, 4 * (1 - k))):
            for i in range(4):
                assert np.array_equal(results[k][b][i][0],
                                      frames[base + i])


def test_burst_runner_cache_under_contention():
    """Many threads asking for one burst runner at once get one object
    (a lost update of the cache would hand out several)."""
    _, streams = _video()
    plan = tp._build_plan(tp.GpuDecoder(streams[0], device='cpu'))
    got = []

    def ask():
        got.append(tp._burst_runner(plan, 5, torch.device('cpu'), True))

    threads = [threading.Thread(target=ask) for _ in range(32)]
    si = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(si)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 32 and len({id(r) for r in got}) == 1


def test_staging_ring_takes_free_slots_in_turn():
    st = Stager(torch.device('cpu'), slots=2, keys=2)
    a, b = st._acquire('k'), st._acquire('k')
    assert a is not b
    # both slots are being filled: the ring grows
    c = st._acquire('k')
    assert c not in (a, b) and len(st._rings['k']) == 3
    for slot in (a, b, c):
        slot.busy = False
    assert st._acquire('k') is a and st._acquire('k') is b
    # the least recently used key's ring goes past ``keys`` rings
    st._acquire('l')
    st._acquire('m')
    assert list(st._rings) == ['l', 'm']


@pytest.mark.parametrize('stage', [True, False], ids=['staged', 'pageable'])
def test_raw_pack_buffer_is_reused_where_the_upload_copies_it(stage):
    """A traced VideoDecoder over a ring of one geometry packs its raw
    bursts into one host buffer: ``decode.pack.grow`` once, inside the
    first burst's pack, and ``decode.host_prep.pack`` every burst; its
    frames equal an untraced decode's and decode_gpu's.  A pageable
    upload on the CPU aliases the packed buffer, so that decoder packs
    every burst into a fresh one and grows nothing."""
    from openjph_tpu_torch import trace
    frames, streams = _video()
    bursts = (tuple(streams[:4]), tuple(streams[4:])) * 2
    untraced = _collect(tp.VideoDecoder(device='cpu', stage_uploads=stage),
                        bursts)
    trace.reset()
    trace.enable()
    try:
        vd = tp.VideoDecoder(device='cpu', stage_uploads=stage)
        got = _collect(vd, bursts)
        vd.close()
    finally:
        trace.disable()
        stats = trace.get_stats()
        trace.reset()
    assert stats['decode.host_prep.pack']['calls'] == len(bursts)
    assert (vd._pack_out is None) == (not stage)
    if stage:
        assert stats['decode.pack.grow']['calls'] == 1
        assert stats['decode.pack.grow']['parents'] == \
            ['decode.host_prep.pack']
    else:
        assert 'decode.pack.grow' not in stats
    single = {s: openjph_tpu_torch.decode_gpu(s, device='cpu')
              for s in streams}
    for g, u, b in zip(got, untraced, bursts):
        _equal(g, u)
        _equal(g, [single[s] for s in b])
    for burst, base in zip(got, (0, 4) * 2):
        for i, planes in enumerate(burst):
            assert np.array_equal(planes[0], frames[base + i])


def test_video_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, streams = _video()
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.VideoDecoder()
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.decode_gpu_batch(streams[:2])
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.VideoEncoder()
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.encode_gpu_batch([np.zeros((8, 8), np.int32)])
