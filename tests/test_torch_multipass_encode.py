"""Multi-pass (SigProp / MagRef) encode in the port (ROADMAP 12) on the
CPU, held against the JAX package: the refinement-pass encoder's plain
version (K5, gpu/block_refine_encode.py) lane by lane against
coding/encoder.py::encode_spp_mrp, and every encode entry point
(``encode``, ``encode_gpu``, ``GpuEncoder``, ``encode_gpu_batch``,
``VideoEncoder``) with ``ht_passes`` 2 and 3 against openjph_tpu.encode,
byte for byte from the first SOT, 9/7 included; each port stream decodes
on the port's CPU path to what openjph_tpu.decode gives.  Also the
committed fixture whose codeblocks take both choices (kept passes, and
the cleanup-only choice), and the plan key that keeps a 1-pass and a
multi-pass runner apart.
"""
import functools
import os

import numpy as np
import pytest
import torch

from openjph_tpu import codec as jcodec
from openjph_tpu import decode, encode
from openjph_tpu.coding.encoder import encode_spp_mrp

import openjph_tpu_torch
from openjph_tpu_torch.codec import build_encoder
from openjph_tpu_torch.core.geometry import build_tile, build_tile_grid
from openjph_tpu_torch.gpu import block_refine_encode as P
from openjph_tpu_torch.gpu import encode_pipeline as te
from openjph_tpu_torch.parallel._testing import (MIXED_PASSES,
                                                 MIXED_PASSES_KWARGS,
                                                 mixed_passes_source)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')


def _from_sot(s: bytes) -> bytes:
    return s[s.index(b'\xff\x90'):]


# ---------------------------------------------------------------------------
# K5's plain version against encode_spp_mrp
# ---------------------------------------------------------------------------

def _lanes(seed, w, h, hp, n):
    """n seeded codeblocks of w x h in a zero-padded [n, hp, wp] batch and
    their p (2 to 30): noise of every plane count, blocks whose last
    plane is all ones around sparse significant samples (long runs of
    ones: 0xFF bytes in SigProp, 0x7F in MagRef), sparse blocks."""
    rng = np.random.RandomState(seed)
    wp = (w + 3) // 4 * 4
    buf = np.zeros((n, hp, wp), np.uint32)
    ps = np.arange(n) % 29 + 2
    rng.shuffle(ps)
    for i, p in enumerate(ps):
        lsb = 1 << (int(p) - 1)  # the magnitude's last plane, p - 1
        kind = i % 3
        if kind == 0:
            planes = 32 - int(p)
            mag = rng.randint(0, 1 << min(planes, 16), (h, w)) \
                .astype(np.uint64) * lsb
            mag[rng.rand(h, w) < rng.rand()] = 0
        elif kind == 1:
            mag = np.full((h, w), lsb, np.uint64)
            mag[rng.rand(h, w) < 0.05] |= 2 * lsb
        else:
            mag = ((rng.rand(h, w) < 0.3) * 3 * lsb).astype(np.uint64)
        neg = rng.rand(h, w) < (0.95 if kind == 1 else 0.5)
        buf[i, :h, :w] = (np.minimum(mag, (1 << 31) - 1)
                          | (neg & (mag != 0)).astype(np.uint64) << 31)
    return buf, ps.astype(np.int32)


def _k5(buf, ps, h_lim, npasses, causal, w, hp, cap=None):
    n = buf.shape[0]
    return P.encode_refine_core(
        torch.from_numpy(np.ascontiguousarray(buf).view(np.int32)),
        torch.from_numpy(ps), torch.from_numpy(np.asarray(h_lim, np.int32)),
        torch.full((n,), npasses, dtype=torch.int32), causal, w, hp,
        cap or P.cap_words(w, hp))


def _hold_lanes(buf, ps, h_lim, npasses, causal, w, hp):
    out, lens, ovf = _k5(buf, ps, h_lim, npasses, causal, w, hp)
    raw = out.numpy().view(np.uint8).reshape(buf.shape[0], -1)
    assert not ovf.any()
    for i in range(buf.shape[0]):
        want = encode_spp_mrp(buf[i], 30 - int(ps[i]), w, int(h_lim[i]),
                              num_passes=npasses, stripe_causal=causal)
        n = int(lens[i].sum())
        assert bytes(raw[i, :n]) == want, (i, int(ps[i]), npasses, causal)
        assert not raw[i, n:].any()
        if npasses == 2:
            assert int(lens[i, 1]) == 0


# (width, height, group height): a short block in a taller group last
K5_SHAPES = [(64, 64, 64), (32, 32, 32), (4, 64, 64), (64, 4, 4),
             (13, 7, 8), (1, 1, 2), (32, 19, 32)]


@pytest.mark.parametrize('w,h,hp', K5_SHAPES,
                         ids=[f'{w}x{h}_in_{hp}' for w, h, hp in K5_SHAPES])
def test_k5_plain_matches_encode_spp_mrp(w, h, hp):
    """Every lane's segment, 2 and 3 passes, causal off and on, p from 2
    to 30 (on the blocks of more than 256 samples a spread of it)."""
    n = 29 if w * h <= 256 else 6
    buf, ps = _lanes(w * 131 + h, w, h, hp, n)
    for npasses in (2, 3):
        for causal in (False, True):
            _hold_lanes(buf, ps, [h] * n, npasses, causal, w, hp)


def test_k5_plain_empty_segments():
    """The reference's empty cases: the only non-zero magnitude at plane
    p - 1 (3 passes), and a 4x4 block all significant in the cleanup
    pass (empty at 2 passes, MagRef's bits at 3)."""
    p = 20
    lone = np.zeros((1, 4, 4), np.uint32)
    lone[0, 1, 2] = 1 << (p - 1)
    full = np.full((1, 4, 4), 5 << p, np.uint32)
    full[0, 0, 0] |= 1 << 31
    ps = np.array([p], np.int32)
    for buf, npasses, nbytes in ((lone, 3, 0), (lone, 2, 0), (full, 2, 0),
                                 (full, 3, 2)):
        _, lens, _ = _k5(buf, ps, [4], npasses, False, 4, 4)
        assert int(lens.sum()) == nbytes
        assert len(encode_spp_mrp(buf[0], 30 - p, 4, 4,
                                  num_passes=npasses)) == nbytes
        _hold_lanes(buf, ps, [4], npasses, False, 4, 4)


def test_k5_plain_gates_lanes():
    """npasses below 2 codes nothing; rows at or past h_lim are not
    part of the block, whatever they hold."""
    buf, ps = _lanes(9, 32, 32, 32, 6)
    out, lens, _ = _k5(buf, ps, [32] * 6, 1, False, 32, 32)
    assert not lens.any() and not out.any()
    tall = buf.copy()
    tall[:, 20:] = 0xFFFF0000
    cap = P.cap_words(32, 32)
    got = _k5(tall, ps, [20] * 6, 3, False, 32, 32)
    want = _k5(buf[:, :20], ps, [20] * 6, 3, False, 32, 20, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# frames through the entry points
# ---------------------------------------------------------------------------

def _noise(seed, shape, hi=256, zero=0.4):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, hi, shape).astype(np.int64)
    img[rng.rand(*shape) < zero] = 0
    return img


def _via_gpu_encoder(img, **kw):
    img = img if img.ndim == 3 else img[..., None]
    planes = [np.ascontiguousarray(img[..., c]) for c in range(img.shape[2])]
    enc = build_encoder(planes[0].shape, len(planes),
                        functools.partial(te.GpuEncoder, device='cpu'), **kw)
    return enc.encode(planes)


def _via_encode(img, **kw):
    return openjph_tpu_torch.encode(img, device='cpu', **kw)


def _via_encode_gpu(img, **kw):
    return openjph_tpu_torch.encode_gpu(img, device='cpu', **kw)


# name -> (source, keywords, entry point)
FRAMES = {
    'gray_53': (lambda: _noise(1, (40, 56)), dict(reversible=True,
                                                  num_decomps=3),
                _via_encode_gpu),
    'rgb_rct': (lambda: _noise(2, (32, 40, 3)),
                dict(reversible=True, num_decomps=2), _via_encode),
    'rgb_97_ict': (lambda: _noise(3, (32, 40, 3)),
                   dict(reversible=False, num_decomps=2), _via_gpu_encoder),
    'bits12': (lambda: _noise(4, (32, 48), hi=4096),
               dict(reversible=True, num_decomps=2, bit_depth=12),
               _via_encode_gpu),
    'causal': (lambda: _noise(5, (40, 40)),
               dict(reversible=True, num_decomps=2, vert_causal=True),
               _via_gpu_encoder),
    # edge codeblocks 6 and 2 wide, 3 and 1 tall
    'bs32': (lambda: _noise(6, (38, 34)),
             dict(reversible=True, num_decomps=1, block_size=(32, 32)),
             _via_encode_gpu),
    'bs4x64': (lambda: _noise(7, (16, 128)),
               dict(reversible=True, num_decomps=1, block_size=(4, 64)),
               _via_encode_gpu),
    'tiles_rpcl': (lambda: _noise(8, (32, 64)),
                   dict(reversible=True, num_decomps=2, tile_size=(32, 32),
                        prog_order='RPCL'), _via_encode),
    # 29 bits: the wide bands stay cleanup-only on K3-64, a narrow one
    # takes the refinement passes
    'bits29': (lambda: _noise(9, (48, 64), hi=1 << 29),
               dict(reversible=True, num_decomps=5, bit_depth=29),
               _via_encode_gpu),
}


def _kinds(stream):
    """Coded codeblocks of a stream by pass count, as the JAX package's
    Tier-2 parses them."""
    kinds = {}
    for st in jcodec.Decoder(stream).tiles:
        for per_res in st.coded:
            for per_band in per_res:
                for cb in [c for blocks in per_band if blocks
                           for c in blocks]:
                    if cb is not None and cb.data:
                        kinds[cb.num_passes] = kinds.get(cb.num_passes,
                                                         0) + 1
    return kinds


def _hold_frame(img, via, **kw):
    got = via(img, **kw)
    want = encode(img, **kw)
    assert _from_sot(got) == _from_sot(want)
    back = openjph_tpu_torch.decode(got, device='cpu')
    ref = decode(want)
    assert len(back) == len(ref)
    bd = kw.get('bit_depth', 8)
    for a, b in zip(back, ref):
        # a multi-pass stream is not lossless, and the fused decode clips
        # to the sample range where the host decoder does not, except on
        # a frame with a band of more than 30 bit planes (ROADMAP.md,
        # Queue C); 9/7 within +-1
        if bd <= 28:
            b = np.clip(b, 0, (1 << bd) - 1)
        if kw.get('reversible', True):
            assert np.array_equal(a, b)
        else:
            assert np.abs(a.astype(np.int64) - b).max() <= 1
    return got


@pytest.mark.parametrize('passes', [2, 3])
@pytest.mark.parametrize('name', list(FRAMES))
def test_frame_matches_jax_encode(name, passes):
    make, kw, via = FRAMES[name]
    got = _hold_frame(make(), via, ht_passes=passes, **kw)
    kinds = _kinds(got)
    assert kinds.get(passes, 0) > 0
    if name == 'bits29':
        assert kinds.get(1, 0) > 0  # the wide bands' codeblocks


def test_cleanup_only_choice_fires():
    """Codeblocks with no sample significant one plane coarser have no
    refinement bits: coded cleanup-only at kmax - 1, beside kept
    multi-pass ones in the same lane group."""
    img = mixed_passes_source()[:32, 64:192]
    for passes in (2, 3):
        got = _hold_frame(img, _via_encode_gpu, reversible=True,
                          num_decomps=2, block_size=(32, 32),
                          ht_passes=passes)
        assert _kinds(got) == {passes: 8, 1: 2}


def test_mixed_passes_fixture_is_the_jax_encode():
    """The committed fixture (openjph_tpu_torch/testdata/README.md) is
    still what its call gives, it holds both kinds of codeblock, and the
    port encodes its source to it."""
    with open(os.path.join(TESTDATA, MIXED_PASSES + '.j2c'), 'rb') as fh:
        fixture = fh.read()
    img = mixed_passes_source()
    assert encode(img, **MIXED_PASSES_KWARGS) == fixture
    assert _kinds(fixture) == {3: 26, 1: 6}
    got = _via_encode_gpu(img, **MIXED_PASSES_KWARGS)
    assert _from_sot(got) == _from_sot(fixture)


def test_burst_and_video_encoder_match_jax():
    frames = [_noise(20 + i, (32, 48)).astype(np.int32) for i in range(3)]
    kw = dict(reversible=True, num_decomps=2, ht_passes=3)
    want = [encode(f, **kw) for f in frames]
    got = openjph_tpu_torch.encode_gpu_batch(frames, device='cpu', **kw)
    assert [_from_sot(s) for s in got] == [_from_sot(s) for s in want]
    ve = te.VideoEncoder(device='cpu', **kw)
    try:
        ve.submit(frames[:2])
        ve.submit(frames[2:])
        got = ve.collect() + ve.collect()
        assert ve.fused_bursts == 2 and ve.fallback_bursts == 0
    finally:
        ve.close()
    assert [_from_sot(s) for s in got] == [_from_sot(s) for s in want]


def test_plan_key_separates_passes_and_causality():
    """A 1-pass and a multi-pass plan of one geometry, or two that differ
    in the stripe-causal mode, never share a cached runner."""
    keys, plans = set(), []
    for kw in (dict(), dict(ht_passes=2), dict(ht_passes=3),
               dict(ht_passes=3, vert_causal=True)):
        enc = build_encoder((64, 64), 1, functools.partial(te.GpuEncoder,
                                                           device='cpu'),
                            reversible=True, num_decomps=2, **kw)
        plan = enc._build_enc_plan(build_tile(enc.hdr, 0,
                                              build_tile_grid(enc.siz)[0]))
        keys.add(plan.key)
        plans.append(plan)
    assert len(keys) == 4
    assert all(g.rcap == 0 and not any(g.multi) for g in plans[0].groups)
    for plan in plans[1:]:
        for g in plan.groups:
            assert all(g.multi) and g.rcap % te._CHUNK == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    dev = torch.device('cuda', 0)
    for w, h, hp in K5_SHAPES:
        buf, ps = _lanes(w + h, w, h, hp, 29)
        args = (torch.from_numpy(buf.view(np.int32)), torch.from_numpy(ps),
                torch.full((29,), h, dtype=torch.int32),
                torch.full((29,), 3, dtype=torch.int32))
        cap = P.cap_words(w, hp)
        for causal in (False, True):
            want = P.encode_refine_core(*args, causal, w, hp, cap)
            got = R5.encode_refine(*[a.to(dev) for a in args], causal, w,
                                   hp, cap)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
