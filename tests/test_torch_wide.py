"""Codeblocks of more than 30 bit planes (ROADMAP 7c) through the port on
the CPU (``device='cpu'``: the kernels' plain versions), held exactly
against the JAX package: 5/3 is reversible and the coders are bit-exact,
so every comparison is equality.

- Frames: openjph_tpu.decode (the host Decoder, which the JAX package's
  TpuDecoder hands such frames to) gives the values and the dtype,
  unclamped; openjph_tpu.encode gives the bytes from the first SOT on.
  tests/test_highbit.py's cases (30-32 bits, signed and unsigned, 2
  levels), 29 bits at 5 levels, 30 bits at 1 level, 32-bit RGB through
  the RCT at 5 levels, skip_res=1 and the dense runner mode.
- The plain 64-bit coders: the cleanup decoder and the refinement
  decoder against openjph_tpu.coding.decoder.decode_codeblock, the
  cleanup encoder against openjph_tpu.coding.encoder.encode_codeblock
  (bits=64), on seeded codeblocks that reach the u_q extension, and the
  committed multi-pass 64-bit codeblocks.
- A narrow band's lane raised past 29 missing MSBs by a corrupt packet
  header, which the host decoder decodes in 64 bits, in both modes.
- Bursts, MosaicEncoder.encode, and native.encode_codeblock.
- The committed fixtures of openjph_tpu_torch/testdata/ (the card's
  oracles): still what their sources give; a 32-bit stream of 3-pass
  codeblocks through the port's 64-bit refinement decode.  Run as a script, this file
  rewrites them: JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
  tests/test_torch_wide.py
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import openjph_tpu
from openjph_tpu import native as jnative
from openjph_tpu.coding import decoder as jdecoder
from openjph_tpu.coding import encoder as jencoder
from openjph_tpu.core import message as jmsg
from openjph_tpu.parallel.tiles import MosaicEncoder as JaxMosaicEncoder

import openjph_tpu_torch
from openjph_tpu_torch import native
from openjph_tpu_torch.codec import build_encoder
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.core.geometry import build_tile, build_tile_grid
from openjph_tpu_torch.gpu import block_decode as plain
from openjph_tpu_torch.gpu import block_decode_cuda as K
from openjph_tpu_torch.gpu import block_encode_cuda as E
from openjph_tpu_torch.gpu import block_refine_cuda as R
from openjph_tpu_torch.gpu import encode_pipeline as ep
from openjph_tpu_torch.gpu import pipeline as tp
from openjph_tpu_torch.native import (prep_cleanup_streams,
                                     prep_refine_streams)
from openjph_tpu_torch.gpu.encode_pipeline import _ebucket
from openjph_tpu_torch.parallel import MosaicEncoder, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')
SOT = b'\xff\x90'


def _noise(seed, shape, bd, signed):
    lo, hi = (-(1 << (bd - 1)), 1 << (bd - 1)) if signed else (0, 1 << bd)
    return np.random.RandomState(seed).randint(lo, hi, shape,
                                               dtype=np.int64)


# name -> (planes, encode keywords, decode keywords)
FRAMES = {
    **{f'{bd}{"s" if sg else "u"}_l2': (
        [_noise(bd + 2 * sg, (32, 32), bd, sg)],
        dict(bit_depth=bd, is_signed=sg, reversible=True, num_decomps=2), {})
       for bd in (30, 31, 32) for sg in (False, True)},
    '29u_l5': ([_noise(29, (48, 64), 29, False)],
               dict(bit_depth=29, reversible=True, num_decomps=5), {}),
    '30u_l1': ([_noise(301, (32, 48), 30, False)],
               dict(bit_depth=30, reversible=True, num_decomps=1), {}),
    'rgb32_rct_l5': ([_noise(50 + c, (32, 48), 32, False) for c in range(3)],
                     dict(bit_depth=32, reversible=True, num_decomps=5), {}),
    '32u_l2_skip1': ([_noise(7, (48, 40), 32, False)],
                     dict(bit_depth=32, reversible=True, num_decomps=2),
                     dict(skip_res=1)),
    '32s_l2_dense': ([_noise(8, (32, 40), 32, True)],
                     dict(bit_depth=32, is_signed=True, reversible=True,
                          num_decomps=2), dict(raw=False)),
}


def _from_sot(s: bytes) -> bytes:
    return s[s.index(SOT):]


@functools.lru_cache(maxsize=None)
def _stream(name):
    planes, kw, _ = FRAMES[name]
    return openjph_tpu.encode(planes, **kw)


def _equal_planes(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        assert np.array_equal(g, r)


@pytest.mark.parametrize('name', sorted(FRAMES))
def test_frame_decode_matches_the_host_decoder(name):
    planes, _, dkw = FRAMES[name]
    s = _stream(name)
    skip = dkw.get('skip_res', 0)
    ref = openjph_tpu.decode(s, skip_res=skip)
    if not skip:
        _equal_planes(ref, [p.astype(r.dtype) for p, r in zip(planes, ref)])
    _equal_planes(openjph_tpu_torch.decode(s, device='cpu', **dkw), ref)


@pytest.mark.parametrize('name', sorted(n for n in FRAMES
                                        if not FRAMES[n][2]))
def test_frame_encode_matches_the_jax_encoder(name):
    planes, kw, _ = FRAMES[name]
    got = openjph_tpu_torch.encode(planes, device='cpu', **kw)
    assert _from_sot(got) == _from_sot(_stream(name))


# ---------------------------------------------------------------------------
# The plain 64-bit coders against the JAX package's scalar coders
# ---------------------------------------------------------------------------

def _patterns(rng, w, h, kmax, zero=0.3):
    """Sign-magnitude uint64 samples of a band of ``kmax`` bit planes: a
    random number of magnitude bits, some samples zero."""
    top = int(rng.randint(1, kmax + 1))
    mag = rng.randint(0, 1 << 62, (h, w), dtype=np.int64).astype(np.uint64) \
        >> np.uint64(62 - min(top, 62))
    mag[rng.rand(h, w) < zero] = 0
    sign = np.where((rng.rand(h, w) < 0.5) & (mag != 0),
                    np.uint64(1) << np.uint64(63), np.uint64(0))
    return (mag << np.uint64(63 - kmax)) | sign


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _dense(datas, lcups):
    lc = np.asarray(lcups, np.int64)
    sc = np.array([(d[n - 1] << 4) + (d[n - 2] & 0xF)
                   for d, n in zip(datas, lc)], np.int64)
    st = prep_cleanup_streams(datas, lc, sc)
    return _t(st['mel']), _t(st['vlc']), _t(st['ms'])


@pytest.mark.parametrize('w,h', [(64, 64), (4, 64), (64, 1)],
                         ids=['64x64', '4-wide', '1-tall'])
def test_plain_cleanup_decoder_64_matches_the_scalar_decoder(w, h):
    rng = np.random.RandomState(w * 7 + h)
    mm = [int(k) - 1 for k in rng.randint(31, 61, 4)]
    segs = [jencoder.encode_codeblock(_patterns(rng, w, h, m + 1), m, w, h,
                                      bits=64) for m in mm]
    p = torch.tensor([62 - m for m in mm], dtype=torch.int32)
    dec, err = K.decode_cleanup(*_dense(segs, [len(s) for s in segs]), p, w,
                                h, bits=64)
    assert dec.dtype == torch.int64 and not err.any()
    for i, (m, s) in enumerate(zip(mm, segs)):
        want = jdecoder.decode_codeblock(s, m, 1, len(s), 0, w, h)
        assert want.dtype == np.uint64
        assert np.array_equal(dec[i].numpy().view(np.uint64), want)
    if w == 64 and h == 64:
        # the u_q extension: a non-initial quad row's u_q past 32
        _, u = plain._step1(*_dense(segs, [len(s) for s in segs])[:2], 32,
                            32, wide=True)
        assert bool((u[:, 1:] >= 33).any())


def _caps(w, h, kmax):
    qw, qh = (w + 1) // 2, (h + 1) // 2
    pairs = (qw + 1) // 2
    return (_ebucket(qh * pairs * 18 // 32 + 2),
            _ebucket(qh * pairs * 42 // 32 + 2),
            _ebucket(qw * qh * 4 * (kmax + 1) // 32 + 2))


@pytest.mark.parametrize('w,h,kmax', [(32, 32, 45), (4, 16, 33), (16, 1, 62)],
                         ids=['32x32', '4-wide', '1-tall'])
def test_plain_cleanup_encoder_64_matches_the_scalar_encoder(w, h, kmax):
    rng = np.random.RandomState(w + h + kmax)
    n = 3
    hp, wp = ((h + 1) // 2) * 2, ((w + 3) // 4) * 4
    buf = np.zeros((n, hp, wp), np.uint64)
    for i in range(n):
        buf[i, :h, :w] = _patterns(rng, w, h, kmax)
    caps = _caps(w, h, kmax)
    cat, bits, ovf = E.encode_cleanup(
        torch.from_numpy(buf.view(np.int64)),
        torch.full((n,), 63 - kmax, dtype=torch.int32), w, h, caps,
        torch.full((n,), (h + 1) // 2, dtype=torch.int32))
    assert not ovf.any()
    cat, bits = cat.numpy().view(np.uint32), bits.numpy().astype(np.int64)
    off = np.cumsum([0] + list(caps))
    used, meta, at = [], np.zeros((n, 6), np.int64), 0
    for i in range(n):
        for k in range(3):
            c = (int(bits[i, k]) + 31) // 32
            used.append(cat[i, off[k]:off[k] + c])
            meta[i, 2 * k], meta[i, 2 * k + 1] = at, bits[i, k]
            at += c
    out, lens = native.pack_from_dense(np.concatenate(used), meta,
                                       hp * w * 12 + 256)
    for i in range(n):
        want = jencoder.encode_codeblock(buf[i], kmax - 1, w, h, bits=64)
        assert bytes(out[i, :lens[i]]) == want
        assert native.encode_codeblock(buf[i], kmax - 1, w, h, 64) == want


# ---------------------------------------------------------------------------
# Fixtures: the card's oracles, made here by the JAX package
# ---------------------------------------------------------------------------

def wide_sources():
    """name -> (planes, openjph_tpu.encode keywords) of the committed
    wide streams (``<name>.j2c`` and its decode, ``<name>.npz``)."""
    rng = np.random.RandomState(32)
    return {
        'wide_gray_s32_l2': (
            [rng.randint(-(1 << 31), 1 << 31, (48, 64), dtype=np.int64)],
            dict(bit_depth=32, is_signed=True, reversible=True,
                 num_decomps=2)),
        'wide_rgb_u32_rct_l5': (
            [rng.randint(0, 1 << 32, (32, 48), dtype=np.int64)
             for _ in range(3)],
            dict(bit_depth=32, reversible=True, num_decomps=5)),
        'wide_gray_u29_l5': (
            [rng.randint(0, 1 << 29, (48, 64), dtype=np.int64)],
            dict(bit_depth=29, reversible=True, num_decomps=5)),
    }


# (width, height, passes, stripe-causal) of the committed multi-pass
# 64-bit codeblocks: 4-wide, 1-tall and partial ones among them
MULTIPASS_SHAPES = ((64, 64, 3, False), (32, 32, 2, True), (4, 64, 3, True),
                    (4, 64, 2, False), (64, 4, 3, False), (64, 1, 2, True),
                    (33, 17, 3, True), (7, 5, 2, False), (16, 16, 3, False),
                    (16, 16, 2, True), (13, 7, 3, False), (8, 8, 2, False))


def multipass_codeblocks():
    """The committed multi-pass 64-bit codeblocks: per codeblock its
    cleanup and refinement segments, missing MSBs, passes, stripe-causal
    flag and the JAX package's decode of them.  No encoder makes such
    streams (codec.py:831), so they come from
    coding/encoder.py::encode_codeblock_multipass(bits=64); missing_msbs
    from 30 to 61 (the last decodes one pass)."""
    rng = np.random.RandomState(64)
    out = []
    for i, (w, h, npasses, causal) in enumerate(MULTIPASS_SHAPES):
        kmax = 62 if i == len(MULTIPASS_SHAPES) - 1 \
            else int(rng.randint(32, 62))
        mm = kmax - 2
        buf = _patterns(rng, w, h, kmax, zero=0.5)
        s1, s2 = jencoder.encode_codeblock_multipass(
            buf, mm, w, h, num_passes=npasses, stripe_causal=causal, bits=64)
        dec = jdecoder.decode_codeblock(s1 + s2, mm, npasses, len(s1),
                                        len(s2), w, h, causal)
        out.append(dict(w=w, h=h, mm=mm, npasses=npasses, causal=causal,
                        data=s1 + s2, len1=len(s1), len2=len(s2),
                        samples=dec))
    return out


MULTIPASS_NPZ = 'wide_multipass_codeblocks.npz'
WIDE_P3 = 'wide_gray_u32_p3'


def _smooth(shape, bd, seed):
    """Full-range smooth content plus 12 bits of seeded noise."""
    h, w = shape
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    s = (np.sin(x / 23.0) + np.cos(y / 17.0) + 2.0) / 4.0 \
        * float((1 << bd) - 1 - 4096)
    return s.astype(np.int64) + np.random.RandomState(seed).randint(
        0, 4096, shape)


def _coded(img, **kw):
    """The port's fused encode of ``img`` (held byte-identical to the JAX
    package's) up to its coded blocks: (encoder, tile geometry, plan,
    group batches, coded blocks), for a test to edit before Tier-2."""
    enc = build_encoder(img.shape, 1, functools.partial(
        ep.GpuEncoder, device='cpu'), **kw)
    geom = build_tile(enc.hdr, 0, build_tile_grid(enc.siz)[0])
    plan = enc._build_enc_plan(geom)
    runner = ep._make_enc_runner(plan, 1, 'cpu')
    batches = runner.graph(torch.from_numpy(
        ep._narrow_tile_plane(enc.siz, geom, 0, img)[None]))
    coded = ep._empty_coded(geom, 1)
    enc._consume_outs(plan, *runner.tier1(batches), [coded])
    return enc, geom, plan, batches, coded


def wide_multipass_stream():
    """A 32-bit frame (64x96, 2 levels, 32x32 blocks) whose codeblocks
    carry SigProp and MagRef passes in 64 bits.  No encoder makes one:
    the JAX package never codes a wide band in more than one pass
    (codec.py:831).  So the port's fused encode (held byte-identical to
    the JAX package's) gives the cleanup-only codeblocks, and each
    non-zero one is coded again by coding/encoder.py::
    encode_codeblock_multipass(bits=64, num_passes=3) at kmax - 2
    missing MSBs, kept where its refinement segment is under 2,047
    bytes, the limit the JAX encoder keeps its multi-pass blocks to."""
    enc, geom, plan, batches, coded = _coded(
        _smooth((64, 96), 32, 3), bit_depth=32, reversible=True,
        num_decomps=2, block_size=(32, 32))
    for g, (buf, _) in zip(plan.groups, batches):
        for lane, (bid, bi, h_t) in enumerate(g.lanes):
            c, r, b, kmax = plan.bands[bid][:4]
            cb = coded[c][r][b][bi]
            if not cb.data:
                continue
            block = buf[lane, :h_t, :g.w].numpy().view(np.uint64)
            s1, s2 = jencoder.encode_codeblock_multipass(
                block, kmax - 2, g.w, h_t, num_passes=3, bits=64)
            if 0 < len(s2) < 2047:
                cb.missing_msbs = kmax - 2
                cb.num_passes = 3
                cb.data = s1 + s2
                cb.pass_length[0], cb.pass_length[1] = len(s1), len(s2)
    return enc.assemble([ep._tile_packets(enc, geom, coded)])


def _pack_codeblocks(cbs):
    data = b''.join(c['data'] for c in cbs)
    off = np.cumsum([0] + [len(c['data']) for c in cbs]).astype(np.int64)
    soff = np.cumsum([0] + [c['samples'].size for c in cbs]) \
        .astype(np.int64)
    cols = {k: np.array([int(c[k]) for c in cbs], np.int32)
            for k in ('w', 'h', 'mm', 'npasses', 'causal', 'len1', 'len2')}
    return dict(data=np.frombuffer(data, np.uint8), off=off,
                samples=np.concatenate([c['samples'].ravel()
                                        for c in cbs]),
                soff=soff, **cols)


def load_multipass():
    """The committed multi-pass codeblocks as multipass_codeblocks()
    lists them."""
    z = np.load(os.path.join(TESTDATA, MULTIPASS_NPZ))
    out = []
    for i in range(len(z['w'])):
        w, h = int(z['w'][i]), int(z['h'][i])
        out.append(dict(
            w=w, h=h, mm=int(z['mm'][i]), npasses=int(z['npasses'][i]),
            causal=bool(z['causal'][i]), len1=int(z['len1'][i]),
            len2=int(z['len2'][i]),
            data=z['data'][z['off'][i]:z['off'][i + 1]].tobytes(),
            samples=z['samples'][z['soff'][i]:z['soff'][i + 1]]
            .reshape(h, w)))
    return out


def write_fixtures():
    for name, (planes, kw) in wide_sources().items():
        s = openjph_tpu.encode(planes, **kw)
        with open(os.path.join(TESTDATA, name + '.j2c'), 'wb') as fh:
            fh.write(s)
        ref = openjph_tpu.decode(s)
        np.savez_compressed(os.path.join(TESTDATA, name + '.npz'),
                            kwargs=np.array(json.dumps(kw)),
                            **{f'c{c}': p for c, p in enumerate(ref)})
    np.savez_compressed(os.path.join(TESTDATA, MULTIPASS_NPZ),
                        **_pack_codeblocks(multipass_codeblocks()))
    s = wide_multipass_stream()
    with open(os.path.join(TESTDATA, WIDE_P3 + '.j2c'), 'wb') as fh:
        fh.write(s)
    np.savez_compressed(os.path.join(TESTDATA, WIDE_P3 + '.npz'),
                        c0=openjph_tpu.decode(s)[0])


@pytest.mark.parametrize('name', sorted(wide_sources()))
def test_wide_fixtures_are_what_their_sources_give(name):
    planes, kw = wide_sources()[name]
    with open(os.path.join(TESTDATA, name + '.j2c'), 'rb') as fh:
        s = fh.read()
    assert s == openjph_tpu.encode(planes, **kw)
    z = np.load(os.path.join(TESTDATA, name + '.npz'))
    assert json.loads(str(z['kwargs'])) == kw
    ref = [z[f'c{c}'] for c in range(len(planes))]
    _equal_planes(ref, openjph_tpu.decode(s))
    _equal_planes(ref, [p.astype(r.dtype) for p, r in zip(planes, ref)])
    # the port: decode equal, re-encode byte-identical from the first SOT
    _equal_planes(openjph_tpu_torch.decode(s, device='cpu'), ref)
    assert _from_sot(openjph_tpu_torch.encode(ref, device='cpu', **kw)) \
        == _from_sot(s)


def test_multipass_fixture_is_what_the_jax_coders_give():
    got = load_multipass()
    for g, w in zip(got, multipass_codeblocks()):
        assert {k: v for k, v in g.items() if k != 'samples'} == \
            {k: v for k, v in w.items() if k != 'samples'}
        assert g['samples'].dtype == np.uint64
        assert np.array_equal(g['samples'], w['samples'])


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_wide_multipass_stream_decodes_as_the_host_decoder(raw):
    with open(os.path.join(TESTDATA, WIDE_P3 + '.j2c'), 'rb') as fh:
        s = fh.read()
    ref = np.load(os.path.join(TESTDATA, WIDE_P3 + '.npz'))['c0']
    if raw:
        # the committed stream is still what its source gives, and its
        # committed decode the JAX package's
        assert s == wide_multipass_stream()
        _equal_planes([ref], openjph_tpu.decode(s))
    plan = tp._build_plan(openjph_tpu_torch.GpuDecoder(s, device='cpu'))
    assert plan.has_refine and all(g.bits == 64 for g in plan.groups)
    _equal_planes(openjph_tpu_torch.decode(s, device='cpu', raw=raw), [ref])


def test_plain_refinement_64_matches_the_multipass_fixture():
    """The plain cleanup and refinement decoders (64-bit) on the
    committed codeblocks, one at a time, against their stored samples and
    the port's C++ scalar decoder."""
    cbs = load_multipass()
    for c in cbs:
        n1, n2 = c['len1'], c['len2']
        mel, vlc, ms = _dense([c['data']], [n1])
        p = torch.tensor([62 - c['mm']], dtype=torch.int32)
        dec, err = K.decode_cleanup(mel, vlc, ms, p, c['w'], c['h'], bits=64)
        ref = prep_refine_streams([c['data']], np.array([n1]),
                                  np.array([n2]))
        got = R.refine(dec, _t(ref['spp']), _t(ref['mrp']), p,
                       torch.tensor([c['npasses']], dtype=torch.int32),
                       torch.tensor([c['h']], dtype=torch.int32),
                       torch.tensor([int(c['causal'])], dtype=torch.int32),
                       c['w'], c['h'])
        assert not err.any() and got.dtype == torch.int64
        got = got[0].numpy().view(np.uint64)
        assert np.array_equal(got, c['samples'])
        assert np.array_equal(got, native.decode_codeblock(
            c['data'], c['mm'], c['npasses'], n1, n2, c['w'], c['h'],
            c['causal']))


# ---------------------------------------------------------------------------
# A narrow band's lane of more than 30 bit planes: a corrupt packet header
# ---------------------------------------------------------------------------

def _raised_missing_msbs(seed):
    """A 28-bit frame (5 levels; its bands of kmax 30 hold codeblocks of
    29 missing MSBs) whose packet header says 30 for one codeblock of such
    a band, picked by ``seed``, the rest of the stream as coded: the host
    decoder then decodes that lane in 64 bits, in a band of 32."""
    enc, geom, _, _, coded = _coded(
        _noise(28, (32, 32), 28, False), bit_depth=28, reversible=True,
        num_decomps=5, block_size=(16, 16))
    cands = [cb for r, res in enumerate(geom.comps[0].resolutions)
             for b, sb in enumerate(res.bands)
             if sb is not None and not sb.empty and sb.kmax == 30
             for cb in coded[0][r][b] if cb.data]
    assert all(cb.missing_msbs == 29 for cb in cands)
    cands[np.random.RandomState(seed).randint(len(cands))].missing_msbs = 30
    return enc.assemble([ep._tile_packets(enc, geom, coded)])


@pytest.fixture
def _quiet():
    old, jold = msg._level, jmsg._level
    msg.set_message_level(msg.NO_MSG)
    jmsg.set_message_level(jmsg.NO_MSG)
    yield
    msg._level, jmsg._level = old, jold


# seeds 0 and 3 of a search over the candidate codeblocks: the raised lane
# in a group of 2-wide and of 8-wide blocks
@pytest.mark.parametrize('seed', [0, 3])
def test_a_lane_raised_past_29_missing_msbs_decodes_as_the_host_decoder(
        seed, _quiet):
    s = _raised_missing_msbs(seed)
    plan = tp._build_plan(openjph_tpu_torch.GpuDecoder(s, device='cpu'))
    assert [g.bits for g in plan.groups].count(64) == 1
    for resilient in (True, False):
        try:
            ref = openjph_tpu.decode(s, resilient=resilient)
        except (ValueError, EOFError) as e:
            with pytest.raises(type(e)):
                openjph_tpu_torch.decode(s, device='cpu',
                                         resilient=resilient)
            continue
        for raw in (True, False):
            # a 28-bit frame: the fused path returns int32, unclipped
            _equal_planes(openjph_tpu_torch.decode(
                s, device='cpu', resilient=resilient, raw=raw), ref)


# ---------------------------------------------------------------------------
# Bursts, mosaics, the native oracle
# ---------------------------------------------------------------------------

def test_bursts_of_wide_frames_match_the_jax_package():
    kw = dict(bit_depth=32, reversible=True, num_decomps=2)
    frames = [_noise(90 + i, (32, 32), 32, False) for i in range(2)]
    streams = openjph_tpu_torch.encode_gpu_batch(frames, device='cpu', **kw)
    refs = [openjph_tpu.encode([f], **kw) for f in frames]
    assert [_from_sot(s) for s in streams] == [_from_sot(r) for r in refs]
    got = openjph_tpu_torch.decode_gpu_batch(refs, device='cpu')
    for g, r in zip(got, refs):
        _equal_planes(g, openjph_tpu.decode(r))


def test_mosaic_encoder_codes_wide_tiles_as_the_jax_mosaic_encoder():
    img = _noise(33, (32, 48), 31, False)
    kw = dict(bit_depth=31, reversible=True, num_decomps=1,
              tile_size=(16, 16))
    got = MosaicEncoder(make_mesh(1, device='cpu'), **kw).encode([img])
    want = JaxMosaicEncoder(**kw).encode([img])
    assert _from_sot(got) == _from_sot(want)
    _equal_planes(openjph_tpu_torch.decode(got, device='cpu'),
                  openjph_tpu.decode(want))


@pytest.mark.parametrize('bits', [32, 64])
def test_native_encode_codeblock_matches_the_jax_binding(bits):
    rng = np.random.RandomState(bits)
    kmax = 20 if bits == 32 else 45
    w, h = 16, 12
    if bits == 32:
        mag = rng.randint(0, 1 << kmax, (h, w)).astype(np.uint64)
        buf = (mag << np.uint64(31 - kmax)) | np.where(
            rng.rand(h, w) < 0.5, np.uint64(1 << 31), np.uint64(0))
    else:
        buf = _patterns(rng, w, h, kmax)
    got = native.encode_codeblock(buf, kmax - 1, w, h, bits)
    assert got is not None
    assert got == jnative.encode_codeblock(buf, kmax - 1, w, h, bits)


@pytest.mark.cuda
def test_wide_kernels_match_their_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    s = _stream('32u_l2')
    dec = openjph_tpu_torch.GpuDecoder(s, device=dev)
    _equal_planes(dec.decode(), openjph_tpu.decode(s))
    planes, kw, _ = FRAMES['32u_l2']
    assert _from_sot(openjph_tpu_torch.encode(planes, device=dev, **kw)) \
        == _from_sot(s)


if __name__ == '__main__':
    write_fixtures()
