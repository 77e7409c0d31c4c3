"""Tile mosaics through the port's MosaicDecoder / MosaicEncoder
(openjph_tpu_torch.parallel.tiles) on CPU meshes, held against the JAX
package on the same seeded images: the cases of tests/test_mosaic.py at
its sizes (decode bit-exact with openjph_tpu.codec.Decoder for 5/3, 9/7
within +-1 of it and of the JAX MosaicDecoder's fused output; encode
byte-identical to openjph_tpu.encode; the class count and the
per-device layout on a 2-entry mesh; a 3-pass mosaic with a flat tile),
the streamed encode and the decode of an mmap, the refusals, and the
committed card fixtures (openjph_tpu_torch/testdata/mosaic_*) against
the calls that made them.

The JAX references are its host paths, shared across cases; the JAX
MosaicDecoder runs once (the 9/7 case).  Run as a script, this file
writes the card fixtures.
"""
import functools
import io
import mmap
import os

import numpy as np
import pytest
import torch

from openjph_tpu import encode
from openjph_tpu.codec import Decoder, Encoder as JEncoder
from openjph_tpu.parallel.tiles import MosaicDecoder as JaxMosaicDecoder
from openjph_tpu.parallel.tiles import MosaicEncoder as JaxMosaicEncoder

from openjph_tpu_torch import codec as tcodec
from openjph_tpu_torch.core.message import OjphError
from openjph_tpu_torch.gpu.encode_pipeline import GpuEncoder
from openjph_tpu_torch.parallel._testing import (flat_tile_3pass,
                                                 mosaic_fixture_sources)
from openjph_tpu_torch.gpu.pipeline import _burst_runner, _pack, upload
from openjph_tpu_torch.parallel import (MosaicDecoder, MosaicEncoder,
                                        decode_mosaic, encode_mosaic,
                                        make_mesh)
from openjph_tpu_torch.parallel.tiles import _frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')


def _mesh(n=1):
    return make_mesh(n, device='cpu')


def _noise(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.int32)


FUSED_97 = 'mosaic_gray_128x128_97_t64_fused.npz'


def _jax_fused(stream):
    """The JAX package's MosaicDecoder (its fused path) on one device."""
    from openjph_tpu.parallel.mesh import make_mesh as jmesh
    from openjph_tpu.parallel.tiles import MosaicDecoder as JMosaic
    return JMosaic(stream, jmesh(1)).decode()


def write_fixtures():
    for name, (planes, kw) in mosaic_fixture_sources().items():
        s = encode(planes, **kw)
        with open(os.path.join(TESTDATA, name + '.j2c'), 'wb') as fh:
            fh.write(s)
        if name == 'mosaic_gray_128x128_97_t64':
            np.savez_compressed(os.path.join(TESTDATA, FUSED_97),
                                plane=_jax_fused(s)[0])


def _fixture(name) -> bytes:
    with open(os.path.join(TESTDATA, name + '.j2c'), 'rb') as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# shared JAX references
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def gray():
    img = _noise(21, (256, 256))
    kw = dict(reversible=True, num_decomps=2, tile_size=(64, 64))
    s = encode([img], **kw)
    return img, s, Decoder(s).decode()[0], kw


@pytest.fixture(scope='module')
def rgb():
    img = _noise(22, (256, 320, 3))
    kw = dict(reversible=True, num_decomps=2, tile_size=(128, 128),
              color_transform=True)
    s = encode(img, **kw)
    return img, s, Decoder(s).decode(), kw


@pytest.fixture(scope='module')
def irv97():
    planes, kw = mosaic_fixture_sources()['mosaic_gray_128x128_97_t64']
    s = encode(planes, **kw)
    return s, _jax_fused(s)[0], Decoder(s).decode()[0]


@pytest.mark.parametrize('raw', [True, False])
def test_uniform_grid_gray(gray, raw):
    # 16 identical 64x64 tiles: one geometry class, one runner call
    img, s, ref, _ = gray
    md = MosaicDecoder(s, _mesh(), raw=raw)
    assert len(md.classes) == 1
    assert md.classes[0]['tiles'] == list(range(16))
    got = md.decode()
    assert np.array_equal(got[0], ref)
    assert np.array_equal(got[0], img)


def test_sharded_layout(gray):
    _, s, ref, _ = gray
    md = MosaicDecoder(s, _mesh(2), batch_tiles=64)
    (tiles, comps, errs), = md.decode_on_device()
    # two devices: per component a tuple of two slices, the tile frames
    # (16, padded to 16) split evenly in mesh order
    assert tiles == list(range(16))
    assert isinstance(comps[0], tuple) and len(comps[0]) == 2
    assert [tuple(c.shape) for c in comps[0]] == [(8, 64, 64)] * 2
    assert isinstance(errs, tuple) and not any(bool(e.any()) for e in errs)
    frames = torch.cat(comps[0]).numpy()
    for i, ti in enumerate(tiles):
        y, x = divmod(ti, 4)
        assert np.array_equal(frames[i], ref[y * 64:(y + 1) * 64,
                                             x * 64:(x + 1) * 64])
    # one device: the tensor itself
    (_, comps1, errs1), = MosaicDecoder(s, _mesh()).decode_on_device()
    assert isinstance(comps1[0], torch.Tensor)
    assert torch.equal(comps1[0], torch.cat(comps[0]))


def test_sub_batches_and_padding(gray):
    # 16 tiles in sub-batches of 12 on a 2-entry mesh: 12 tiles padded to
    # 16 frames (tile replicas) split 8 + 8, then 4 padded to 8, 4 + 4
    _, s, ref, _ = gray
    md = MosaicDecoder(s, _mesh(2), batch_tiles=12)
    out = md.decode_on_device()
    assert [t for t, _, _ in out] == [list(range(12)), [12, 13, 14, 15]]
    assert [tuple(c[0][0].shape) for _, c, _ in out] == [(8, 64, 64),
                                                          (4, 64, 64)]
    for tiles, comps, _ in out:
        frames = torch.cat(comps[0]).numpy()
        for i, ti in enumerate(tiles):
            y, x = divmod(ti, 4)
            assert np.array_equal(frames[i], ref[y * 64:(y + 1) * 64,
                                                 x * 64:(x + 1) * 64])
        # padding frames replicate the sub-batch's first tile
        assert all(np.array_equal(f, frames[0]) for f in frames[len(tiles):])


def test_rim_classes_rgb_mct(rgb):
    # 320x256 in 128x128 tiles: interior and right-rim classes
    img, s, ref, _ = rgb
    md = MosaicDecoder(s, _mesh())
    assert len(md.classes) == 2
    assert [len(c['tiles']) for c in md.classes] == [4, 2]
    got = md.decode()
    for c in range(3):
        assert np.array_equal(got[c], ref[c])
        assert np.array_equal(got[c], img[..., c])


def test_irreversible_mosaic(irv97):
    s, fused, ref = irv97
    got = decode_mosaic(s, _mesh(2))[0]
    # the JAX fused path and its host decoder differ by +-1 (float op
    # order); the port is held to both at that tolerance
    assert np.abs(got.astype(np.int64) - fused).max() <= 1
    assert np.abs(got.astype(np.int64) - ref).max() <= 1
    # the committed card oracle is the JAX fused output
    with np.load(os.path.join(TESTDATA, FUSED_97)) as z:
        assert np.array_equal(z['plane'], fused)


def test_mosaic_encode_uniform(gray):
    img, s, _, kw = gray
    assert encode_mosaic([img], _mesh(2), **kw) == s


def test_mosaic_encode_rim_rgb(rgb):
    img, s, _, kw = rgb
    assert encode_mosaic(img, _mesh(), **kw) == s


def test_mosaic_multipass_mixed_flat_tile():
    """A 3-pass mosaic whose first tile is flat (all-zero blocks, no
    refinement segments): its class still runs in refine mode."""
    img = flat_tile_3pass(7)
    s = encode(img, reversible=True, num_decomps=2, tile_size=(64, 64),
               ht_passes=3)
    md = MosaicDecoder(s, _mesh(2))
    assert len(md.classes) == 1
    assert md.classes[0]['top'].has_refine
    out = md.decode()
    assert np.array_equal(np.clip(out[0], 0, 255), np.clip(img, 0, 255))
    ref = np.clip(Decoder(s).decode()[0], 0, 255)
    assert np.array_equal(out[0], ref)
    # a sub-batch of the flat tile alone is still packed in refine mode
    md1 = MosaicDecoder(s, _mesh(), batch_tiles=1)
    tiles, comps, errs, _ = next(md1._run_classes())
    assert tiles == [0] and not bool(errs.any())
    assert np.array_equal(comps[0][0].numpy(), ref[:64, :64])


def test_stages_carry_the_jax_names(gray, monkeypatch):
    import re
    from openjph_tpu_torch import trace
    from openjph_tpu_torch.gpu import encode_pipeline, pipeline
    from openjph_tpu_torch.utils.cache import Cache
    # cold runner caches, so that the compile stages run
    monkeypatch.setattr(pipeline, '_RUNNERS', Cache(32))
    monkeypatch.setattr(encode_pipeline, '_ENC_RUNNERS', Cache(32))
    img, s, ref, kw = gray
    trace.reset()
    trace.enable()
    try:
        assert encode_mosaic([img], _mesh(), **kw) == s
        assert np.array_equal(decode_mosaic(s, _mesh())[0], ref)
    finally:
        trace.disable()
    timed = {k for k in trace.get_stats() if k.startswith('mosaic.')}
    trace.reset()
    with open(os.path.join(REPO, 'openjph_tpu', 'parallel',
                           'tiles.py')) as fh:
        jax_names = set(re.findall(r"trace\.stage\('(mosaic\.[a-z_0-9]+)'",
                                   fh.read()))
    assert len(jax_names) == 8 and timed == jax_names


def _tile_reader(img):
    def read(ti, geom):
        r = geom.comps[0].rect
        return [img[r.y0:r.y0 + r.h, r.x0:r.x0 + r.w]]
    return read


def test_encode_chunked_streams_the_same_bytes(gray, tmp_path):
    # one-class grid: 16 tiles streamed in sub-batches of 4 to a file,
    # then decoded from an mmap of it, tile by tile
    img, s, _, kw = gray
    buf = io.BytesIO()
    me = MosaicEncoder(_mesh(), batch_tiles=8, **kw)
    assert me.encode_chunked(_tile_reader(img), img.shape, 1, out=buf) \
        is None
    assert buf.getvalue() == s
    path = tmp_path / 'm.j2c'
    path.write_bytes(buf.getvalue())
    seen = {}
    with open(path, 'rb') as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            md = MosaicDecoder(mm, _mesh(2), batch_tiles=8)

            def sink(ti, planes):
                r = md.dec.tiles[ti].geom.comps[0].rect
                assert np.array_equal(planes[0],
                                      img[r.y0:r.y0 + r.h, r.x0:r.x0 + r.w])
                seen[ti] = True

            md.decode_to(sink)
            del md
        finally:
            mm.close()
    assert sorted(seen) == list(range(16))


def test_host_memory_does_not_grow_with_the_tile_count(tmp_path):
    """Nothing of a tile outlives its sub-batch: neither the encoder nor
    the decoder keeps a tile's geometry, Tier-2 records or plan.  Traced
    Python and numpy memory of a 144-tile mosaic against a 36-tile one,
    per added tile: the encode's peak, what the decoder holds once built,
    and the decode's peak (keeping each tile's geometry and records
    costs 3-7 KB a tile of 16x16)."""
    import tracemalloc

    def run(n):
        img = _noise(21, (n, n))
        path = tmp_path / f'm{n}.j2c'
        me = MosaicEncoder(_mesh(), batch_tiles=16, reversible=True,
                           num_decomps=1, tile_size=(16, 16))
        tracemalloc.start()
        try:
            with open(path, 'wb') as fh:
                me.encode_chunked(_tile_reader(img), img.shape, 1, out=fh)
            enc_peak = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()
            data = path.read_bytes()
            tracemalloc.start()
            md = MosaicDecoder(data, _mesh(), batch_tiles=16)
            held = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            seen = []

            def sink(ti, planes):
                r = md.dec.tile_rects[ti]
                assert np.array_equal(planes[0],
                                      img[r.y0:r.y1, r.x0:r.x1])
                seen.append(ti)

            md.decode_to(sink)
            dec_peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert sorted(seen) == list(range((n // 16) ** 2))
        return enc_peak, held, dec_peak

    run(32)  # tables and runners
    small, big = run(96), run(192)
    per_tile = [(b - a) / (144 - 36) for a, b in zip(small, big)]
    assert max(per_tile) < 1536, per_tile


def test_stream_begin_refuses_tlm():
    kw = dict(reversible=True, num_decomps=1, tile_size=(16, 16),
              tlm_marker=True)
    enc = tcodec.build_encoder((32, 32), 1,
                               functools.partial(GpuEncoder, device='cpu'),
                               **kw)
    with pytest.raises(OjphError, match='TLM'):
        enc.stream_begin(io.BytesIO())
    # as the JAX package's
    from openjph_tpu.codec import build_encoder as jbuild
    from openjph_tpu.core.message import OjphError as JError
    with pytest.raises(JError, match='TLM'):
        jbuild((32, 32), 1, encoder_cls=JEncoder, **kw).stream_begin(
            io.BytesIO())
    me = MosaicEncoder(_mesh(), **kw)
    with pytest.raises(OjphError, match='TLM'):
        me.encode_chunked(_tile_reader(np.zeros((32, 32), np.int32)),
                          (32, 32), 1, out=io.BytesIO())


def test_mosaic_encoder_raises_instead_of_falling_back():
    """Multi-pass tiles (ROADMAP 12) encode through K3 and K5 to what the
    JAX package's MosaicEncoder gives (its scalar fallback,
    parallel/tiles.py:333-339); the chunked ingest refuses them with its
    ValueError (:335-338) instead of falling back."""
    img = _noise(3, (64, 64))
    kw = dict(reversible=True, num_decomps=1, tile_size=(32, 32),
              ht_passes=3)
    me = MosaicEncoder(_mesh(), **kw)
    want = JaxMosaicEncoder(**kw).encode([img])
    assert want == encode(img, **kw)
    assert me.encode([img]) == want
    msg = 'stream not eligible for the fused encode path; chunked ingest'
    with pytest.raises(ValueError, match=msg):
        JaxMosaicEncoder(**kw).encode_chunked(_tile_reader(img), (64, 64))
    with pytest.raises(ValueError, match=msg):
        me.encode_chunked(_tile_reader(img), (64, 64), out=io.BytesIO())


def test_mosaic_decoder_refuses_wide_bands():
    # 32-bit samples: bands of more than 30 bit planes, which the JAX
    # MosaicDecoder refuses with this ValueError (parallel/tiles.py:89-91)
    img = np.random.RandomState(4).randint(0, 1 << 31, (32, 32),
                                           dtype=np.int64)
    s = encode([img], reversible=True, num_decomps=1, bit_depth=32,
               tile_size=(16, 16))
    with pytest.raises(ValueError, match='>30 bit-plane streams take the '
                       'host path; mosaic sharding unsupported'):
        JaxMosaicDecoder(s)
    with pytest.raises(ValueError, match='>30 bit-plane streams take the '
                       'host path; mosaic sharding unsupported'):
        MosaicDecoder(s, _mesh())


def test_mosaic_chunked_encoder_refuses_wide_bands():
    # the JAX encode_chunked has no whole image to code such a tile from
    # on its host (parallel/tiles.py:335-338); MosaicEncoder.encode codes
    # it (tests/test_torch_wide.py)
    img = np.random.RandomState(5).randint(0, 1 << 31, (32, 32),
                                           dtype=np.int64)
    kw = dict(reversible=True, num_decomps=1, bit_depth=32,
              tile_size=(16, 16))
    msg = 'stream not eligible for the fused encode path; chunked ingest'
    with pytest.raises(ValueError, match=msg):
        JaxMosaicEncoder(**kw).encode_chunked(_tile_reader(img), (32, 32))
    with pytest.raises(ValueError, match=msg):
        MosaicEncoder(_mesh(), **kw).encode_chunked(_tile_reader(img),
                                                    (32, 32))


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        MosaicEncoder()
    with pytest.raises(RuntimeError, match='CUDA'):
        MosaicDecoder(b'')


TILE_PLAN_STREAMS = ['mosaic_gray_128x128_rev_t64',
                     'mosaic_gray_128x128_rev_p3_t64']


@pytest.mark.parametrize('name', TILE_PLAN_STREAMS)
def test_tile_plans_memoise_and_decode_as_decode(name):
    """tile_plans: filled by no decode path, built at first access and
    kept, every tile's by values(), each under its class's key (``plan``
    names the class's ``top``); the tiles packed from them and run on the
    class's runner equal decode()."""
    md = MosaicDecoder(_fixture(name), _mesh())
    want = md.decode()
    assert len(md.tile_plans) == 0
    p0 = md.tile_plans[0]
    assert md.tile_plans[0] is p0 and len(md.tile_plans) == 1
    assert len(md.tile_plans.values()) == len(md.dec.tile_rects) == 4
    assert md.tile_plans[0] is p0
    tile_planes = {}
    for cls in md.classes:
        assert cls['plan'] is cls['top']
        tiles = cls['tiles']
        plans = [md.tile_plans[ti] for ti in tiles]
        assert all(p.key == cls['top'].key for p in plans)
        F = _frames(len(tiles), 1)
        args = _pack([(md.dec, p) for p in plans]
                     + [(md.dec, plans[0])] * (F - len(tiles)), md.raw)
        errs, outs = _burst_runner(cls['top'], F, 'cpu', md.raw)(
            *upload(args, 'cpu'))
        assert not errs.any()
        for i, ti in enumerate(tiles):
            tile_planes[ti] = [c[i].numpy() for c in outs[0]]
    got = md.dec._assemble(tile_planes)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', TILE_PLAN_STREAMS)
def test_tile_plans_hold_the_jax_plans(name):
    """Against the JAX MosaicDecoder's tile_plans on the same stream: the
    same classes and tile order, and per tile the same groups (id, width,
    height, codeblocks), placements, bands and per-lane arrays (byte
    offset, lcup, scup, p, quad-row limit, passes, refinement length,
    true height, causal flag).  Not compared, as the port's planner
    differs there by design: the groups' lane padding (the port pads to 8
    lanes) and word buckets (the port's have no stuffing ceiling), and
    the tile tuples, where the port records more."""
    from openjph_tpu.parallel.mesh import make_mesh as jmesh
    s = _fixture(name)
    jmd = JaxMosaicDecoder(s, jmesh(1))
    md = MosaicDecoder(s, _mesh())
    assert [c['tiles'] for c in md.classes] == \
        [c['tiles'] for c in jmd.classes]
    for ti in range(len(md.dec.tile_rects)):
        a, b = jmd.tile_plans[ti], md.tile_plans[ti]
        assert [(g.gid, g.w, g.h, len(g.members)) for g in a.groups] == \
            [(g.gid, g.w, g.h, len(g.members)) for g in b.groups]
        assert a.placements == b.placements and a.bands == b.bands
        assert a.has_refine == b.has_refine == ('_p3_' in name)
        assert len(a.lanes) == len(b.lanes) == 9
        for x, y in zip(a.lanes, b.lanes):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('name', sorted(mosaic_fixture_sources()))
def test_card_fixtures_match_their_encoder(name):
    planes, kw = mosaic_fixture_sources()[name]
    # the card's oracles for MosaicEncoder (single-pass) and for
    # MosaicDecoder; the port's encode is held to openjph_tpu.encode above
    assert _fixture(name) == encode(planes, **kw)


if __name__ == '__main__':
    write_fixtures()
