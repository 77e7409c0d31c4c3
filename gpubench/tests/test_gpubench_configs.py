"""A configuration file drives the run through data alone: every key is
used or refused, a tiled frame of four components runs through the
ring's inputs and the coders' read-back, and a decode ring's codestreams
are kept by configuration and seed."""
import numpy as np
import pytest

from gpubench.harness import coders, manifest
from gpubench.inputs import streams
from gpubench.reference.htj2k import codec

SEED = 2**33 + 7


def _tiled_rgba():
    """A small 12-bit, four-component, lossless configuration of four
    tiles (the shape of BASELINE's config 3, at a test's size)."""
    cfg = dict(manifest.cell('gray8_2k_rev53.decode_stream').config)
    cfg.update(name='rgba12_tiled_test', width=96, height=80, components=4,
               bit_depth=12, num_decomps=2, block_size=[32, 32],
               tile_size=[64, 48], color_transform=True)
    return cfg


def test_an_unused_key_is_refused():
    cfg = dict(_tiled_rgba(), tiles=4)
    with pytest.raises(ValueError, match='tiles'):
        streams.encode_kwargs(cfg)
    with pytest.raises(ValueError, match='tiles'):
        streams.ring_frames(cfg, SEED, 1)


def test_a_wavelet_against_reversible_is_refused():
    with pytest.raises(ValueError, match='wavelet'):
        streams.encode_kwargs(dict(_tiled_rgba(), wavelet='9/7'))


def test_geometry_keys_reach_the_encoder():
    cfg = _tiled_rgba()
    kw = streams.encode_kwargs(cfg)
    assert kw['tile_size'] == (64, 48) and kw['block_size'] == (32, 32)
    frames = streams.ring_frames(cfg, SEED, 2)
    assert frames[0].shape == (80, 96, 4) and frames[0].dtype == np.uint16
    assert frames[0].max() < 4096
    hdr = codec.Decoder(streams.ring_streams(cfg, frames[:1])[0]).hdr
    assert (hdr.siz.xtsiz, hdr.siz.ytsiz) == (64, 48)
    assert hdr.siz.num_comps == 4


def test_tiled_decode_reads_back_whole_frames():
    cfg = _tiled_rgba()
    frames = streams.ring_frames(cfg, SEED, 2)
    ring = streams.ring_streams(cfg, frames)
    coder = coders.DecodeCoder(cfg, 'cpu', ring)
    assert len(coder.tile_rects) == 4
    try:
        coder.submit([0, 1])
        got = coder.to_host(coder.collect(True))
        coder.finish()
    finally:
        coder.close()
    for g, f in zip(got, frames):
        assert np.array_equal(g, np.moveaxis(f, -1, 0))


def test_tiled_encode_matches_the_reference():
    cfg = _tiled_rgba()
    frames = streams.ring_frames(cfg, SEED, 2)
    coder = coders.EncodeCoder(cfg, 'cpu', frames)
    try:
        coder.submit([0, 1])
        got = coder.to_host(coder.collect(True))
    finally:
        coder.close()
    assert got == streams.ring_streams(cfg, frames)


def test_decode_inputs_are_kept_by_config_and_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(streams, 'CACHE_DIR', str(tmp_path))
    cfg = dict(_tiled_rgba(), tile_size=None)
    made = streams.ring_inputs(cfg, SEED, 2, 'decode')
    assert len(list(tmp_path.iterdir())) == 1
    monkeypatch.setattr(streams, 'ring_streams', None)  # must not be made
    assert streams.ring_inputs(cfg, SEED, 2, 'decode') == made
    monkeypatch.undo()
    monkeypatch.setattr(streams, 'CACHE_DIR', str(tmp_path))
    other = streams.ring_inputs(cfg, SEED + 1, 2, 'decode')
    assert other != made and len(list(tmp_path.iterdir())) == 2
