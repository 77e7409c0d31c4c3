"""The port's image I/O (openjph_tpu_torch.utils.imageio) against the JAX
package's (openjph_tpu.utils.imageio): on the same seeded images the
port's writers write the same bytes, and on the same files its readers
return the same arrays (PNM, PFM, raw, YUV, TIFF, DPX; TIFFs also from an
independent producer, PIL, and DPX files built here)."""
import struct

import numpy as np
import pytest

from openjph_tpu.utils import imageio as jio
from openjph_tpu_torch.utils import imageio as pio


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _round_trip(tmp_path, name, write, read, *args, wkw=None, rkw=()):
    """Write with both packages, hold the bytes equal, read the file with
    both packages, hold the results equal; returns the port's result."""
    paths = {}
    for tag, mod in (('jax', jio), ('port', pio)):
        paths[tag] = str(tmp_path / f'{tag}_{name}')
        getattr(mod, write)(paths[tag], *args, **(wkw or {}))
    with open(paths['jax'], 'rb') as a, open(paths['port'], 'rb') as b:
        assert b.read() == a.read()
    got = getattr(pio, read)(paths['port'], *rkw)
    _same(got, getattr(jio, read)(paths['port'], *rkw))
    return got


@pytest.mark.parametrize('shape,dtype,maxval', [
    ((10, 13), np.uint8, None), ((7, 9, 3), np.uint8, None),
    ((6, 5), np.uint16, None), ((4, 8, 3), np.uint16, None),
    ((5, 6), np.uint16, 1023)])
def test_pnm(tmp_path, rng, shape, dtype, maxval):
    hi = maxval + 1 if maxval else (256 if dtype == np.uint8 else 65536)
    img = rng.randint(0, hi, shape).astype(dtype)
    ext = '.ppm' if len(shape) == 3 else '.pgm'
    got = _round_trip(tmp_path, 'x' + ext, 'write_pnm', 'read_pnm', img,
                      wkw={'maxval': maxval} if maxval else None)
    assert np.array_equal(got, img)


@pytest.mark.parametrize('shape', [(6, 9), (5, 4, 3)])
@pytest.mark.parametrize('little_endian', [True, False])
def test_pfm(tmp_path, rng, shape, little_endian):
    img = rng.standard_normal(shape).astype(np.float32)
    got = _round_trip(tmp_path, 'x.pfm', 'write_pfm', 'read_pfm', img,
                      wkw={'little_endian': little_endian})
    assert np.array_equal(got, img)


@pytest.mark.parametrize('bits,signed', [(8, False), (8, True), (12, True),
                                         (16, False), (20, False),
                                         (24, True), (32, False)])
def test_raw(tmp_path, rng, bits, signed):
    lo, hi = ((-(1 << (bits - 1)), 1 << (bits - 1)) if signed
              else (0, 1 << bits))
    img = rng.randint(lo, hi, (7, 11), dtype=np.int64)
    got = _round_trip(tmp_path, 'x.raw', 'write_raw', 'read_raw', img,
                      bits, signed, rkw=(11, 7, bits, signed))
    assert np.array_equal(got, img)


@pytest.mark.parametrize('bits,ds', [(8, [(1, 1), (2, 2), (2, 2)]),
                                     (10, [(1, 1), (2, 1), (2, 1)])])
def test_yuv(tmp_path, rng, bits, ds):
    w, h = 13, 9
    comps = [rng.randint(0, 1 << bits, ((h + dy - 1) // dy,
                                        (w + dx - 1) // dx))
             .astype(np.int32) for dx, dy in ds]
    got = _round_trip(tmp_path, 'x.yuv', 'write_yuv', 'read_yuv', comps,
                      bits, rkw=(w, h, bits, ds))
    _same(got, comps)


@pytest.mark.parametrize('shape,dtype', [
    ((10, 13), np.uint8), ((7, 9, 3), np.uint8), ((6, 5), np.uint16),
    ((4, 8, 3), np.uint16), ((9, 6, 4), np.uint8), ((5, 7, 4), np.uint16),
    ((8, 3, 2), np.uint16)])
def test_tiff(tmp_path, rng, shape, dtype):
    img = rng.randint(0, 256 if dtype == np.uint8 else 65536,
                      shape).astype(dtype)
    got = _round_trip(tmp_path, 'x.tif', 'write_tiff', 'read_tiff', img)
    assert np.array_equal(got, img)


@pytest.mark.parametrize('comp', ['raw', 'packbits', 'tiff_lzw',
                                  'tiff_deflate'])
def test_tiff_from_pil(tmp_path, rng, comp):
    Image = pytest.importorskip('PIL.Image')
    for mode, shape in (('L', (23, 17)), ('RGB', (19, 31, 3))):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        p = str(tmp_path / f'{mode}_{comp}.tif')
        Image.fromarray(img, mode=mode).save(p, format='TIFF',
                                             compression=comp)
        got = pio.read_tiff(p)
        _same(got, jio.read_tiff(p))
        assert np.array_equal(got, img)


def _dpx(path, img, bits, big_endian):
    """A DPX file of the subset read_dpx takes: RGB (descriptor 50),
    10-bit packed method A, or 8 / 16 bits."""
    e = '>' if big_endian else '<'
    h, w, _ = img.shape
    off = 2048
    hdr = bytearray(off)
    hdr[0:4] = b'SDPX' if big_endian else b'XPDS'
    struct.pack_into(e + 'I', hdr, 4, off)
    struct.pack_into(e + 'I', hdr, 772, w)
    struct.pack_into(e + 'I', hdr, 776, h)
    hdr[800] = 50
    hdr[803] = bits
    struct.pack_into(e + 'H', hdr, 804, 1 if bits == 10 else 0)
    struct.pack_into(e + 'I', hdr, 812, off)
    if bits == 10:
        v = img.astype(np.uint32)
        body = ((v[..., 0] << 22) | (v[..., 1] << 12) | (v[..., 2] << 2)) \
            .astype(e + 'u4').tobytes()
    else:
        body = img.astype(np.uint8 if bits == 8 else e + 'u2').tobytes()
    with open(path, 'wb') as f:
        f.write(bytes(hdr) + body)


@pytest.mark.parametrize('bits', [8, 10, 16])
@pytest.mark.parametrize('big_endian', [True, False])
def test_dpx(tmp_path, rng, bits, big_endian):
    img = rng.randint(0, 1 << bits, (5, 7, 3)).astype(np.int32)
    p = str(tmp_path / 'x.dpx')
    _dpx(p, img, bits, big_endian)
    got = pio.read_dpx(p)
    _same(got[0], jio.read_dpx(p)[0])
    assert got[1] == jio.read_dpx(p)[1] == bits
    assert np.array_equal(got[0], img)


@pytest.mark.parametrize('read', ['read_pnm', 'read_pfm', 'read_tiff',
                                  'read_dpx'])
def test_readers_refuse_garbage(tmp_path, read):
    p = str(tmp_path / 'junk')
    with open(p, 'wb') as f:
        f.write(b'not an image at all' * 4)
    for mod in (pio, jio):
        with pytest.raises(ValueError):
            getattr(mod, read)(p)
