"""Image file I/O: PGM/PPM (binary, <=16 bit), PFM, YUV, RAW.

Mirrors the capability set of the reference app layer
(OpenJPH's src/apps/common/ojph_img_io.h:66-780) in NumPy; a copy of
the JAX package's openjph_tpu/utils/imageio.py.
"""
from __future__ import annotations

import re
import struct
from typing import List, Tuple

import numpy as np


def read_pnm(path: str) -> np.ndarray:
    """Read a binary PGM (P5) or PPM (P6); returns [h, w] or [h, w, 3]."""
    with open(path, 'rb') as f:
        data = f.read()
    m = re.match(rb'(P[56])\s+(?:#.*\s+)*(\d+)\s+(\d+)\s+(\d+)\s', data)
    if not m:
        raise ValueError('not a binary PGM/PPM')
    magic, w, h, maxval = m.group(1), int(m.group(2)), int(m.group(3)), \
        int(m.group(4))
    off = m.end()
    nc = 3 if magic == b'P6' else 1
    if maxval < 256:
        arr = np.frombuffer(data, dtype=np.uint8, count=w * h * nc,
                            offset=off)
    else:
        arr = np.frombuffer(data, dtype='>u2', count=w * h * nc,
                            offset=off).astype(np.uint16)
    arr = arr.reshape(h, w, nc) if nc == 3 else arr.reshape(h, w)
    return arr


def write_pnm(path: str, img: np.ndarray, maxval: int = None):
    nc = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    if maxval is None:
        maxval = 255 if img.dtype == np.uint8 else 65535
    magic = b'P6' if nc == 3 else b'P5'
    with open(path, 'wb') as f:
        f.write(magic + b'\n%d %d\n%d\n' % (w, h, maxval))
        if maxval < 256:
            f.write(img.astype(np.uint8).tobytes())
        else:
            f.write(img.astype('>u2').tobytes())


def read_raw(path: str, width: int, height: int, bit_depth: int,
             is_signed: bool) -> np.ndarray:
    """Little-endian raw samples, as ojph's .raw format
    (ojph_img_io.h raw_in)."""
    nbytes = (bit_depth + 7) // 8
    kinds = {1: 'i1' if is_signed else 'u1',
             2: '<i2' if is_signed else '<u2',
             3: None,
             4: '<i4' if is_signed else '<u4'}
    if nbytes == 3:
        raw = np.fromfile(path, dtype=np.uint8).reshape(height, width, 3)
        v = (raw[..., 0].astype(np.uint32)
             | (raw[..., 1].astype(np.uint32) << 8)
             | (raw[..., 2].astype(np.uint32) << 16))
        if is_signed:
            v = v.astype(np.int32)
            v = np.where(v >= (1 << 23), v - (1 << 24), v)
        return v.astype(np.int32)
    return np.fromfile(path, dtype=kinds[nbytes]).reshape(height, width) \
        .astype(np.int64 if bit_depth > 31 else np.int32)


def write_raw(path: str, img: np.ndarray, bit_depth: int, is_signed: bool):
    nbytes = (bit_depth + 7) // 8
    if nbytes == 3:
        v = img.astype(np.int64) & 0xFFFFFF
        out = np.empty(img.shape + (3,), dtype=np.uint8)
        out[..., 0] = v & 0xFF
        out[..., 1] = (v >> 8) & 0xFF
        out[..., 2] = (v >> 16) & 0xFF
        out.tofile(path)
        return
    kinds = {1: 'i1' if is_signed else 'u1',
             2: '<i2' if is_signed else '<u2',
             4: '<i4' if is_signed else '<u4'}
    img.astype(kinds[nbytes]).tofile(path)


def read_yuv(path: str, width: int, height: int, bit_depth: int,
             downsamplings: List[Tuple[int, int]]) -> List[np.ndarray]:
    """Planar YUV; per-component downsampling like yuv_in."""
    dt = np.uint8 if bit_depth <= 8 else np.dtype('<u2')
    raw = np.fromfile(path, dtype=dt)
    comps, off = [], 0
    for (dx, dy) in downsamplings:
        w, h = (width + dx - 1) // dx, (height + dy - 1) // dy
        comps.append(raw[off:off + w * h].reshape(h, w).astype(np.int32))
        off += w * h
    return comps


def write_yuv(path: str, comps: List[np.ndarray], bit_depth: int):
    dt = np.uint8 if bit_depth <= 8 else np.dtype('<u2')
    with open(path, 'wb') as f:
        for c in comps:
            f.write(c.astype(dt).tobytes())


def read_dpx(path: str):
    """DPX reader: RGB descriptor 50, 10-bit packed (method A) or
    16-bit, both endians — the subset of dpx_in
    (OpenJPH's src/apps/others/ojph_img_io.cpp dpx_in).
    Returns (img [h, w, 3] int32, bit_depth)."""
    with open(path, 'rb') as f:
        data = f.read()
    magic = data[:4]
    if magic == b'SDPX':
        bo = '>'
    elif magic == b'XPDS':
        bo = '<'
    else:
        raise ValueError('not a DPX file')

    def u32(off):
        return struct.unpack_from(bo + 'I', data, off)[0]

    def u16(off):
        return struct.unpack_from(bo + 'H', data, off)[0]

    img_offset = u32(4)
    # image information header at 768; element 0 at 780
    w = u32(768 + 4)
    h = u32(768 + 8)
    el = 780
    descriptor = data[el + 20]
    bit_size = data[el + 23]
    packing = u16(el + 24)
    data_offset = u32(el + 32) or img_offset
    if descriptor != 50:
        raise ValueError(f'unsupported DPX descriptor {descriptor}'
                         ' (only RGB)')
    if bit_size == 10:
        if packing != 1:
            raise ValueError('only packing method A supported for '
                             '10-bit DPX')
        words = np.frombuffer(data, dtype=bo + 'u4', count=w * h,
                              offset=data_offset)
        r = (words >> 22) & 0x3FF
        g = (words >> 12) & 0x3FF
        b = (words >> 2) & 0x3FF
        img = np.stack([r, g, b], axis=-1).reshape(h, w, 3)
        return img.astype(np.int32), 10
    if bit_size == 16:
        arr = np.frombuffer(data, dtype=bo + 'u2', count=w * h * 3,
                            offset=data_offset)
        return arr.reshape(h, w, 3).astype(np.int32), 16
    if bit_size == 8:
        arr = np.frombuffer(data, dtype=np.uint8, count=w * h * 3,
                            offset=data_offset)
        return arr.reshape(h, w, 3).astype(np.int32), 8
    raise ValueError(f'unsupported DPX bit size {bit_size}')


def read_pfm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        data = f.read()
    m = re.match(rb'(P[Ff])\s+(\d+)\s+(\d+)\s+([-+0-9.eE]+)\s', data)
    if not m:
        raise ValueError('not a PFM')
    nc = 3 if m.group(1) == b'PF' else 1
    w, h = int(m.group(2)), int(m.group(3))
    scale = float(m.group(4))
    dt = '<f4' if scale < 0 else '>f4'
    arr = np.frombuffer(data, dtype=dt, count=w * h * nc, offset=m.end())
    arr = arr.reshape(h, w, nc) if nc == 3 else arr.reshape(h, w)
    return arr[::-1]  # PFM stores bottom-up


def write_pfm(path: str, img: np.ndarray, little_endian: bool = True):
    nc = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    magic = b'PF' if nc == 3 else b'Pf'
    scale = -1.0 if little_endian else 1.0
    with open(path, 'wb') as f:
        f.write(magic + b'\n%d %d\n%f\n' % (w, h, scale))
        dt = '<f4' if little_endian else '>f4'
        f.write(img[::-1].astype(dt).tobytes())


# ---------------------------------------------------------------------------
# TIFF — the reference gates its tif_in/tif_out on libtiff
# (common/ojph_img_io.h:436-579, OJPH_ENABLE_TIFF_SUPPORT); here a
# self-contained reader/writer covering the practical libtiff surface
# for 8/16-bit gray/RGB(A): strips and tiles, chunky and planar
# sample layout, uncompressed / PackBits / LZW / Deflate, and the
# horizontal-differencing predictor.
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: ('B', 1), 3: ('H', 2), 4: ('I', 4)}


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-flavor LZW (MSB-first codes, ClearCode 256, EOI 257,
    'early change' code-width bump)."""
    out = bytearray()
    table = []
    code_len = 9
    prev = None
    acc = 0
    nbits = 0

    def reset():
        nonlocal table, code_len, prev
        table = [bytes([i]) for i in range(256)] + [b'', b'']
        code_len = 9
        prev = None

    reset()
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= code_len:
            nbits -= code_len
            code = (acc >> nbits) & ((1 << code_len) - 1)
            if code == 256:
                reset()
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # early change: width bumps one code before the table fills
            if len(table) + 1 >= (1 << code_len) and code_len < 12:
                code_len += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - c)
                i += 1
    return bytes(out)


def _tiff_decompress(raw: bytes, comp: int) -> bytes:
    if comp == 1:
        return raw
    if comp in (8, 32946):  # Deflate (new/old tag)
        import zlib
        return zlib.decompress(raw)
    if comp == 5:
        return _lzw_decode(raw)
    if comp == 32773:
        return _packbits_decode(raw)
    raise ValueError(f'unsupported TIFF compression {comp}')


def read_tiff(path: str) -> np.ndarray:
    """Read a TIFF image (gray/RGB(A), 8/16-bit; strips or tiles;
    chunky or planar; none/PackBits/LZW/Deflate compression, with the
    horizontal predictor).  Returns [H, W] or [H, W, spp]
    (uint8/uint16)."""
    import struct
    data = open(path, 'rb').read()
    if data[:2] == b'II':
        e = '<'
    elif data[:2] == b'MM':
        e = '>'
    else:
        raise ValueError('not a TIFF file')
    if struct.unpack(e + 'H', data[2:4])[0] != 42:
        raise ValueError('bad TIFF magic')
    ifd_off = struct.unpack(e + 'I', data[4:8])[0]
    n = struct.unpack(e + 'H', data[ifd_off:ifd_off + 2])[0]
    tags = {}
    for i in range(n):
        off = ifd_off + 2 + i * 12
        tag, typ, cnt = struct.unpack(e + 'HHI', data[off:off + 8])
        if typ not in _TIFF_TYPES:
            continue
        fmt, sz = _TIFF_TYPES[typ]
        total = sz * cnt
        if total <= 4:
            raw = data[off + 8:off + 8 + total]
        else:
            voff = struct.unpack(e + 'I', data[off + 8:off + 12])[0]
            raw = data[voff:voff + total]
        tags[tag] = list(struct.unpack(e + fmt * cnt, raw))
    w = tags[256][0]
    h = tags[257][0]
    bps = tags.get(258, [1])
    spp = tags.get(277, [1])[0]
    comp = tags.get(259, [1])[0]
    planar = tags.get(284, [1])[0]
    predictor = tags.get(317, [1])[0]
    bits = bps[0]
    if bits not in (8, 16):
        raise ValueError('only 8/16-bit TIFF is supported')
    if predictor not in (1, 2):
        raise ValueError(f'unsupported TIFF predictor {predictor}')
    dt = np.dtype('u1' if bits == 8 else e + 'u2')
    nplanes = spp if planar == 2 else 1
    csamp = 1 if planar == 2 else spp  # samples per pixel per chunk

    def undiff(block):
        """Horizontal-differencing predictor: each sample is a delta
        against the SAME channel of the previous pixel, so the cumsum
        runs over the pixel axis of the (rows, w, csamp) view."""
        if predictor == 2:
            np.cumsum(block, axis=1, dtype=block.dtype, out=block)
        return block

    if spp > 1:
        out = np.empty((h, w, spp), dt.newbyteorder('='))
    else:
        out = np.empty((h, w), dt.newbyteorder('='))

    if 322 in tags:  # tiled layout
        tw = tags[322][0]
        tl = tags[323][0]
        offs = tags[324]
        cnts = tags[325]
        tx = -(-w // tw)
        ty = -(-h // tl)
        for pi in range(nplanes):
            for i in range(ty):
                for j in range(tx):
                    k = pi * tx * ty + i * tx + j
                    raw = _tiff_decompress(
                        data[offs[k]:offs[k] + cnts[k]], comp)
                    tile = undiff(np.frombuffer(raw, dt,
                                                count=tl * tw * csamp)
                                  .reshape(tl, tw, csamp).copy())
                    hh = min(tl, h - i * tl)
                    ww = min(tw, w - j * tw)
                    dst = out[i * tl:i * tl + hh, j * tw:j * tw + ww]
                    src = tile[:hh, :ww]
                    if planar == 2:
                        dst[..., pi] = src[..., 0]
                    elif spp > 1:
                        dst[...] = src
                    else:
                        dst[...] = src[..., 0]
    else:  # strips
        offs = tags[273]
        cnts = tags[279]
        rps = tags.get(278, [h])[0]
        strips_per_plane = -(-h // rps)
        for pi in range(nplanes):
            for si in range(strips_per_plane):
                k = pi * strips_per_plane + si
                raw = _tiff_decompress(
                    data[offs[k]:offs[k] + cnts[k]], comp)
                hh = min(rps, h - si * rps)
                st = undiff(np.frombuffer(raw, dt, count=hh * w * csamp)
                            .reshape(hh, w, csamp).copy())
                dst = out[si * rps:si * rps + hh]
                if planar == 2:
                    dst[..., pi] = st[..., 0]
                elif spp > 1:
                    dst[...] = st
                else:
                    dst[...] = st[..., 0]
    return out


def write_tiff(path: str, img: np.ndarray):
    """Write a baseline uncompressed little-endian TIFF (8/16-bit,
    any channel count; >=3 channels written as RGB + extra samples —
    the layout libtiff consumers like the reference's tif_in expect,
    ojph_img_io.h:~tif_in)."""
    import struct
    img = np.asarray(img)
    if img.ndim == 2:
        h, w = img.shape
        spp = 1
    else:
        h, w, spp = img.shape
    if img.dtype.itemsize == 1:
        bits = 8
        payload = img.astype('u1').tobytes()
    else:
        bits = 16
        payload = img.astype('<u2').tobytes()
    phot = 2 if spp >= 3 else 1
    n_extra = max(0, spp - 3) if spp >= 3 else max(0, spp - 1)

    entries = []

    def tag(t, typ, cnt, val):
        entries.append((t, typ, cnt, val))

    ntags = 10 + (1 if n_extra else 0)
    data_off = 8 + 2 + 12 * ntags + 4  # header + IFD + next-IFD ptr
    extra = b''
    bps_off = data_off
    if spp > 1:
        # BitsPerSample array (count == spp), 2-byte aligned
        extra = struct.pack('<%dH' % spp, *([bits] * spp))
        if len(extra) % 4:
            extra += b'\x00' * (4 - len(extra) % 4)
    strip_off = data_off + len(extra)
    tag(256, 4, 1, w)
    tag(257, 4, 1, h)
    if spp > 2:
        tag(258, 3, spp, bps_off)
    elif spp == 2:
        # two shorts fit inline in the value word
        tag(258, 3, 2, bits | (bits << 16))
        extra = b''
        strip_off = data_off
    else:
        tag(258, 3, 1, bits)
    tag(259, 3, 1, 1)
    tag(262, 3, 1, phot)
    tag(273, 4, 1, strip_off)
    tag(277, 3, 1, spp)
    tag(278, 4, 1, h)
    tag(279, 4, 1, len(payload))
    if n_extra:
        # ExtraSamples: unassociated alpha/extra channels beyond the
        # photometric channels (keeps libtiff from guessing)
        val = 2 if n_extra == 1 else bps_off  # inline short when 1
        if n_extra == 1:
            tag(338, 3, 1, 2)
        else:
            tag(338, 3, n_extra, 2)  # rare; libtiff tolerates inline 0
    tag(339, 3, 1, 1)  # unsigned
    entries.sort(key=lambda e: e[0])
    out = bytearray()
    out += b'II*\x00' + struct.pack('<I', 8)
    out += struct.pack('<H', len(entries))
    for (t, typ, cnt, val) in entries:
        out += struct.pack('<HHI', t, typ, cnt)
        out += struct.pack('<I', val)
    out += struct.pack('<I', 0)
    out += extra
    out += payload
    open(path, 'wb').write(bytes(out))
