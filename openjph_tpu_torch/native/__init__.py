"""Native (C++) host kernels, built at first use with g++ and bound via
ctypes: the byte-level serial work around the device batches
(packet-header parsing and emission, segment blob layout, host
unstuffing of the cleanup and refinement segments, and the encoder's
byte stuffing of device-packed words), plus the scalar codeblock
decoder and encoder that the kernels are held against.

The source is a copy of the JAX package's ``ojtpu_native.cpp``.  The
library is required: Tier-2, the planner, the unstuffers and the packers
have no numpy twin in this package (the tests hold them against the JAX
package's), so a failed build raises instead of degrading.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..gpu._build import load_library

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'ojtpu_native.cpp')
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_library(
            'ojtpu_native', [_SRC],
            lambda out: ['g++', '-O3', '-march=native', '-shared',
                         '-fPIC', '-o', out, _SRC, '-lpthread'])
        lib.prep_cleanup_streams.restype = None
        lib.prep_cleanup_streams.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        lib.prep_cleanup_dense.restype = None
        lib.prep_cleanup_dense.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.t2_walk_tile_part.restype = ctypes.c_int64
        lib.t2_walk_tile_part.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.plan_lanes.restype = ctypes.c_int64
        lib.plan_lanes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 16
        lib.t2_emit_packet.restype = ctypes.c_int64
        lib.t2_emit_packet.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.pack_from_dense.restype = None
        lib.pack_from_dense.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.pack_raw_burst.restype = None
        lib.pack_raw_burst.argtypes = [ctypes.c_int64] + \
            [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + \
            [ctypes.c_void_p]
        lib.prep_refine_streams.restype = None
        lib.prep_refine_streams.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.decode_codeblock.restype = ctypes.c_int
        lib.decode_codeblock.argtypes = [
            ctypes.c_void_p] + [ctypes.c_int64] * 7 + \
            [ctypes.c_void_p] * 6
        lib.encode_codeblock.restype = ctypes.c_int64
        lib.encode_codeblock.argtypes = [
            ctypes.c_void_p] + [ctypes.c_int64] * 5 + \
            [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def have_native() -> bool:
    """True once the library is built and loaded; raises RuntimeError
    when it cannot be built."""
    return _load() is not None


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else min(8, os.cpu_count() or 1)


def prep_cleanup_streams(datas, lcups, scups, min_words=None):
    """Batch unstuffer of HT cleanup segments: each segment's MEL, VLC
    (backward) and MagSgn streams become dense bit sequences in
    consumption order, packed LSB-first into uint32 words (bit t of word
    j = bit 32j+t), past the end filled as its reader fills them (the
    rules that gpu/unstuff.py states and applies to the raw bytes; the
    JAX package's tpu/bitprep.py is the tests' reference).  Returns
    {'mel', 'vlc', 'ms'}: uint32 [N, W] each.  min_words: optional
    (mel_w, vlc_w, ms_w) lower bounds so callers can bucket widths."""
    lib = _load()
    n = len(datas)
    lcups = np.ascontiguousarray(lcups, dtype=np.int64)
    scups = np.ascontiguousarray(scups, dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, d in enumerate(datas):
        offsets[i + 1] = offsets[i] + len(d)
    blob = b''.join(bytes(d) for d in datas)
    data = np.frombuffer(blob, dtype=np.uint8)

    def words_for(bits_max):
        return int((bits_max + 31) // 32 + 2)

    mel_w = words_for(int((scups - 1).max()) * 8) if n else 3
    vlc_w = words_for(4 + int((scups - 2).max()) * 8) if n else 3
    ms_w = words_for(int((lcups - scups).max()) * 8) if n else 3
    if min_words is not None:
        mel_w = max(mel_w, min_words[0])
        vlc_w = max(vlc_w, min_words[1])
        ms_w = max(ms_w, min_words[2])
    mel = np.zeros((n, mel_w), dtype=np.uint32)
    vlc = np.zeros((n, vlc_w), dtype=np.uint32)
    ms = np.zeros((n, ms_w), dtype=np.uint32)
    lib.prep_cleanup_streams(
        data.ctypes.data, offsets.ctypes.data, lcups.ctypes.data,
        scups.ctypes.data, n,
        mel.ctypes.data, mel_w, vlc.ctypes.data, vlc_w,
        ms.ctypes.data, ms_w)
    return {'mel': mel, 'vlc': vlc, 'ms': ms}


def prep_refine_streams(datas, lcups, len2s, min_words=None,
                        nthreads: int = 0):
    """SigProp (forward, zero fill) and MagRef (backward, rev_init_mrp
    unstuffing) dense word streams of a batch's refinement segments,
    data[lcup : lcup+len2]; the contract of the JAX package's numpy
    refinement prep in tpu/block_refine.py (datas[i] holds at least
    lcups[i] + len2s[i] bytes)."""
    lib = _load()
    n = len(datas)
    lcups = np.ascontiguousarray(lcups, dtype=np.int64)
    len2s = np.ascontiguousarray(len2s, dtype=np.int64)
    # join only the refinement tails (the cleanup prefix is never
    # read here); the C++ sees each lane at offset 0 of its range
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(len2s, out=offsets[1:])
    blob = b''.join(bytes(d[lcups[i]:lcups[i] + len2s[i]])
                    for i, d in enumerate(datas))
    data = np.frombuffer(blob, dtype=np.uint8)
    zeros = np.zeros(n, dtype=np.int64)
    l2max = int(len2s.max()) if n else 0
    w = int((l2max * 8 + 1 + 31) // 32 + 2)
    ws, wm = w, w
    if min_words is not None:
        ws = max(ws, min_words[0])
        wm = max(wm, min_words[1])
    spp = np.zeros((n, ws), dtype=np.uint32)
    mrp = np.zeros((n, wm), dtype=np.uint32)
    lib.prep_refine_streams(
        data.ctypes.data, offsets.ctypes.data, zeros.ctypes.data,
        len2s.ctypes.data, n, spp.ctypes.data, ws,
        mrp.ctypes.data, wm, _threads(nthreads))
    return {'spp': spp, 'mrp': mrp}


def t2_walk_tile_part(data: np.ndarray, pos: int, data_left: int,
                      packets: np.ndarray, k0: int, rec: np.ndarray,
                      rpos: np.ndarray, st: np.ndarray) -> int:
    """Parse a tile-part's packets from row ``k0`` of the tile's packet
    table ``packets`` (int32 [npk, 36]) into its record tables ``rec``
    (int32 [ncb, 6]) and ``rpos`` (int64 [ncb]); ``st`` (int64 [3])
    receives the next row, pos and bytes left.  Returns 0 or the
    malformed packet's code (see ojtpu_native.cpp)."""
    lib = _load()
    return int(lib.t2_walk_tile_part(
        data.ctypes.data, pos, data_left, packets.ctypes.data,
        packets.shape[0], k0, rec.ctypes.data, rpos.ctypes.data,
        rpos.shape[0], st.ctypes.data))


def plan_lanes(data: np.ndarray, recs, poss, groups: np.ndarray,
               lane_map, lanes, code: np.ndarray,
               gstat: np.ndarray) -> None:
    """A frame's padded plan lanes from its tiles' record tables (``recs``
    / ``poss``, one pair a tile) through a skeleton's lane map: ``groups``
    int32 [ng, 4], ``lane_map`` (tile, record, qh, h, causal) a member,
    ``lanes`` the nine output arrays of ``_Plan.lanes``, ``code`` the
    broken code a lane, ``gstat`` int64 [ng, 4] (see ojtpu_native.cpp)."""
    lib = _load()
    rp = np.array([r.ctypes.data for r in recs], np.int64)
    pp = np.array([p.ctypes.data for p in poss], np.int64)
    ncb = np.array([p.shape[0] for p in poss], np.int64)
    rc = lib.plan_lanes(
        data.ctypes.data, data.shape[0], rp.ctypes.data, pp.ctypes.data,
        ncb.ctypes.data, len(recs), groups.ctypes.data, groups.shape[0],
        *(a.ctypes.data for a in lane_map),
        *(a.ctypes.data for a in lanes), code.ctypes.data,
        gstat.ctypes.data)
    if rc:
        raise RuntimeError('plan_lanes: a lane map entry lies outside '
                           'its tile\'s records')


def t2_emit_packet(bands: np.ndarray, recs: np.ndarray,
                   out: np.ndarray) -> int:
    """Emit one packet header (see ojtpu_native.cpp); returns header
    length, -1 on overflow, -2 on unsupported num_passes."""
    lib = _load()
    return int(lib.t2_emit_packet(bands.ctypes.data, recs.ctypes.data,
                                  out.ctypes.data, out.shape[0]))


# a raw pack splits over the library's kept threads, one part for each
# this many bytes of its buffer, at most 8: on the H100's host a gray
# burst of 8 (12 MB) packs in 0.67-0.79 ms in 8 parts against 1.90-1.95
# in one, an RGB frame (1.9 MB) in 0.28-0.33 against 0.43-0.47 (PERF.md
# section 6)
PACK_PART_BYTES = 1 << 18


def pack_raw_burst(src_ptrs, lcups, scups, p, qhl, refine, lead: int,
                   padded: int, out: np.ndarray) -> None:
    """Write a burst's raw-bytes upload buffer into ``out`` (see
    ojtpu_native.cpp): ``lead`` zero bytes, each lane's stuffed segment
    bytes from host address ``src_ptrs[i]`` (0: a dead lane), zeros to
    ``padded`` bytes, then the meta plane and, where ``refine`` =
    (len2, npasses, h_true, causal) is given, the rmeta plane.  ``out``
    holds exactly those bytes: padded + 32 bytes a lane a plane.  The
    copy splits into contiguous runs of lanes, one per PACK_PART_BYTES of
    ``padded``, on threads the library keeps."""
    lib = _load()
    n = len(src_ptrs)
    ar = [np.ascontiguousarray(a, t) for a, t in
          ((src_ptrs, np.int64), (lcups, np.int64), (scups, np.int64),
           (p, np.int32), (qhl, np.int32))]
    if refine is not None:
        ar += [np.ascontiguousarray(a, t) for a, t in
               zip(refine, (np.int64, np.int32, np.int32, np.uint8))]
    if any(a.shape != (n,) for a in ar) or not out.flags.c_contiguous \
            or out.nbytes != padded + 32 * n * (1 if refine is None else 2):
        raise ValueError('pack_raw_burst: lane arrays or out of the wrong '
                         'size')
    ptrs = [a.ctypes.data for a in ar] + [None] * (9 - len(ar))
    lib.pack_raw_burst(n, *ptrs, lead, padded, padded // PACK_PART_BYTES,
                       out.ctypes.data)


def prep_cleanup_dense(blob: bytes, offsets, lcups, scups, meta,
                       dense, nthreads: int = 0):
    """Unstuff a lane batch straight into the shared dense word
    buffer at the positions given by meta (see ojtpu_native.cpp)."""
    lib = _load()
    n = len(lcups)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lcups = np.ascontiguousarray(lcups, np.int64)
    scups = np.ascontiguousarray(scups, np.int64)
    meta = np.ascontiguousarray(meta, np.int32)
    data = np.frombuffer(blob, dtype=np.uint8)
    lib.prep_cleanup_dense(
        data.ctypes.data, offsets.ctypes.data, lcups.ctypes.data,
        scups.ctypes.data, n, meta.ctypes.data, dense.ctypes.data,
        _threads(nthreads))


def pack_from_dense(dense: np.ndarray, meta: np.ndarray, out_stride: int):
    """Assemble cleanup segments from device-packed dense bit streams.

    dense: uint32 buffer; meta int64 [n, 6] rows of (mel_off,
    mel_bits, vlc_off, vlc_bits, ms_off, ms_bits).  Returns
    (out [n, out_stride] uint8, lens [n] int64; 0 = overflow)."""
    lib = _load()
    n = meta.shape[0]
    dense = np.ascontiguousarray(dense, np.uint32)
    meta = np.ascontiguousarray(meta, np.int64)
    if n and (int(meta.min()) < 0 or int(
            (meta[:, 0::2] + (meta[:, 1::2] + 31) // 32).max())
            > dense.shape[0]):
        raise ValueError('pack_from_dense: a stream lies outside the '
                         'buffer')
    out = np.zeros((n, out_stride), np.uint8)
    lens = np.zeros(n, np.int64)
    lib.pack_from_dense(n, dense.ctypes.data, meta.ctypes.data,
                        out.ctypes.data, out_stride, lens.ctypes.data,
                        _threads(0))
    return out, lens


_DEC_ERRORS = {
    -1: (0x00080001, 'invalid scup'),
    -2: (0x00080002, 'wrong codeblock length'),
    -3: (0x00080003, 'more than 3 coding passes not supported'),
    -4: (0x00080004, '64 bits insufficient for this codeblock'),
    -5: (0x00080005, 'U_q exceeds missing_msbs + 2'),
}


def decode_codeblock(coded_data, missing_msbs, num_passes, len1, len2,
                     width, height, stripe_causal=False):
    """C++ scalar HT block decode (Cleanup, SigProp and MagRef, one
    codeblock at a time); returns the sign-magnitude array (uint32 for
    <=30 bit planes, uint64 beyond).  It is the independent per-block
    reference of the decode kernels, never on the decode path.  SigProp
    and MagRef take the cleanup's significance from its samples inside
    ``width`` x ``height``, as the fused decoders do.  Raises ValueError
    on a malformed codeblock."""
    qh = (height + 1) >> 1
    out = np.zeros((qh * 2, width), np.uint64)
    _decode_codeblock_into(out, coded_data, missing_msbs, num_passes, len1,
                           len2, width, height, stripe_causal)
    out = out[:height]
    if missing_msbs < 30:
        return out.astype(np.uint32)
    return out


def _decode_codeblock_into(out: np.ndarray, coded_data, missing_msbs,
                           num_passes, len1, len2, width, height,
                           stripe_causal=False) -> None:
    """decode_codeblock into ``out``, a C-contiguous uint64 buffer that
    starts with the decoder's [(height + 1) // 2 * 2, width] rows (the
    last one the padding row of an odd height); raises ValueError on a
    malformed codeblock."""
    lib = _load()
    from ..coding.tables import get_tables
    t = get_tables()
    data = np.ascontiguousarray(
        np.frombuffer(bytes(coded_data), np.uint8))
    if out.dtype != np.uint64 or not out.flags.c_contiguous or \
            out.size < ((height + 1) >> 1) * 2 * width:
        raise ValueError('out must be C-contiguous uint64 of at least '
                         '(height + 1) // 2 * 2 * width elements')
    rc = lib.decode_codeblock(
        data.ctypes.data, int(missing_msbs), int(num_passes),
        int(len1), int(len2), int(width), int(height),
        int(bool(stripe_causal)),
        np.ascontiguousarray(t['dec_vlc0'], np.uint16).ctypes.data,
        np.ascontiguousarray(t['dec_vlc1'], np.uint16).ctypes.data,
        np.ascontiguousarray(t['dec_uvlc0'], np.uint16).ctypes.data,
        np.ascontiguousarray(t['dec_uvlc1'], np.uint16).ctypes.data,
        np.ascontiguousarray(t['dec_uvlc0_bias'],
                             np.uint8).ctypes.data,
        out.ctypes.data)
    if rc < 0:
        code, msg = _DEC_ERRORS[rc]
        raise ValueError(f'ojph error 0x{code:08X}: {msg}')


_ENC_TABLES = None


def _enc_tables():
    global _ENC_TABLES
    if _ENC_TABLES is None:
        from ..coding.tables import get_tables
        t = get_tables()
        _ENC_TABLES = (
            np.ascontiguousarray(t['enc_vlc0'], np.uint16),
            np.ascontiguousarray(t['enc_vlc1'], np.uint16),
            np.ascontiguousarray(t['enc_uvlc'], np.uint8))
    return _ENC_TABLES


def encode_codeblock(buf, missing_msbs, width, height, bits=32):
    """C++ scalar HT cleanup-pass encode of one codeblock (``buf``: a
    sign-magnitude [>= height, >= width] array, uint32 patterns, or
    uint64 ones for the >30-bit-plane encoder64 regime at ``bits`` =
    64); returns the cleanup segment bytes, or None when an internal
    stream overflowed.  It is the independent per-block reference of the
    encode kernel, never on the encode path."""
    lib = _load()
    vlc0, vlc1, uvlc = _enc_tables()
    b = np.ascontiguousarray(buf[:height, :width], np.uint64)
    # worst case: ~ (bits+2)-bit MagSgn words per sample + header streams
    cap = int(width) * int(height) * (int(bits) // 8 + 3) + 8192
    out = np.empty(cap, np.uint8)
    n = int(lib.encode_codeblock(
        b.ctypes.data, b.shape[1] if b.size else width,
        int(missing_msbs), int(width), int(height), int(bits),
        vlc0.ctypes.data, vlc1.ctypes.data, uvlc.ctypes.data,
        out.ctypes.data, cap))
    if n < 0:
        return None
    return bytes(out[:n])
