"""Native (C++) host kernels, built on demand with g++ and bound via
ctypes: the scalar HT codeblock decoder and encoder (Tier-1).

Frozen copy for the benchmark's reference: this loader is
openjph_tpu/native/__init__.py cut down to those coders, and
ojtpu_native.cpp is openjph_tpu_torch/native/ojtpu_native.cpp, both as
of the benchmark's first version.  The file's packet-header parser and
emitter and its segment packers are the program's own host code; they
are compiled with it but never called: the reference's Tier-2 is
core/t2.py's Python.  The library builds into <checkout>/build/gpubench/
and a failed build raises instead of falling back to the Python coders.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'ojtpu_native.cpp')
# <checkout>/build/gpubench/: a fixed directory, ignored by git, so that
# only a checkout's first run compiles
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(_DIR)))), 'build', 'gpubench')
_lock = threading.Lock()
_lib = None
_failed = False


def _so_path() -> str:
    with open(_SRC, 'rb') as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f'ojtpu_native-{h}.so')


def _build() -> str:
    """Compile the library unless this source's build exists; raise if
    the compiler fails (the reference has no slow fallback)."""
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    r = subprocess.run(['g++', '-O3', '-march=native', '-shared', '-fPIC',
                        '-o', tmp, _SRC, '-lpthread'],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f'building the reference library failed:\n'
                           f'{r.stderr}')
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.decode_codeblock.restype = ctypes.c_int
        lib.decode_codeblock.argtypes = [
            ctypes.c_void_p] + [ctypes.c_int64] * 7 + \
            [ctypes.c_void_p] * 6
        lib.encode_codeblock.restype = ctypes.c_int64
        lib.encode_codeblock.argtypes = [
            ctypes.c_void_p] + [ctypes.c_int64] * 5 + \
            [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int64]
        lib.encode_codeblock_batch.restype = None
        lib.encode_codeblock_batch.argtypes = [
            ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + \
            [ctypes.c_void_p] * 4 + \
            [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


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
    """C++ scalar HT cleanup-pass encode (port of coding/encoder.py,
    incl. the >30-bit-plane encoder64 regime); returns the cleanup
    segment bytes, or None when the native library is unavailable or
    an internal stream overflowed (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return None
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


def encode_codeblock_batch(subs, missing_msbs, bits=32, nthreads=0):
    """Thread-parallel cleanup encode over one subband's codeblocks
    (shared missing_msbs/bits).  ``subs`` are 2D sign-magnitude
    arrays; returns a list of segment bytes with None entries on
    per-block overflow, or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    vlc0, vlc1, uvlc = _enc_tables()
    n = len(subs)
    offs = np.zeros(n, np.int64)
    ws = np.zeros(n, np.int64)
    hs = np.zeros(n, np.int64)
    total = 0
    maxwh = 0
    for i, s in enumerate(subs):
        h, w = s.shape
        ws[i] = w
        hs[i] = h
        offs[i] = total
        total += w * h
        maxwh = max(maxwh, w * h)
    blob = np.empty(total, np.uint64)
    for i, s in enumerate(subs):
        blob[offs[i]:offs[i] + ws[i] * hs[i]] = \
            np.asarray(s, np.uint64).ravel()
    out_stride = maxwh * (int(bits) // 8 + 3) + 8192
    out = np.empty((n, out_stride), np.uint8)
    lens = np.zeros(n, np.int64)
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    lib.encode_codeblock_batch(
        blob.ctypes.data, offs.ctypes.data, ws.ctypes.data,
        hs.ctypes.data, n, int(missing_msbs), int(bits),
        vlc0.ctypes.data, vlc1.ctypes.data, uvlc.ctypes.data,
        out.ctypes.data, out_stride, lens.ctypes.data, nthreads)
    return [bytes(out[i, :lens[i]]) if lens[i] > 0 else None
            for i in range(n)]


_DEC_ERRORS = {
    -1: (0x00080001, 'invalid scup'),
    -2: (0x00080002, 'wrong codeblock length'),
    -3: (0x00080003, 'more than 3 coding passes not supported'),
    -4: (0x00080004, '64 bits insufficient for this codeblock'),
    -5: (0x00080005, 'U_q exceeds missing_msbs + 2'),
}


def decode_codeblock(coded_data, missing_msbs, num_passes, len1, len2,
                     width, height, stripe_causal=False):
    """C++ scalar HT block decode (port of coding/decoder.py, the
    64-bit-capable host path); returns the sign-magnitude array
    (uint32 for <=30 bit planes, uint64 beyond) or None when the
    native library is unavailable.  Raises ValueError on the same
    malformed-stream conditions as the Python reference."""
    lib = _load()
    if lib is None:
        return None
    from ..coding.tables import get_tables
    t = get_tables()
    data = np.ascontiguousarray(
        np.frombuffer(bytes(coded_data), np.uint8))
    qh = (height + 1) >> 1
    out = np.zeros((qh * 2, width), np.uint64)
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
    out = out[:height]
    if missing_msbs < 30:
        return out.astype(np.uint32)
    return out
