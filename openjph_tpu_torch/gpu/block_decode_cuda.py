"""Wrapper of the CUDA HT cleanup-pass decoder (csrc/ht_cleanup_decode.cu),
with its two entry points:

- :func:`decode_cleanup` (dense readers; the JAX package's
  decode_cleanup_pallas): dense, host-unstuffed word rows;
- :func:`decode_cleanup_raw` (raw readers; decode_cleanup_pallas_raw):
  each lane's stuffed bytes in the packed segment blob.

``bits=64`` selects the kernel's 64-bit instantiation (entries
``..._dense64`` / ``..._raw64``): p = 62 - missing_msbs and ``dec``
int64 holding uint64 patterns, for codeblocks of more than 30 bit
planes.

A CPU tensor takes the plain PyTorch version (block_decode.py, plus
unstuff.py for the raw readers).  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernel decodes one codeblock per
warp, ``PER_BLOCK`` codeblocks per CUDA block.  It is compiled with nvcc
for sm_90a at first use into build/openjph_tpu_torch/ and bound with
ctypes; it runs on the current CUDA stream and allocates nothing.
``LAUNCHES`` counts the kernel launches of each entry point.  The
library, the device tables and the counts are guarded by one lock, so
worker threads (the video decoders') may launch it at once.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import block_decode as plain
from ._build import load_library, nvcc_path
from .unstuff import raw_to_dense

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc',
                   'ht_cleanup_decode.cu')
LAUNCHES = {'ht_cleanup_decode_dense': 0, 'ht_cleanup_decode_raw': 0,
            'ht_cleanup_decode_dense64': 0, 'ht_cleanup_decode_raw64': 0}
# codeblocks (warps) per CUDA block; they share one copy of the decode
# tables in shared memory.  chip_smoke.py's sweep over 1, 2, 4 and 8 on
# the 2048x1080 gray frame's 768 lanes put 4 first or within 2% of the
# best in both reader modes on an H100 80GB HBM3 (700 W), and 8 last; PERF.md
# has the times.
PER_BLOCK = 4
# HTJ2K's cap on a codeblock's MEL / VLC suffix (Scup), in bytes; a raw
# lane with a longer suffix is flagged and zeroed
MAX_SUFFIX = 4079

_lib = None
_TABLES = {}
_LOCK = threading.Lock()


def build(src: str = SRC, name: str = 'ht_cleanup_decode', defines=()):
    """Compile ``src``, a source with this kernel's C interface, with
    nvcc for sm_90a (``defines``: extra -D macros) and load it with its
    entry points bound (the 64-bit ones where the source has them)."""
    nvcc = nvcc_path()
    flags = [f'-D{d}' for d in defines]
    lib = load_library(
        name, [src],
        lambda out: [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                     '-std=c++17', '-O3', *flags, '-shared', '-Xcompiler',
                     '-fPIC', '-o', out, src])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for sfx in ('', '64'):
        if sfx and not hasattr(lib, 'ht_cleanup_decode_dense64'):
            break
        dense = getattr(lib, 'ht_cleanup_decode_dense' + sfx)
        dense.restype = ci
        dense.argtypes = (
            [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp])
        raw = getattr(lib, 'ht_cleanup_decode_raw' + sfx)
        raw.restype = ci
        raw.argtypes = (
            [vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
             ci, ci, vp])
    return lib


def load():
    """Build (once) and load the kernel library."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build()
        return _lib


def _tables(device, bits: int = 32) -> torch.Tensor:
    """dec_vlc0|1 (2048) + dec_uvlc0|1 (576) as one int32 tensor; at
    ``bits`` = 64 followed by dec_uvlc0_bias (320)."""
    key = (str(device), bits)
    with _LOCK:
        if key not in _TABLES:
            vlc, uvlc, _ = plain.tables('cpu')
            parts = [vlc, uvlc]
            if bits == 64:
                parts.append(plain.uvlc_bias('cpu'))
            _TABLES[key] = torch.cat(parts).to(torch.int32).to(device)
        return _TABLES[key]


def _entry(bits: int) -> str:
    if bits not in (32, 64):
        raise ValueError(f'bits must be 32 or 64, got {bits}')
    return '' if bits == 32 else '64'


def _check(device, **tensors):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, expected {device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _i32(t):
    if t.dtype != torch.int32:
        raise ValueError(f'expected int32, got {t.dtype}')
    return t


def decode_cleanup(melw, vlcw, msw, p, width: int, height: int,
                   qh_lim=None, bits: int = 32):
    """Decode N same-shape codeblocks from dense word rows.

    melw / vlcw / msw: int32 [N, W*] holding uint32 words; p = 30 -
    missing_msbs [N] int32 (62 - missing_msbs at ``bits`` = 64); qh_lim
    [N] int32 quad-row limit (None: every row).  Returns (dec int32 [N,
    height, width] uint32 bit patterns, int64 uint64 ones at ``bits`` =
    64, rows at or past 2*qh_lim zero; err bool [N])."""
    sfx = _entry(bits)
    n = melw.shape[0]
    if qh_lim is None:
        qh_lim = torch.full((n,), (height + 1) >> 1, dtype=torch.int32,
                            device=melw.device)
    if melw.device.type == 'cpu':
        return plain.decode_cleanup_core(melw, vlcw, msw, p, width, height,
                                         qh_lim, bits)
    if melw.device.type != 'cuda':
        raise RuntimeError(f'no HT decoder for device {melw.device}')
    dev = melw.device
    for t in (melw, vlcw, msw, p, qh_lim):
        _i32(t)
    _check(dev, melw=melw, vlcw=vlcw, msw=msw, p=p, qh_lim=qh_lim)
    if not (vlcw.shape[0] == msw.shape[0] == p.shape[0]
            == qh_lim.shape[0] == n):
        raise ValueError('lane counts differ')
    out = launch_dense(load(), PER_BLOCK, melw, vlcw, msw, p, width,
                       height, qh_lim, bits)
    with _LOCK:
        LAUNCHES['ht_cleanup_decode_dense' + sfx] += 1
    return out


def launch_dense(lib, per_block: int, melw, vlcw, msw, p, width: int,
                 height: int, qh_lim, bits: int = 32):
    """One launch of ``lib``'s dense entry (of ``bits``) on checked CUDA
    tensors."""
    name = 'ht_cleanup_decode_dense' + _entry(bits)
    dev = melw.device
    dec = torch.empty((melw.shape[0], height, width),
                      dtype=torch.int64 if bits == 64 else torch.int32,
                      device=dev)
    err = torch.empty((melw.shape[0],), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            melw.data_ptr(), vlcw.data_ptr(), msw.data_ptr(),
            melw.shape[1], vlcw.shape[1], msw.shape[1], p.data_ptr(),
            qh_lim.data_ptr(), _tables(dev, bits).data_ptr(),
            dec.data_ptr(), err.data_ptr(), melw.shape[0], width, height,
            per_block, stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    return dec, err


def decode_cleanup_raw_plain(blob, lane_off, ms_n, sh_n, p, width: int,
                             height: int, qh_lim, words, bits: int = 32):
    """Plain version of the raw-reader mode: unstuff.raw_to_dense, then
    the plain block decoder.  A lane whose byte range leaves the blob,
    or whose suffix is longer than MAX_SUFFIX, decodes to zeros with its
    error flag set, as in the kernel."""
    mel, vlc, ms = raw_to_dense(blob, lane_off, ms_n, sh_n, words)
    dec, err = plain.decode_cleanup_core(mel, vlc, ms, p, width, height,
                                         qh_lim, bits)
    off = lane_off.to(torch.int64)
    bad = ((off < 0) | (ms_n < 0) | (sh_n < 1) | (sh_n > MAX_SUFFIX)
           | (off + ms_n + sh_n > blob.shape[0]))
    dec = torch.where(bad[:, None, None], torch.zeros_like(dec), dec)
    return dec, err | bad


def decode_cleanup_raw(blob, lane_off, ms_n, sh_n, p, width: int,
                       height: int, qh_lim, words, bits: int = 32):
    """Decode N same-shape codeblocks straight from the segment blob.

    blob: uint8 [B]; lane i's MagSgn bytes are blob[lane_off[i] :
    lane_off[i] + ms_n[i]], followed by its sh_n[i] MEL/VLC bytes (the
    last one OR'd 0xF by the packer).  ``words`` = (wm, wv, ws) sizes
    the plain version's dense rows; the kernel has no such limit.
    Returns (dec, err) as :func:`decode_cleanup` (``bits`` likewise)."""
    sfx = _entry(bits)
    if blob.device.type == 'cpu':
        return decode_cleanup_raw_plain(blob, lane_off, ms_n, sh_n, p,
                                        width, height, qh_lim, words, bits)
    if blob.device.type != 'cuda':
        raise RuntimeError(f'no HT decoder for device {blob.device}')
    dev = blob.device
    if blob.dtype != torch.uint8:
        raise ValueError(f'blob must be uint8, got {blob.dtype}')
    for t in (lane_off, ms_n, sh_n, p, qh_lim):
        _i32(t)
    _check(dev, blob=blob, lane_off=lane_off, ms_n=ms_n, sh_n=sh_n, p=p,
           qh_lim=qh_lim)
    n = lane_off.shape[0]
    if not (ms_n.shape[0] == sh_n.shape[0] == p.shape[0]
            == qh_lim.shape[0] == n):
        raise ValueError('lane counts differ')
    out = launch_raw(load(), PER_BLOCK, blob, lane_off, ms_n, sh_n, p,
                     width, height, qh_lim, bits)
    with _LOCK:
        LAUNCHES['ht_cleanup_decode_raw' + sfx] += 1
    return out


def launch_raw(lib, per_block: int, blob, lane_off, ms_n, sh_n, p,
               width: int, height: int, qh_lim, bits: int = 32):
    """One launch of ``lib``'s raw entry (of ``bits``) on checked CUDA
    tensors."""
    name = 'ht_cleanup_decode_raw' + _entry(bits)
    dev = blob.device
    n = lane_off.shape[0]
    dec = torch.empty((n, height, width),
                      dtype=torch.int64 if bits == 64 else torch.int32,
                      device=dev)
    err = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            blob.data_ptr(), blob.shape[0], lane_off.data_ptr(),
            ms_n.data_ptr(), sh_n.data_ptr(), p.data_ptr(),
            qh_lim.data_ptr(), _tables(dev, bits).data_ptr(),
            dec.data_ptr(), err.data_ptr(), n, width, height, per_block,
            stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    return dec, err


def reset_launches():
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0

