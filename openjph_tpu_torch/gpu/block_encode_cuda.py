"""Wrapper of the CUDA HT cleanup-pass encoder (csrc/ht_cleanup_encode.cu),
the port of the JAX package's encode_cleanup_pallas_cat (K3).

An int64 ``buf`` (uint64 patterns, p = 63 - kmax: bands of more than 30
bit planes) launches the kernel's 64-bit instantiation
(``ht_cleanup_encode64``), an int32 one the 32-bit.

A CPU tensor takes the plain PyTorch version (block_encode.py).  A CUDA
tensor launches the kernel or raises: there is no fallback.  The kernel
encodes a codeblock's quad rows on one warp and its MEL stream on a
second, ``PER_BLOCK`` codeblocks per CUDA block.
It is compiled with nvcc for sm_90a at first use into
build/openjph_tpu_torch/ and bound with ctypes; it runs on the current
CUDA stream and allocates nothing.  ``LAUNCHES`` counts its launches.
The library, the device tables and the count are guarded by one lock, so
worker threads (the video encoder's) may launch it at once.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import block_encode as plain
from ._build import load_library, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc',
                   'ht_cleanup_encode.cu')
LAUNCHES = {'ht_cleanup_encode': 0, 'ht_cleanup_encode64': 0}
# codeblocks per CUDA block (two warps each); they share one copy of the
# encode tables in shared memory.  chip_smoke.py sweeps 1, 2, 4 and 8 on
# the 2048x1080 gray frame (608 lanes, and 8 x 608 as in a burst) and the
# RGB frame (1,816): on an H100 80GB HBM3 (700 W) 2 and 4 came within 3%
# of each other on one frame, 2 first by 1-6% on the larger batches, 1 and
# 8 some 30-45% behind; PERF.md has the times.
PER_BLOCK = 2

_lib = None
_TABLES = {}
_LOCK = threading.Lock()


def build(src: str = SRC, name: str = 'ht_cleanup_encode'):
    """Compile ``src``, a source with this kernel's C interface, with
    nvcc for sm_90a and load it with its entry points bound (the 64-bit
    one where the source has it)."""
    nvcc = nvcc_path()
    lib = load_library(
        name, [src],
        lambda out: [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                     '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                     '-o', out, src])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ('ht_cleanup_encode', 'ht_cleanup_encode64'):
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, ci,
                       ci, ci, ci, vp]
    return lib


def load():
    """Build (once) and load the kernel library."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build()
        return _lib


# MelEnc's exponent of each state k
_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def mel_tables():
    """The kernel's MEL coder tables, by MelEnc::encode's rules.  States
    s = (k, run) in order of k, then run (run < 2**exp(k)): 85 of them.
    Returns (step uint32 [85, 16, 2]: for state s and four events, event i
    at bit i of the index, the codewords' bits LSB-first | their count <<
    24, and the next state; kr uint32 [85]: k | run << 4)."""
    states = [(k, r) for k in range(13) for r in range(1 << _MEL_EXP[k])]
    index = {st: i for i, st in enumerate(states)}
    step = np.zeros((len(states), 16, 2), np.uint32)
    for s, (k0, r0) in enumerate(states):
        for nib in range(16):
            k, run, bits, n = k0, r0, 0, 0
            for i in range(4):
                e = _MEL_EXP[k]
                if not (nib >> i) & 1:
                    run += 1
                    if run >= 1 << e:
                        bits |= 1 << n
                        n += 1
                        run, k = 0, min(k + 1, 12)
                else:
                    # '0', then the e low bits of the run MSB-first
                    rev = int(f'{run:0{e}b}'[::-1], 2) if e else 0
                    bits |= (rev << 1) << n
                    n += 1 + e
                    run, k = 0, max(k - 1, 0)
            step[s, nib] = (bits | n << 24, index[(k, run)])
    kr = np.array([k | r << 4 for k, r in states], np.uint32)
    return step, kr


def _tables(device) -> torch.Tensor:
    """enc_vlc0|1 (4,096), enc_uvlc's four columns (4 x 75), the MEL step
    table (2,720) and the MEL states' (k, run) (85), int32."""
    key = str(device)
    with _LOCK:
        if key not in _TABLES:
            vlc, uvlc = plain.tables('cpu')
            step, kr = mel_tables()
            mel = torch.from_numpy(np.concatenate([step.reshape(-1), kr])
                                   .view(np.int32).astype(np.int64))
            t = torch.cat([vlc, uvlc.reshape(-1), mel]).to(torch.int32)
            _TABLES[key] = t.to(device)
        return _TABLES[key]


def encode_cleanup(buf, p, width: int, height: int, caps, qhl):
    """Encode N same-width codeblocks into dense MEL / VLC / MagSgn words.

    buf int32 [N, hp, wp] (hp = 2*ceil(height/2), wp = 4*ceil(width/4))
    holding uint32 sign-magnitude samples, or int64 holding uint64 ones,
    zero-padded; p = 31 - kmax (int64 ``buf``: 63 - kmax) and qhl
    (quad-row limit, 0 = no emission) int32 [N]; caps = (wm, wv, ws)
    word caps.  Returns (cat int32 [N, wm + wv + ws], bits int32
    [N, 3], ovf bool [N]) as block_encode.encode_cleanup_core does."""
    if buf.device.type == 'cpu':
        return plain.encode_cleanup_core(buf, p, width, height, caps, qhl)
    if buf.device.type != 'cuda':
        raise RuntimeError(f'no HT encoder for device {buf.device}')
    dev = buf.device
    n, hp, wp = buf.shape
    if hp != ((height + 1) // 2) * 2 or wp != ((width + 3) // 4) * 4:
        raise ValueError(f'buf {tuple(buf.shape)} does not fit '
                         f'{width}x{height} blocks')
    if buf.dtype not in (torch.int32, torch.int64):
        raise ValueError(f'buf must be int32 or int64, got {buf.dtype}')
    for name, t in (('buf', buf), ('p', p), ('qhl', qhl)):
        if name != 'buf' and t.dtype != torch.int32:
            raise ValueError(f'{name} must be int32, got {t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, expected {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if p.shape != (n,) or qhl.shape != (n,):
        raise ValueError('lane counts differ')
    if buf.data_ptr() % 16:
        raise ValueError('buf must be 16-byte aligned')
    out = launch(load(), PER_BLOCK, buf, p, width, height, caps, qhl)
    with _LOCK:
        LAUNCHES[_entry(buf)] += 1
    return out


def _entry(buf) -> str:
    return ('ht_cleanup_encode64' if buf.dtype == torch.int64
            else 'ht_cleanup_encode')


def launch(lib, per_block: int, buf, p, width: int, height: int, caps,
           qhl, zeroed: bool = False):
    """One launch of ``lib``'s entry of ``buf``'s width on checked CUDA
    tensors.  This checkout's kernel writes every word of ``cat``;
    ``zeroed`` hands an older source that leaves the words past each
    used prefix to its caller (``chip_smoke.py --against-encode``) a
    zeroed ``cat``."""
    dev = buf.device
    n, hp, wp = buf.shape
    wm, wv, ws = (int(c) for c in caps)
    alloc = torch.zeros if zeroed else torch.empty
    cat = alloc((n, wm + wv + ws), dtype=torch.int32, device=dev)
    bits = torch.empty((n, 3), dtype=torch.int32, device=dev)
    ovf = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _entry(buf))(
            buf.data_ptr(), hp, wp, p.data_ptr(), qhl.data_ptr(),
            _tables(dev).data_ptr(), cat.data_ptr(), wm, wv, ws,
            bits.data_ptr(), ovf.data_ptr(), n, width, height, per_block,
            stream)
    if rc != 0:
        raise RuntimeError(f'{_entry(buf)} launch failed: CUDA error {rc}')
    return cat, bits, ovf


def reset_launches():
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
