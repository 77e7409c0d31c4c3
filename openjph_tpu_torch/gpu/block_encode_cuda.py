"""Wrapper of the CUDA HT cleanup-pass encoder (csrc/ht_cleanup_encode.cu),
the port of the JAX package's encode_cleanup_pallas_cat (K3).

A CPU tensor takes the plain PyTorch version (block_encode.py).  A CUDA
tensor launches the kernel or raises: there is no fallback.  The kernel
is compiled with nvcc for sm_90a at first use into
build/openjph_tpu_torch/ and bound with ctypes; it runs on the current
CUDA stream and allocates nothing.  ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import block_encode as plain
from ._build import load_library, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc',
                   'ht_cleanup_encode.cu')
LAUNCHES = {'ht_cleanup_encode': 0}
# codeblocks (threads) per CUDA block.  On an H100 (700 W), 2 beat 1, 4,
# 8 and 32 on the 2048x1080 gray frame's 604 lanes (chip_smoke.py's
# sweep), as for the decoder: lanes of a warp diverge at every branch
THREADS = 2

_lib = None
_TABLES = {}


def load():
    """Build (once) and load the kernel library."""
    global _lib
    if _lib is None:
        nvcc = nvcc_path()
        lib = load_library(
            'ht_cleanup_encode', [SRC],
            lambda out: [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                         '-std=c++17', '-O3', '-shared', '-Xcompiler',
                         '-fPIC', '-o', out, SRC])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ht_cleanup_encode.restype = ci
        lib.ht_cleanup_encode.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, ci,
                                          ci, vp, vp, ci, ci, ci, ci, vp]
        _lib = lib
    return _lib


def _tables(device) -> torch.Tensor:
    """enc_vlc0|1 (4,096) + enc_uvlc's four columns (4 x 75), int32."""
    key = str(device)
    if key not in _TABLES:
        vlc, uvlc = plain.tables('cpu')
        t = torch.cat([vlc, uvlc.reshape(-1)]).to(torch.int32)
        _TABLES[key] = t.to(device)
    return _TABLES[key]


def encode_cleanup(buf, p, width: int, height: int, caps, qhl):
    """Encode N same-width codeblocks into dense MEL / VLC / MagSgn words.

    buf int32 [N, hp, wp] (hp = 2*ceil(height/2), wp = 4*ceil(width/4))
    holding uint32 sign-magnitude samples, zero-padded; p = 31 - kmax
    and qhl (quad-row limit, 0 = no emission) int32 [N]; caps = (wm, wv,
    ws) word caps.  Returns (cat int32 [N, wm + wv + ws], bits int32
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
    for name, t in (('buf', buf), ('p', p), ('qhl', qhl)):
        if t.dtype != torch.int32:
            raise ValueError(f'{name} must be int32, got {t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, expected {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if p.shape != (n,) or qhl.shape != (n,):
        raise ValueError('lane counts differ')
    if buf.data_ptr() % 16:
        raise ValueError('buf must be 16-byte aligned')
    wm, wv, ws = (int(c) for c in caps)
    lib = load()
    cat = torch.zeros((n, wm + wv + ws), dtype=torch.int32, device=dev)
    bits = torch.empty((n, 3), dtype=torch.int32, device=dev)
    ovf = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ht_cleanup_encode(
            buf.data_ptr(), hp, wp, p.data_ptr(), qhl.data_ptr(),
            _tables(dev).data_ptr(), cat.data_ptr(), wm, wv, ws,
            bits.data_ptr(), ovf.data_ptr(), n, width, height, THREADS,
            stream)
    if rc != 0:
        raise RuntimeError(f'ht_cleanup_encode launch failed: CUDA error '
                           f'{rc}')
    LAUNCHES['ht_cleanup_encode'] += 1
    return cat, bits, ovf


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
