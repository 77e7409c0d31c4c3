"""Wrapper of the CUDA HT refinement-pass encoder, SigProp and MagRef
(csrc/ht_refine_encode.cu, K5): the refinement segment of each lane of an
encode lane group, from the samples the cleanup encoder takes.

No TPU kernel is behind it: the JAX package codes these passes on its
host (coding/encoder.py::encode_spp_mrp).  A CPU tensor takes the plain
PyTorch version (block_refine_encode.py).  A CUDA tensor launches the
kernel or raises: there is no fallback.  The kernel codes a codeblock on
two warps (MagRef's records and packer beside SigProp's chain),
``PER_BLOCK`` codeblocks a CUDA block.  It is compiled with nvcc for
sm_90a at first use into build/openjph_tpu_torch/ and bound with ctypes;
it runs on the current CUDA stream and allocates nothing.  ``LAUNCHES``
counts its launches.  The library and the count are guarded by one lock,
so worker threads (the video encoder's) may launch it at once.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import block_refine_encode as plain
from ._build import load_library, nvcc_path
from .block_decode_cuda import _check, _i32

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc',
                   'ht_refine_encode.cu')
LAUNCHES = {'ht_refine_encode': 0}
# codeblocks a CUDA block (1 to 4), each with its own shared memory: 2 was
# the fastest on the 3-pass 2048x1080 frame's lanes and on an 8-frame
# burst's on an H100 (chip_smoke.py's k5_vs_plain sweep)
PER_BLOCK = 2

_lib = None
_LOCK = threading.Lock()


def build(src: str = SRC, name: str = 'ht_refine_encode'):
    """Compile ``src``, a source with this kernel's C interface, with
    nvcc for sm_90a and load it with its entry points bound."""
    nvcc = nvcc_path()
    lib = load_library(
        name, [src],
        lambda out: [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                     '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                     '-o', out, src])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ht_refine_encode.restype = ci
    lib.ht_refine_encode.argtypes = [vp, ci, ci, vp, vp, vp, ci, vp, ci, vp,
                                     vp, ci, ci, ci, ci, vp]
    return lib


def load():
    """Build (once) and load the kernel library."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build()
        return _lib


def encode_refine(buf, p, h_lim, npasses, causal: bool, width: int,
                  height: int, cap: int):
    """SigProp and MagRef segments of N same-width codeblocks.

    buf int32 [N, hp, wp] (hp = 2*ceil(height/2), wp = 4*ceil(width/4))
    holding uint32 sign-magnitude samples, zero-padded, as the cleanup
    encoder takes them; p (30 - missing_msbs of the cleanup pass), h_lim
    (true heights) and npasses int32 [N]; ``causal`` the stripe-causal
    mode; ``cap`` words a lane (block_refine_encode.cap_words covers any
    codeblock).  Returns (out int32 [N, cap], lens int32 [N, 2], ovf bool
    [N]) as block_refine_encode.encode_refine_core does."""
    if buf.device.type == 'cpu':
        return plain.encode_refine_core(buf, p, h_lim, npasses, causal,
                                        width, height, cap)
    if buf.device.type != 'cuda':
        raise RuntimeError(f'no HT refinement encoder for {buf.device}')
    n, hp, wp = buf.shape
    if hp != ((height + 1) // 2) * 2 or wp != ((width + 3) // 4) * 4:
        raise ValueError(f'buf {tuple(buf.shape)} does not fit '
                         f'{width}x{height} blocks')
    if buf.dtype != torch.int32:
        raise ValueError(f'buf must be int32, got {buf.dtype}')
    for name, t in (('p', p), ('h_lim', h_lim), ('npasses', npasses)):
        _i32(t)
        if t.shape != (n,):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'({n},)')
    _check(buf.device, buf=buf, p=p, h_lim=h_lim, npasses=npasses)
    if buf.data_ptr() % 16:
        raise ValueError('buf must be 16-byte aligned')
    if cap < 0:
        raise ValueError(f'cap must be >= 0, got {cap}')
    out = launch(load(), PER_BLOCK, buf, p, h_lim, npasses, causal, width,
                 height, cap)
    with _LOCK:
        LAUNCHES['ht_refine_encode'] += 1
    return out


def launch(lib, per_block: int, buf, p, h_lim, npasses, causal: bool,
           width: int, height: int, cap: int):
    """One launch of ``lib``'s entry on checked CUDA tensors."""
    dev = buf.device
    n, hp, wp = buf.shape
    out = torch.empty((n, cap), dtype=torch.int32, device=dev)
    lens = torch.empty((n, 2), dtype=torch.int32, device=dev)
    ovf = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ht_refine_encode(
            buf.data_ptr(), hp, wp, p.data_ptr(), h_lim.data_ptr(),
            npasses.data_ptr(), int(bool(causal)), out.data_ptr(), cap,
            lens.data_ptr(), ovf.data_ptr(), n, width, height, per_block,
            stream)
    if rc != 0:
        raise RuntimeError(f'ht_refine_encode launch failed: CUDA error '
                           f'{rc}')
    return out, lens, ovf


def reset_launches():
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
