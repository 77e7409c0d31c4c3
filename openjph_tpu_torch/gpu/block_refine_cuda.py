"""Wrapper of the CUDA HT refinement-pass decoder, SigProp and MagRef
(csrc/ht_refine_decode.cu), with its two entry points:

- :func:`refine` (dense readers): host-unstuffed SigProp / MagRef word
  rows, as the JAX package's runner feeds tpu/block_refine.py::refine_core
  in dense mode;
- :func:`refine_raw` (raw readers; unstuff_spp / unstuff_mrp): each lane's
  stuffed refinement segment in the packed segment blob.

An int64 ``dec`` (uint64 patterns, p = 62 - missing_msbs: codeblocks of
more than 30 bit planes) launches the kernel's 64-bit instantiation
(entries ``..._dense64`` / ``..._raw64``), an int32 one the 32-bit.

A CPU tensor takes the plain PyTorch version (block_refine.py, plus
unstuff.py for the raw readers).  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernel refines one codeblock per warp,
``PER_BLOCK`` codeblocks per CUDA block, writing ``dec`` in place; its
SigProp chain steps a group's columns through a table built here
(:func:`spp_column_table`) and handed to each library once per device,
and on a launch of many codeblocks a block's chains share one warp.
It is compiled with nvcc for sm_90a at first use into
build/openjph_tpu_torch/ and bound with ctypes; it runs on the current
CUDA stream and allocates nothing.  ``LAUNCHES`` counts the kernel
launches of each entry point.  The library, the table hand-over and the
counts are guarded by one lock, so worker threads (the video decoders')
may launch it at once.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import block_refine as plain
from ._build import load_library, nvcc_path
from .block_decode_cuda import _check, _i32
from .unstuff import raw_refine_to_dense

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc',
                   'ht_refine_decode.cu')
LAUNCHES = {'ht_refine_decode_dense': 0, 'ht_refine_decode_raw': 0,
            'ht_refine_decode_dense64': 0, 'ht_refine_decode_raw64': 0}
# codeblocks (warps) per CUDA block.  chip_smoke.py sweeps 1, 2, 4 and 8
# on the 3-pass 2048x1080 gray frame's 768 lanes and on those lanes
# repeated as in an 8-frame burst: on an H100 80GB HBM3 (700 W) 4 came
# within 1% of the best on the frame and first on the burst, where a
# launch of that size puts a block's four SigProp chains on one warp
# (8 some 10% and 1 or 2 some 30% behind); PERF.md has the times.
PER_BLOCK = 4

# SigProp's column table (csrc/ht_refine_decode.cu kTableEntries, of two
# bytes each)
TABLE_ENTRIES = 4096
TABLE_BYTES = 2 * TABLE_ENTRIES

_lib = None
# (library path, device index) pairs whose table is set
_TABLES_SET = set()
_LOCK = threading.Lock()


def build(src: str = SRC, name: str = 'ht_refine_decode'):
    """Compile ``src``, a source with this kernel's C interface, with
    nvcc for sm_90a and load it with its entry points bound.  An older
    source without the table entry (``ht_refine_set_tables``) loads
    too."""
    nvcc = nvcc_path()
    lib = load_library(
        name, [src],
        lambda out: [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                     '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                     '-o', out, src])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, 'ht_refine_set_tables'):
        lib.ht_refine_set_tables.restype = ci
        lib.ht_refine_set_tables.argtypes = [vp, ci]
        lib.ht_refine_warp_bytes.restype = ci
        lib.ht_refine_warp_bytes.argtypes = [ci, ci]
        lib.ht_refine_packs.restype = ci
        lib.ht_refine_packs.argtypes = [ci, ci, ci, ci]
    for sfx in ('', '64'):
        if sfx and not hasattr(lib, 'ht_refine_decode_dense64'):
            break
        dense = getattr(lib, 'ht_refine_decode_dense' + sfx)
        dense.restype = ci
        dense.argtypes = (
            [vp, vp, vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp])
        raw = getattr(lib, 'ht_refine_decode_raw' + sfx)
        raw.restype = ci
        raw.argtypes = (
            [vp, vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, ci, ci, ci,
             ci, vp])
    return lib


def load():
    """Build (once) and load the kernel library."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build()
        return _lib


def spp_column_table() -> np.ndarray:
    """SigProp's step over one column of a 4x4 group, as the kernel's
    uint16 [4096] table.  Index: the next four stream bits (bits 0-3, the
    first at bit 0) | the column's candidates (bits 4-7, row k at bit k) |
    its rows not yet significant (bits 8-11).  The rows are visited top
    down; a row is a candidate when its bit is set or the row above just
    turned significant and the row is not yet significant; a candidate
    reads one bit and turns significant on a 1.  Entry: the bits read
    (0-4) | the new significance spread to rows k-1..k+1 << 5 (the next
    column's candidates, placed as in the entry's byte offset 2 * index)
    | the new significance << 9 | its popcount (the sign bits) << 13."""
    table = np.zeros(TABLE_ENTRIES, np.uint16)
    for i in range(TABLE_ENTRIES):
        win, cand, inv = i & 0xF, (i >> 4) & 0xF, i >> 8
        sig = read = 0
        for row in range(4):
            spread = row > 0 and (sig >> (row - 1)) & 1 and (inv >> row) & 1
            if (cand >> row) & 1 or spread:
                sig |= ((win >> read) & 1) << row
                read += 1
        spread = (sig | sig << 1 | sig >> 1) & 0xF
        table[i] = (read | spread << 5 | sig << 9
                    | bin(sig).count('1') << 13)
    return table


def set_tables(lib, device) -> None:
    """Hand ``lib`` the column table on ``device`` (once per pair); a
    source without the entry needs none."""
    fn = getattr(lib, 'ht_refine_set_tables', None)
    key = (lib._name, device.index)
    with _LOCK:
        if fn is None or key in _TABLES_SET:
            return
        table = spp_column_table()
        with torch.cuda.device(device):
            rc = fn(table.ctypes.data, table.nbytes)
        if rc != 0:
            raise RuntimeError(f'ht_refine_set_tables failed: CUDA error '
                               f'{rc}')
        _TABLES_SET.add(key)


def _check_lanes(dec, width: int, height: int, **lanes) -> str:
    """Checks ``dec`` and the lane columns; returns the entry suffix of
    ``dec``'s width ('' for int32, '64' for int64)."""
    n = dec.shape[0]
    if dec.dtype not in (torch.int32, torch.int64) \
            or tuple(dec.shape) != (n, height, width):
        raise ValueError(f'dec must be int32 or int64 [N, {height}, '
                         f'{width}], got {dec.dtype} {tuple(dec.shape)}')
    for name, t in lanes.items():
        _i32(t)
        if t.shape[0] != n:
            raise ValueError(f'{name} has {t.shape[0]} lanes, dec {n}')
    return '64' if dec.dtype == torch.int64 else ''


# plain version of the dense mode
refine_plain = plain.refine_core


def refine(dec, spp, mrp, p, npasses, h_lim, causal, width: int,
           height: int):
    """SigProp and MagRef of N same-shape codeblocks from dense word rows.

    dec: int32 [N, height, width], the cleanup output (uint32 bit
    patterns), or int64 (uint64 patterns); spp / mrp: int32 [N, W*]
    holding uint32 words; p = 30 - missing_msbs (int64 ``dec``: 62 -
    missing_msbs), npasses, h_lim (true heights) and causal (nonzero:
    the stripe-causal mode) int32 [N].  Returns the refined samples: on the
    card ``dec`` itself, refined in place; on the CPU a new tensor."""
    if dec.device.type == 'cpu':
        return refine_plain(dec, spp, mrp, p, npasses, h_lim, causal, width,
                            height)
    if dec.device.type != 'cuda':
        raise RuntimeError(f'no HT refinement decoder for {dec.device}')
    sfx = _check_lanes(dec, width, height, spp=spp, mrp=mrp, p=p,
                       npasses=npasses, h_lim=h_lim, causal=causal)
    _check(dec.device, dec=dec, spp=spp, mrp=mrp, p=p, npasses=npasses,
           h_lim=h_lim, causal=causal)
    launch_dense(load(), PER_BLOCK, dec, spp, mrp, p, npasses, h_lim, causal,
                 width, height)
    with _LOCK:
        LAUNCHES['ht_refine_decode_dense' + sfx] += 1
    return dec


def launch_dense(lib, per_block: int, dec, spp, mrp, p, npasses, h_lim,
                 causal, width: int, height: int):
    """One launch of ``lib``'s dense entry of ``dec``'s width on checked
    CUDA tensors."""
    name = 'ht_refine_decode_dense' + ('64' if dec.dtype == torch.int64
                                       else '')
    dev = dec.device
    set_tables(lib, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            dec.data_ptr(), spp.data_ptr(), mrp.data_ptr(), spp.shape[1],
            mrp.shape[1], p.data_ptr(), npasses.data_ptr(), h_lim.data_ptr(),
            causal.data_ptr(), dec.shape[0], width, height, per_block, stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    return dec


def refine_raw_plain(dec, blob, roff, len2, p, npasses, h_lim, causal,
                     width: int, height: int):
    """Plain version of the raw-reader mode: unstuff.raw_refine_to_dense
    into rows that cover every lane's segment with zero words to spare,
    then block_refine.refine_core.  A lane whose range leaves the blob
    reads as an empty segment, as in the kernel."""
    off = roff.to(torch.int64)
    n = len2.to(torch.int64)
    bad = (off < 0) | (n < 0) | (off + n > blob.shape[0])
    n = torch.where(bad, torch.zeros_like(n), n)
    nwords = (int(n.max()) * 8 + 31) // 32 + 3 if n.numel() else 3
    spp, mrp = raw_refine_to_dense(blob, off, n, nwords)
    return plain.refine_core(dec, spp, mrp, p, npasses, h_lim, causal,
                             width, height)


def refine_raw(dec, blob, roff, len2, p, npasses, h_lim, causal,
               width: int, height: int):
    """SigProp and MagRef of N same-shape codeblocks straight from the
    segment blob: lane i's refinement segment is blob[roff[i] : roff[i] +
    len2[i]] (uint8 blob; int32 roff, len2).  The other arguments and the
    result are :func:`refine`'s."""
    if blob.device.type == 'cpu':
        return refine_raw_plain(dec, blob, roff, len2, p, npasses, h_lim,
                                causal, width, height)
    if blob.device.type != 'cuda':
        raise RuntimeError(f'no HT refinement decoder for {blob.device}')
    if blob.dtype != torch.uint8:
        raise ValueError(f'blob must be uint8, got {blob.dtype}')
    sfx = _check_lanes(dec, width, height, roff=roff, len2=len2, p=p,
                       npasses=npasses, h_lim=h_lim, causal=causal)
    _check(blob.device, dec=dec, blob=blob, roff=roff, len2=len2, p=p,
           npasses=npasses, h_lim=h_lim, causal=causal)
    launch_raw(load(), PER_BLOCK, dec, blob, roff, len2, p, npasses, h_lim,
               causal, width, height)
    with _LOCK:
        LAUNCHES['ht_refine_decode_raw' + sfx] += 1
    return dec


def launch_raw(lib, per_block: int, dec, blob, roff, len2, p, npasses,
               h_lim, causal, width: int, height: int):
    """One launch of ``lib``'s raw entry of ``dec``'s width on checked
    CUDA tensors."""
    name = 'ht_refine_decode_raw' + ('64' if dec.dtype == torch.int64
                                     else '')
    dev = dec.device
    set_tables(lib, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            dec.data_ptr(), blob.data_ptr(), blob.shape[0], roff.data_ptr(),
            len2.data_ptr(), p.data_ptr(), npasses.data_ptr(),
            h_lim.data_ptr(), causal.data_ptr(), dec.shape[0], width, height,
            per_block, stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    return dec


def reset_launches():
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
