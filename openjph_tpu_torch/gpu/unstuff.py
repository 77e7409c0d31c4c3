"""Plain reader of the raw-bytes decode mode: each lane's stuffed
cleanup bytes, read straight from the packed segment blob, become the
dense MEL / VLC / MagSgn word rows that the plain block decoder takes.

The rules are the reference's readers (dec_mel_st / rev_struct /
frwd_struct32, ojph_block_decoder32.cpp:63-723), as the JAX package
states them in tpu/unstuff.py and bitprep.py, applied byte by byte:

- MagSgn reads ``ms_n`` bytes forward from ``lane_off``, LSB-first; a
  byte after 0xFF loses its bit 7, which ORs into the next byte's
  bit 0; past the end it reads 0xFF.
- MEL reads ``sh_n`` bytes forward from ``lane_off + ms_n``, MSB-first;
  a byte after 0xFF loses its first (most significant) bit; past the
  end it reads 0xFF.  The packer has already OR'd 0xF into the last
  shared byte.
- VLC reads the same ``sh_n`` bytes backward from the last one: that
  first byte gives its high nibble (3 bits when the nibble's low three
  bits are all ones), later bytes 8 bits, or 7 when the byte read
  before was above 0x8F and this byte's low 7 bits are all ones.  A
  dropped bit ORs into the next byte's bit 0, and on the last byte it
  stays.  Past the end it reads 0.

The refinement segment of a multi-pass codeblock (``len2`` bytes from
``roff``; tpu/unstuff.py::unstuff_spp / unstuff_mrp) has two readers:

- SigProp reads it forward as MagSgn does, but past the end it reads 0.
- MagRef reads it backward from the last byte, LSB-first; a byte loses
  its bit 7 when the byte read before it was above 0x8F (the first byte
  read counts as following such a byte) and its low 7 bits are all
  ones.  The dropped bit ORs into the next byte's bit 0, and on the last
  byte it stays.  Past the end it reads 0.

A byte's payload depends only on it and the two bytes before it.  This
module applies the rules to whole lanes at once with tensor ops
(per-byte payloads, an exclusive prefix sum of payload lengths, one
scatter of the kept bits); the CUDA kernels do the same 128 bytes at a
time across a warp.
"""
from __future__ import annotations

import torch

_MS, _MEL, _VLC, _SPP, _MRP = 0, 1, 2, 3, 4


def _bitrev8(b):
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4)
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2)
    return ((b & 0xAA) >> 1) | ((b & 0x55) << 1)


def _payloads(blob, start, n, nbytes: int, kind: int):
    """Per-byte (payload, bit count) [N, nbytes] of one stream kind."""
    dev = blob.device
    j = torch.arange(nbytes, dtype=torch.int64, device=dev)[None, :]
    valid = j < n[:, None]
    backward = kind in (_VLC, _MRP)
    addr = start[:, None] - j if backward else start[:, None] + j
    raw = blob[addr.clamp(0, blob.shape[0] - 1)].to(torch.int64)
    fill = 0xFF if kind in (_MS, _MEL) else 0
    b = torch.where(valid, raw, torch.full_like(raw, fill))
    prev = torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)
    eight = torch.full_like(b, 8)
    if kind == _MEL:
        stuffed = valid & (j > 0) & (prev == 0xFF)
        r = _bitrev8(b)
        return (torch.where(stuffed, r >> 1, r),
                torch.where(stuffed, eight - 1, eight))
    if kind in (_MS, _SPP):
        stuffed = valid & (j > 0) & (prev == 0xFF)
        fl = torch.cat([torch.zeros_like(stuffed[:, :1]),
                        stuffed[:, :-1]], dim=1)
        v = b | torch.where(valid & fl, (prev >> 7) & 1,
                            torch.zeros_like(b))
        return (torch.where(stuffed, v & 0x7F, v),
                torch.where(stuffed, eight - 1, eight))
    first = j == 0
    last = j == (n[:, None] - 1)
    if kind == _MRP:
        drop = valid & (first | (prev > 0x8F)) & ((b & 0x7F) == 0x7F)
        fl = torch.cat([torch.zeros_like(drop[:, :1]), drop[:, :-1]], dim=1)
        v = b | torch.where(valid & fl, (prev >> 7) & 1, torch.zeros_like(b))
        cut = drop & ~last
        return (torch.where(cut, v & 0x7F, v),
                torch.where(cut, eight - 1, eight))
    nib3 = ((b >> 4) & 7) == 7
    drop = ~first & valid & (prev > 0x8F) & ((b & 0x7F) == 0x7F)
    dang = torch.where(first, nib3, drop) & valid
    fl = torch.cat([torch.zeros_like(dang[:, :1]), dang[:, :-1]], dim=1)
    v = b | torch.where(valid & fl, (prev >> 7) & 1, torch.zeros_like(b))
    cut = ~last & valid
    v_first = torch.where(nib3 & cut, (v >> 4) & 7, v >> 4)
    c_first = torch.where(nib3 & cut, eight - 5, eight - 4)
    v_rest = torch.where(drop & cut, v & 0x7F, v)
    c_rest = torch.where(drop & cut, eight - 1, eight)
    v = torch.where(first & valid, v_first, v_rest)
    c = torch.where(first & valid, c_first, c_rest)
    return v, c


def _assemble(vals, cnts, nwords: int):
    """Concatenate each lane's per-byte payloads LSB-first into
    ``nwords`` uint32 words (int64 [N, nwords])."""
    n, nb = vals.shape
    dev = vals.device
    nbits = nwords * 32
    t = torch.arange(8, dtype=torch.int64, device=dev)
    pos0 = torch.cumsum(cnts, dim=1) - cnts
    pos = pos0[:, :, None] + t
    keep = (t < cnts[:, :, None]) & (pos < nbits)
    bits = (vals[:, :, None] >> t) & 1
    out = torch.zeros((n, nbits + 1), dtype=torch.int64, device=dev)
    idx = torch.where(keep, pos, torch.full_like(pos, nbits))
    out.scatter_(1, idx.reshape(n, -1), bits.reshape(n, -1))
    w = out[:, :nbits].reshape(n, nwords, 32)
    return (w << torch.arange(32, dtype=torch.int64, device=dev)).sum(-1)


def raw_to_dense(blob, lane_off, ms_n, sh_n, words):
    """blob: uint8 [B] segment blob; lane_off / ms_n / sh_n [N] int;
    words = (wm, wv, ws).  Returns dense (mel [N, wm], vlc [N, wv],
    ms [N, ws]) int64 rows holding uint32 words, with the guard fill
    (ones for MEL/MagSgn, zeros for VLC) past each stream's payload."""
    wm, wv, ws = words
    off = lane_off.to(torch.int64)
    msn = ms_n.to(torch.int64)
    shn = sh_n.to(torch.int64)
    ms = _stream(blob, off, msn, ws, _MS)
    mel = _stream(blob, off + msn, shn, wm, _MEL)
    vlc = _stream(blob, off + msn + shn - 1, shn, wv, _VLC)
    return mel, vlc, ms


def _stream(blob, start, n, nw: int, kind: int):
    # enough bytes to cover nw words even when every byte loses a bit
    # (and the VLC nibble byte five)
    nbytes = -(-(nw * 32 + 8) // 7) + 1
    v, c = _payloads(blob, start, n, nbytes, kind)
    return _assemble(v, c, nw)


def raw_refine_to_dense(blob, roff, len2, nwords: int):
    """blob: uint8 [B] segment blob; roff / len2 [N] int: each lane's
    refinement segment.  Returns dense (spp [N, nwords], mrp [N, nwords])
    int64 rows holding uint32 words, zero past each stream's payload."""
    off = roff.to(torch.int64)
    n = len2.to(torch.int64)
    return (_stream(blob, off, n, nwords, _SPP),
            _stream(blob, off + n - 1, n, nwords, _MRP))
