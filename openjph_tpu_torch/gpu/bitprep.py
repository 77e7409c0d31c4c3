"""Host-side bitstream preparation for the batched TPU block decoder.

The HT cleanup segment interleaves three byte-stuffed bitstreams (MEL,
VLC backward, MagSgn forward — ojph_block_decoder32.cpp:63-723).  Byte
unstuffing is a prefix-sum over byte values, so we strip it *outside*
the sequential decode: each stream becomes a dense bit sequence in
consumption order, packed LSB-first into uint32 words.  The TPU kernel
(block_decode.py) then reads them with pure (word-index, bit-count)
window state — no per-byte unstuff logic in the scan.

Dense-stream conventions (bit t of word j = consumption-order bit
32j+t):
 - MEL: bytes ``data[lcup-scup : lcup-1]`` MSB-first, last byte |= 0xF;
   after a 0xFF byte the next byte contributes 7 bits (its b7 is the
   stuffed 0).  Exhausted reads feed ones (fill=0xFF), so the tail is
   padded with 1-bits; out-of-range word gathers clamp onto an
   all-ones guard word.
 - VLC (backward): high nibble of ``data[lcup-2]`` LSB-first (3 bits
   only if (nibble&7)==7), then bytes ``data[lcup-3]`` downward,
   LSB-first, 7 bits when the previously-read byte was > 0x8F and this
   byte's low 7 bits are all ones.  Exhausted reads feed zeros.
 - MagSgn: bytes ``data[0 : lcup-scup]`` LSB-first, 7 bits after a
   0xFF byte; exhausted reads feed ones.

All routines are vectorized numpy over the whole batch.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BIT_IDX_MSB = np.arange(7, -1, -1, dtype=np.uint8)
_BIT_IDX_LSB = np.arange(8, dtype=np.uint8)


def _compact_bits(bits: np.ndarray, keep: np.ndarray,
                  fill_ones: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row stable compaction of ``bits`` where ``keep``; returns
    (dense [N, B] uint8, per-row dense lengths)."""
    n, b = bits.shape
    lens = keep.sum(axis=1).astype(np.int64)
    pos = np.cumsum(keep, axis=1, dtype=np.int64) - 1
    idx = np.where(keep, pos, b)  # dropped bits go to a dummy slot
    out = np.zeros((n, b + 1), dtype=np.uint8)
    np.put_along_axis(out, idx, np.where(keep, bits, 0), axis=1)
    out = out[:, :b]
    if fill_ones:
        out |= (np.arange(b, dtype=np.int64)[None, :] >= lens[:, None]) \
            .astype(np.uint8)
    return out, lens


def _pack_words(dense: np.ndarray, guard_ones: bool) -> np.ndarray:
    """Pack [N, B] bit arrays (LSB-first) into uint32 words, appending
    two guard words (all-ones or zeros) for clamped over-reads."""
    n, b = dense.shape
    pad = (-b) % 32
    if pad:
        fill = np.ones((n, pad), np.uint8) if guard_ones \
            else np.zeros((n, pad), np.uint8)
        dense = np.concatenate([dense, fill], axis=1)
    packed = np.packbits(dense, axis=1, bitorder='little')
    words = packed.view('<u4')
    guard = np.full((n, 2), 0xFFFFFFFF if guard_ones else 0,
                    dtype=np.uint32)
    return np.ascontiguousarray(
        np.concatenate([words, guard], axis=1))


def prep_cleanup_streams(datas: List[bytes], lcups: np.ndarray,
                         scups: np.ndarray, min_words=None):
    """Batch unstuffer: native C++ when available, numpy otherwise.

    min_words: optional (mel_w, vlc_w, ms_w) lower bounds for bucketed
    output widths (see native.prep_cleanup_streams)."""
    from .. import native
    if native.have_native():
        return native.prep_cleanup_streams(datas, lcups, scups,
                                           min_words=min_words)
    out = prep_cleanup_streams_np(datas, lcups, scups)
    if min_words is not None:
        for k, mw in zip(('mel', 'vlc', 'ms'), min_words):
            arr = out[k]
            if arr.shape[1] < mw:
                fill = 0xFFFFFFFF if k in ('mel', 'ms') else 0
                pad = np.full((arr.shape[0], mw - arr.shape[1]), fill,
                              dtype=np.uint32)
                out[k] = np.concatenate([arr, pad], axis=1)
    return out


def prep_cleanup_streams_np(datas: List[bytes], lcups: np.ndarray,
                            scups: np.ndarray):
    """Build the three dense streams for a batch of cleanup segments.

    Returns dict with 'mel', 'vlc', 'ms' uint32 word arrays [N, W_*].
    Caller validates 2 <= scup <= min(lcup, 4079) beforehand.
    """
    n = len(datas)
    lcups = np.asarray(lcups, dtype=np.int64)
    scups = np.asarray(scups, dtype=np.int64)
    max_len = max(1, int(lcups.max())) if n else 1
    buf = np.zeros((n, max_len), dtype=np.uint8)
    for i, d in enumerate(datas):
        arr = np.frombuffer(d, dtype=np.uint8)
        buf[i, :lcups[i]] = arr[:lcups[i]]

    cols = np.arange(max_len, dtype=np.int64)[None, :]

    # ---- MEL: bytes [lcup-scup, lcup-1), MSB-first ----------------------
    mel_start = (lcups - scups)[:, None]
    mel_len = (scups - 1)[:, None]
    mel_idx = np.minimum(mel_start + cols, max_len - 1)
    mel_bytes = np.take_along_axis(buf, mel_idx, axis=1)
    valid = cols < mel_len
    # last byte |= 0xF (the shared VLC/scup byte, dec_mel_st read_byte)
    mel_bytes = np.where(cols == mel_len - 1, mel_bytes | 0xF, mel_bytes)
    prev_ff = np.zeros_like(valid)
    prev_ff[:, 1:] = (mel_bytes[:, :-1] == 0xFF) & valid[:, :-1]
    bits = ((mel_bytes[:, :, None] >> _BIT_IDX_MSB[None, None, :]) & 1) \
        .astype(np.uint8)
    keep = np.repeat(valid[:, :, None], 8, axis=2)
    keep[:, :, 0] &= ~prev_ff  # drop stuffed b7
    dense, _ = _compact_bits(bits.reshape(n, -1), keep.reshape(n, -1),
                             fill_ones=True)
    mel_w = _pack_words(dense, guard_ones=True)

    # ---- VLC backward: nibble of data[lcup-2], then bytes downward ------
    nib_byte = buf[np.arange(n), np.maximum(lcups - 2, 0)]
    nib = (nib_byte >> 4).astype(np.uint8)
    nib_bits = ((nib[:, None] >> _BIT_IDX_LSB[None, :4]) & 1) \
        .astype(np.uint8)
    nib_keep = np.ones((n, 4), dtype=bool)
    special = (nib & 7) == 7
    nib_keep[:, 3] = ~special
    vlc_len = (scups - 2)[:, None]  # bytes below the nibble byte
    vlc_idx = np.maximum(lcups[:, None] - 3 - cols, 0)
    vlc_bytes = np.take_along_axis(buf, vlc_idx, axis=1)
    vvalid = cols < vlc_len
    # unstuff flag of the previously-read byte (higher address)
    prev_gt8f = np.zeros_like(vvalid)
    prev_gt8f[:, 0] = (nib_byte | 0xF) > 0x8F
    prev_gt8f[:, 1:] = vlc_bytes[:, :-1] > 0x8F
    drop = prev_gt8f & ((vlc_bytes & 0x7F) == 0x7F)
    bits = ((vlc_bytes[:, :, None] >> _BIT_IDX_LSB[None, None, :]) & 1) \
        .astype(np.uint8)
    keep = np.repeat(vvalid[:, :, None], 8, axis=2)
    keep[:, :, 7] &= ~drop  # drop stuffed b7
    # carry rule (rev_struct: tmp |= d << bits): a dropped bit — the
    # nibble's bit 3 when (nib&7)==7, or a stuffed byte's b7 — ORs
    # into the next byte's b0; a dangled bit after the LAST byte
    # stays visible before the zero fill.  Always 0 for conformant
    # encoders, but keeps corrupt input identical to the reference.
    bits[:, 0, 0] |= (special & vvalid[:, 0]) * ((nib >> 3) & 1)
    bits[:, 1:, 0] |= (drop[:, :-1] & vvalid[:, 1:]
                       ) * (vlc_bytes[:, :-1] >> 7).astype(np.uint8)
    lanes = np.arange(n)
    last = np.maximum(vlc_len[:, 0] - 1, 0)
    has_b = vlc_len[:, 0] > 0
    tail = np.where(has_b,
                    drop[lanes, last] & (vlc_bytes[lanes, last] >> 7)
                    .astype(bool),
                    special & ((nib >> 3) > 0))
    all_bits = np.concatenate([nib_bits, bits.reshape(n, -1),
                               tail.astype(np.uint8)[:, None]], axis=1)
    all_keep = np.concatenate([nib_keep, keep.reshape(n, -1),
                               tail[:, None]], axis=1)
    dense, _ = _compact_bits(all_bits, all_keep, fill_ones=False)
    vlc_w = _pack_words(dense, guard_ones=False)

    # ---- MagSgn forward: bytes [0, lcup-scup), LSB-first ----------------
    ms_len = (lcups - scups)[:, None]
    msvalid = cols < ms_len
    ms_bytes = np.where(msvalid, buf, 0)
    prev_ff = np.zeros_like(msvalid)
    prev_ff[:, 1:] = (ms_bytes[:, :-1] == 0xFF) & msvalid[:, :-1]
    bits = ((ms_bytes[:, :, None] >> _BIT_IDX_LSB[None, None, :]) & 1) \
        .astype(np.uint8)
    # stuffed-byte carry (frwd_struct32): dropped b7 ORs into the
    # next byte's b0; the ones fill absorbs a dangling tail carry
    bits[:, 1:, 0] |= (prev_ff[:, :-1] & msvalid[:, 1:]
                       ) * (ms_bytes[:, :-1] >> 7).astype(np.uint8)
    keep = np.repeat(msvalid[:, :, None], 8, axis=2)
    keep[:, :, 7] &= ~prev_ff
    dense, _ = _compact_bits(bits.reshape(n, -1), keep.reshape(n, -1),
                             fill_ones=True)
    ms_w = _pack_words(dense, guard_ones=True)

    return {'mel': mel_w, 'vlc': vlc_w, 'ms': ms_w}
