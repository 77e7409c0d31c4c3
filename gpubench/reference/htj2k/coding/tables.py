"""HTJ2K CxtVLC / UVLC / MEL code tables.

The raw CxtVLC rows (context, rho, u_off, e_k, e_1, cwd, cwd_len) are
normative data from ITU-T T.814 Annex C, stored in
``data/vlc_tables.npz`` (see tools/extract_vlc_tables.py for
provenance).  From those rows we derive:

 - encoder tables: (c_q<<8 | rho<<4 | eps) -> (cwd<<8 | cwd_len<<4 | e_k)
   (reference derivation: ojph_block_encoder.cpp:76-193)
 - decoder tables: (c_q<<7 | next-7-bits) ->
   (e_k<<12 | e_1<<8 | rho<<4 | u_off<<3 | cwd_len)
   (reference derivation: ojph_block_common.cpp:124-190)
 - UVLC prefix/suffix tables for both directions
   (ojph_block_encoder.cpp:196-255, ojph_block_common.cpp:196-337)
"""
import os
from functools import lru_cache

import numpy as np

MEL_E = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5], dtype=np.int32)

_DATA = os.path.join(os.path.dirname(__file__), 'data', 'vlc_tables.npz')


@lru_cache(maxsize=None)
def _raw_tables():
    z = np.load(_DATA)
    return z['table0'].astype(np.int64), z['table1'].astype(np.int64)


def _build_enc(tbl: np.ndarray) -> np.ndarray:
    """Encoder VLC table, 2048 entries."""
    out = np.zeros(2048, dtype=np.uint16)
    popcnt = [bin(i).count('1') for i in range(16)]
    by_key = {}
    for row in tbl:
        c_q, rho, u_off, e_k, e_1, cwd, cwd_len = (int(v) for v in row)
        by_key.setdefault((c_q, rho, u_off), []).append(
            (e_k, e_1, cwd, cwd_len))
    for i in range(2048):
        c_q, rho, emb = i >> 8, (i >> 4) & 0xF, i & 0xF
        if (emb & rho) != emb or (rho == 0 and c_q == 0):
            continue
        if emb:
            best, best_cnt = None, -1
            for e_k, e_1, cwd, cwd_len in by_key.get((c_q, rho, 1), ()):
                if (emb & e_k) == e_1:
                    if popcnt[e_k] >= best_cnt:
                        best = (cwd, cwd_len, e_k)
                        best_cnt = popcnt[e_k]
        else:
            entries = by_key.get((c_q, rho, 0), ())
            best = (entries[0][2], entries[0][3], entries[0][0]) \
                if entries else None
        assert best is not None
        out[i] = (best[0] << 8) | (best[1] << 4) | best[2]
    return out


def _build_dec(tbl: np.ndarray) -> np.ndarray:
    """Decoder VLC table, 1024 entries: entry i = (c_q << 7) | cwd from
    the last row of context c_q whose codeword is cwd's low cwd_len
    bits (0 where none is)."""
    tc_q, rho, u_off, e_k, e_1, tcwd, cwd_len = (
        tbl[:, k].astype(np.int64) for k in range(7))
    i = np.arange(1024, dtype=np.int64)[:, None]
    match = (tc_q[None, :] == (i >> 7)) \
        & (tcwd[None, :] == ((i & 0x7F) & ((1 << cwd_len[None, :]) - 1)))
    last = match.shape[1] - 1 - np.argmax(match[:, ::-1], axis=1)
    val = (rho << 4) | (u_off << 3) | (e_k << 12) | (e_1 << 8) | cwd_len
    return np.where(match.any(axis=1), val[last], 0).astype(np.uint16)


# UVLC prefix decode helper (ojph_block_common.cpp:204-213):
# index = 3 LSBs of the VLC word; entry = prefix_len | suffix_len<<2
# | u_pfx<<5
_UVLC_DEC = np.array([
    3 | (5 << 2) | (5 << 5),
    1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5),
    3 | (1 << 2) | (3 << 5),
    1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5)], dtype=np.uint32)


def _build_uvlc_dec0():
    """uvlc_tbl0[320] + uvlc_bias[320] for initial quad rows."""
    tbl = np.zeros(320, dtype=np.uint16)
    bias = np.zeros(320, dtype=np.uint8)
    for i in range(320):
        mode, vlc = i >> 6, i & 0x3F
        if mode == 0:
            continue
        if mode <= 2:
            d = int(_UVLC_DEC[vlc & 7])
            tp, ts = d & 3, (d >> 2) & 7
            u0_len = ts if mode == 1 else 0
            u0 = (d >> 5) if mode == 1 else 0
            u1 = 0 if mode == 1 else (d >> 5)
            tbl[i] = tp | (ts << 3) | (u0_len << 7) | (u0 << 10) | (u1 << 13)
        elif mode == 3:
            d0 = int(_UVLC_DEC[vlc & 7])
            vlc2 = vlc >> (d0 & 3)
            d1 = int(_UVLC_DEC[vlc2 & 7])
            if (d0 & 3) == 3:
                tp = (d0 & 3) + 1
                u0_len = (d0 >> 2) & 7
                ts = u0_len
                u0 = d0 >> 5
                u1 = (vlc2 & 1) + 1
                bias[i] = 4
            else:
                tp = (d0 & 3) + (d1 & 3)
                u0_len = (d0 >> 2) & 7
                ts = u0_len + ((d1 >> 2) & 7)
                u0 = d0 >> 5
                u1 = d1 >> 5
            tbl[i] = tp | (ts << 3) | (u0_len << 7) | (u0 << 10) | (u1 << 13)
        else:  # mode 4: both u_off = 1, MEL event = 1
            d0 = int(_UVLC_DEC[vlc & 7])
            vlc2 = vlc >> (d0 & 3)
            d1 = int(_UVLC_DEC[vlc2 & 7])
            tp = (d0 & 3) + (d1 & 3)
            u0_len = (d0 >> 2) & 7
            ts = u0_len + ((d1 >> 2) & 7)
            u0 = (d0 >> 5) + 2
            u1 = (d1 >> 5) + 2
            tbl[i] = tp | (ts << 3) | (u0_len << 7) | (u0 << 10) | (u1 << 13)
            bias[i] = 10
    return tbl, bias


def _build_uvlc_dec1():
    """uvlc_tbl1[256] for non-initial quad rows."""
    tbl = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        mode, vlc = i >> 6, i & 0x3F
        if mode == 0:
            continue
        if mode <= 2:
            d = int(_UVLC_DEC[vlc & 7])
            tp, ts = d & 3, (d >> 2) & 7
            u0_len = ts if mode == 1 else 0
            u0 = (d >> 5) if mode == 1 else 0
            u1 = 0 if mode == 1 else (d >> 5)
            tbl[i] = tp | (ts << 3) | (u0_len << 7) | (u0 << 10) | (u1 << 13)
        else:
            d0 = int(_UVLC_DEC[vlc & 7])
            vlc2 = vlc >> (d0 & 3)
            d1 = int(_UVLC_DEC[vlc2 & 7])
            tp = (d0 & 3) + (d1 & 3)
            u0_len = (d0 >> 2) & 7
            ts = u0_len + ((d1 >> 2) & 7)
            u0 = d0 >> 5
            u1 = d1 >> 5
            tbl[i] = tp | (ts << 3) | (u0_len << 7) | (u0 << 10) | (u1 << 13)
    return tbl


def _build_uvlc_enc():
    """Encoder UVLC table, 75 entries of
    (pre, pre_len, suf, suf_len, ext, ext_len)
    (ojph_block_encoder.cpp:196-255)."""
    t = np.zeros((75, 6), dtype=np.uint8)
    t[0] = (0, 0, 0, 0, 0, 0)
    t[1] = (1, 1, 0, 0, 0, 0)
    t[2] = (2, 2, 0, 0, 0, 0)
    t[3] = (4, 3, 0, 1, 0, 0)
    t[4] = (4, 3, 1, 1, 0, 0)
    for i in range(5, 33):
        t[i] = (0, 3, i - 5, 5, 0, 0)
    for i in range(33, 75):
        t[i] = (0, 3, 28 + (i - 33) % 4, 5, (i - 33) // 4, 4)
    return t


@lru_cache(maxsize=None)
def get_tables():
    """All derived tables as a dict of numpy arrays."""
    t0, t1 = _raw_tables()
    uvlc0, bias0 = _build_uvlc_dec0()
    return {
        'enc_vlc0': _build_enc(t0),
        'enc_vlc1': _build_enc(t1),
        'dec_vlc0': _build_dec(t0),
        'dec_vlc1': _build_dec(t1),
        'dec_uvlc0': uvlc0,
        'dec_uvlc0_bias': bias0,
        'dec_uvlc1': _build_uvlc_dec1(),
        'enc_uvlc': _build_uvlc_enc(),
    }
