"""HT (High-Throughput JPEG 2000) block decoder — reference
implementation in Python/NumPy.

Decodes one codeblock's Cleanup (MEL + VLC + UVLC + MagSgn), SigProp,
and MagRef passes into a sign-magnitude sample array, bit-exact with
ojph_decode_codeblock32 (OpenJPH src/core/coding/
ojph_block_decoder32.cpp:742-1614).  This scalar path is the oracle for
the batched/vectorized TPU kernels in this package.
"""
from __future__ import annotations

import numpy as np

from .tables import MEL_E, get_tables


class MelDecoder:
    """MEL adaptive run-length decoder (dec_mel_st,
    ojph_block_decoder32.cpp:63-269)."""

    def __init__(self, data, lcup: int, scup: int):
        self.buf = data
        self.pos = lcup - scup
        self.size = scup - 1
        self.tmp = 0
        self.bits = 0
        self.unstuff = False
        self.k = 0

    def _read_byte(self):
        if self.size > 0:
            d = int(self.buf[self.pos])
            if self.size == 1:
                d |= 0xF  # last byte shared with VLC: set LSBs
            self.pos += 1
            self.size -= 1
        else:
            d = 0xFF
        d_bits = 8 - (1 if self.unstuff else 0)
        self.tmp = (self.tmp << d_bits) | d  # (stuffed MSB is 0; fed 0xFF ORs)
        self.bits += d_bits
        self.unstuff = (d == 0xFF)

    def _read_bit(self) -> int:
        if self.bits == 0:
            self._read_byte()
        self.bits -= 1
        return (self.tmp >> self.bits) & 1

    def get_run(self) -> int:
        """Decode one MEL codeword into a run value: LSB=1 means the run
        of zeros terminates with a one event; upper bits = zeros*2."""
        eval_ = int(MEL_E[self.k])
        if self._read_bit():
            run = ((1 << eval_) - 1) << 1
            self.k = min(12, self.k + 1)
        else:
            v = 0
            for _ in range(eval_):
                v = (v << 1) | self._read_bit()
            run = (v << 1) + 1
            self.k = max(0, self.k - 1)
        return run


class RevReader:
    """Backward-growing bitstream reader with >0x8F/0x7F unstuffing
    (rev_struct for VLC, ojph_block_decoder32.cpp:275-439)."""

    def __init__(self, data, lcup: int, scup: int):
        self.buf = data
        self.pos = lcup - 2
        d = int(self.buf[self.pos])
        self.pos -= 1
        self.tmp = d >> 4
        self.bits = 4 - (1 if (self.tmp & 7) == 7 else 0)
        self.unstuff = (d | 0xF) > 0x8F
        self.size = scup - 2

    def _read_byte(self):
        if self.size > 0:
            d = int(self.buf[self.pos])
            self.pos -= 1
            self.size -= 1
        else:
            d = 0
        d_bits = 8 - (1 if (self.unstuff and (d & 0x7F) == 0x7F) else 0)
        self.tmp |= d << self.bits
        self.bits += d_bits
        self.unstuff = d > 0x8F

    def fetch(self) -> int:
        while self.bits < 32:
            self._read_byte()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int):
        self.tmp >>= n
        self.bits -= n


class RevMrpReader(RevReader):
    """Backward reader for the MagRef segment (rev_init_mrp,
    ojph_block_decoder32.cpp:517-575)."""

    def __init__(self, data, lcup: int, len2: int):  # noqa: N803
        self.buf = data
        self.pos = lcup + len2 - 1
        self.size = len2
        self.unstuff = True
        self.bits = 0
        self.tmp = 0


class FwdReader:
    """Forward-growing bitstream reader with 0xFF unstuffing
    (frwd_struct32, ojph_block_decoder32.cpp:581-723).  ``fill`` is the
    value fed when the stream is exhausted (0xFF for MagSgn, 0 for
    SigProp)."""

    def __init__(self, data, pos: int, size: int, fill: int):
        self.buf = data
        self.pos = pos
        self.size = size
        self.fill = fill
        self.tmp = 0
        self.bits = 0
        self.unstuff = 0

    def _read_byte(self):
        if self.size > 0:
            d = int(self.buf[self.pos])
            self.pos += 1
        else:
            d = self.fill
        self.size -= 1
        self.tmp |= d << self.bits
        self.bits += 8 - self.unstuff
        self.unstuff = 1 if d == 0xFF else 0

    def fetch(self, n: int = 32) -> int:
        while self.bits < n:
            self._read_byte()
        return self.tmp & ((1 << n) - 1)

    def advance(self, n: int):
        self.tmp >>= n
        self.bits -= n


def decode_codeblock(coded_data: bytes, missing_msbs: int, num_passes: int,
                     lengths1: int, lengths2: int, width: int, height: int,
                     stripe_causal: bool = False) -> np.ndarray:
    """Decode one HT codeblock to a [height, width] uint32 sign-magnitude
    array (sign in bit 31, magnitude scaled so coded bitplanes end at
    bit p = 30 - missing_msbs).

    Dispatches to the C++ port (native.decode_codeblock — the host
    path for >30-bit-plane blocks and per-block fallbacks runs at
    oracle-class speed there) and falls back to the pure-Python
    reference below; tests/test_native_guards.py pins the two
    bit-identical."""
    if len(coded_data) < lengths1 + (lengths2 if num_passes > 1
                                     else 0):
        # truncated coded bytes (reference: zeroed block under
        # resilience, ojph_precinct.cpp:558-568; strict raises the
        # wrong-codeblock-length error) — checked HERE so the C++
        # port never reads past the caller's buffer
        raise ValueError('ojph error 0x00080002: wrong codeblock '
                         'length')
    from .. import native
    out = native.decode_codeblock(coded_data, missing_msbs, num_passes,
                                  lengths1, lengths2, width, height,
                                  stripe_causal) \
        if native.have_native() else None
    if out is not None:
        return out
    return decode_codeblock_py(coded_data, missing_msbs, num_passes,
                               lengths1, lengths2, width, height,
                               stripe_causal)


def decode_codeblock_py(coded_data: bytes, missing_msbs: int,
                        num_passes: int, lengths1: int, lengths2: int,
                        width: int, height: int,
                        stripe_causal: bool = False) -> np.ndarray:
    """Pure-Python reference decode (see decode_codeblock)."""
    t = get_tables()
    vlc_tbl0, vlc_tbl1 = t['dec_vlc0'], t['dec_vlc1']
    uvlc_tbl0, uvlc_tbl1 = t['dec_uvlc0'], t['dec_uvlc1']
    uvlc_bias0 = t['dec_uvlc0_bias']

    if num_passes > 1 and lengths2 == 0:
        num_passes = 1
    if num_passes > 3:
        raise ValueError('more than 3 coding passes not supported')
    # 64-bit sample path (ojph_decode_codeblock64) for >30 bit planes
    B = 32 if missing_msbs < 30 else 64
    if missing_msbs >= 62:
        raise ValueError('64 bits insufficient for this codeblock')
    if missing_msbs == (29 if B == 32 else 61):
        num_passes = 1
    p = (30 if B == 32 else 62) - missing_msbs
    SIGN = B - 1
    MASK = (1 << B) - 1
    if lengths1 < 2:
        raise ValueError('wrong codeblock length')

    data = np.frombuffer(coded_data, dtype=np.uint8).astype(np.int64)
    lcup = lengths1
    scup = (int(data[lcup - 1]) << 4) + (int(data[lcup - 2]) & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise ValueError('invalid scup')

    qw = (width + 1) >> 1   # quads per row
    qh = (height + 1) >> 1  # quad rows
    # two extra zero columns: the reference scratch rows are zero-padded
    # so contexts read past the row end see zeros
    inf = np.zeros((qh, qw + 3), dtype=np.uint32)  # VLC entries per quad
    u_q_arr = np.zeros((qh, qw + 1), dtype=np.uint32)
    dec = np.zeros((qh * 2, width),
                   dtype=np.uint32 if B == 32 else np.uint64)

    mmsbp2 = missing_msbs + 2

    # ---- step 1: MEL + VLC + UVLC -> per-quad records -------------------
    # mirrors ojph_block_decoder32.cpp:855-1088
    mel = MelDecoder(data, lcup, scup)
    vlc = RevReader(data, lcup, scup)
    run = mel.get_run()

    for qy in range(qh):
        c_q = 0
        initial = (qy == 0)
        vtbl = vlc_tbl0 if initial else vlc_tbl1
        above = inf[qy - 1] if qy > 0 else None
        for qx2 in range(0, qw, 2):
            # ---- first quad of the pair (index qx2) ----
            if not initial:
                c_q |= (int(above[qx2]) & 0xA0) << 2
                c_q |= (int(above[qx2 + 1]) & 0x20) << 4
            vlc_val = vlc.fetch()
            t0 = int(vtbl[c_q + (vlc_val & 0x7F)])
            if c_q == 0:
                run -= 2
                t0 = t0 if run == -1 else 0
                if run < 0:
                    run = mel.get_run()
            inf[qy, qx2] = t0
            if initial:
                c_q = ((t0 & 0x10) << 3) | ((t0 & 0xE0) << 2)
            else:
                c_q = ((t0 & 0x40) << 2) | ((t0 & 0x80) << 1)
                c_q |= int(above[qx2]) & 0x80
                c_q |= (int(above[qx2 + 1]) & 0xA0) << 2
                c_q |= (int(above[qx2 + 2]) & 0x20) << 4
            vlc.advance(t0 & 0x7)

            # ---- second quad of the pair (index qx2 + 1) ----
            second_exists = (qx2 + 1) < qw
            t1 = int(vtbl[c_q + (vlc.fetch() & 0x7F)])
            if c_q == 0 and second_exists:
                run -= 2
                t1 = t1 if run == -1 else 0
                if run < 0:
                    run = mel.get_run()
            t1 = t1 if second_exists else 0
            inf[qy, qx2 + 1] = t1
            if initial:
                c_q = ((t1 & 0x10) << 3) | ((t1 & 0xE0) << 2)
            else:
                c_q = ((t1 & 0x40) << 2) | ((t1 & 0x80) << 1)
                c_q |= int(above[qx2 + 1]) & 0x80
            vlc.advance(t1 & 0x7)

            # ---- decode u for the quad pair ----
            uvlc_mode = ((t0 & 0x8) << 3) | ((t1 & 0x8) << 4)
            if initial:
                if uvlc_mode == 0xC0:
                    run -= 2
                    uvlc_mode += 0x40 if run == -1 else 0
                    if run < 0:
                        run = mel.get_run()
                u_idx = uvlc_mode + (vlc.fetch() & 0x3F)
                uvlc_entry = int(uvlc_tbl0[u_idx])
                u_bias = int(uvlc_bias0[u_idx])
            else:
                uvlc_entry = int(uvlc_tbl1[uvlc_mode + (vlc.fetch() & 0x3F)])
                u_bias = 0
            vlc.advance(uvlc_entry & 0x7)
            uvlc_entry >>= 3
            length = uvlc_entry & 0xF  # total suffix length
            tmp = vlc.fetch() & ((1 << length) - 1)
            vlc.advance(length)
            uvlc_entry >>= 4
            len0 = uvlc_entry & 0x7  # quad-0 suffix length
            uvlc_entry >>= 3
            kappa = 1 if initial else 0
            u0 = kappa + (uvlc_entry & 7) \
                + (tmp & (~(0xFF << len0) & 0xFFFFFFFF))
            u1 = kappa + (uvlc_entry >> 3) + (tmp >> len0)
            if B == 64:
                # u_q extension for >32 (ojph_block_decoder64.cpp:
                # 1000-1010, 1122-1132)
                if (u0 - kappa) - (u_bias & 0x3) > 32:
                    u0 += (vlc.fetch() & 0xF) << 2
                    vlc.advance(4)
                if (u1 - kappa) - (u_bias >> 2) > 32:
                    u1 += (vlc.fetch() & 0xF) << 2
                    vlc.advance(4)
            u_q_arr[qy, qx2] = u0
            if second_exists:
                u_q_arr[qy, qx2 + 1] = u1

    # ---- step 2: MagSgn -> sample values --------------------------------
    magsgn = FwdReader(data, 0, lcup - scup, 0xFF)
    v_n_scratch = np.zeros(qw + 2, dtype=np.uint64 if B == 64 else np.uint32)

    for qy in range(qh):
        initial = (qy == 0)
        prev_v_n = 0
        new_v = np.zeros(qw + 2, dtype=np.uint64 if B == 64 else np.uint32)
        for qx in range(qw):
            q_inf = int(inf[qy, qx])
            u_q = int(u_q_arr[qy, qx])
            if initial:
                U_q = u_q
            else:
                gamma = q_inf & 0xF0
                gamma &= gamma - 0x10
                emax_v = int(v_n_scratch[qx]) | int(v_n_scratch[qx + 1])
                emax = (emax_v | 2).bit_length() - 1  # emax - 1
                kappa = emax if gamma else 1
                U_q = u_q + kappa
            if U_q > mmsbp2:
                raise ValueError('U_q exceeds missing_msbs + 2')

            x0 = qx * 2
            y0 = qy * 2
            ncols = 2 if x0 + 1 < width else 1
            for bit in range(2 * ncols):
                col, row = bit >> 1, bit & 1
                x, y = x0 + col, y0 + row
                val = 0
                v_n = 0
                if q_inf & (1 << (4 + bit)):
                    ms_val = magsgn.fetch(B)
                    m_n = U_q - ((q_inf >> (12 + bit)) & 1)
                    magsgn.advance(m_n)
                    val = (ms_val << SIGN) & MASK
                    v_n = ms_val & ((1 << m_n) - 1)
                    v_n |= ((q_inf >> (8 + bit)) & 1) << m_n
                    v_n |= 1
                    val |= (v_n + 2) << (p - 1)
                    val &= MASK
                dec[y, x] = dec.dtype.type(val)
                if row == 1:
                    if col == 0:
                        new_v[qx] = prev_v_n | v_n
                        prev_v_n = 0
                    else:
                        prev_v_n = v_n
        new_v[qw] = prev_v_n
        v_n_scratch = new_v

    dec = dec[:height, :]

    if num_passes > 1:
        _decode_spp_mrp(data, dec, p, num_passes, lengths1, lengths2,
                        width, height,
                        _sig_from_inf(inf, width, height),
                        stripe_causal,
                        sign_bit=SIGN)
    return dec


def _sig_from_inf(inf: np.ndarray, width: int, height: int) -> np.ndarray:
    """Column-significance array: sig[sy, gx] packs 4x4 groups, 4 bits per
    column (bit k of nibble j = sample (4sy+k, 4gx+j)); mirrors the
    re-arrangement at ojph_block_decoder32.cpp:1333-1356."""
    qh = (height + 1) >> 1
    qw = (width + 1) >> 1
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2
    sig = np.zeros((n_sy + 1, n_gx + 1), dtype=np.uint32)
    for sy in range(n_sy):
        for gx in range(n_gx):
            t = 0
            for half in range(2):  # two quad rows per 4-row stripe
                qy = sy * 2 + half
                if qy >= qh:
                    continue
                for qxo in range(2):  # two quads per 4-col group
                    qx = gx * 2 + qxo
                    if qx >= qw:
                        continue
                    rho = (int(inf[qy, qx]) >> 4) & 0xF
                    # rho bits: 0=TL,1=BL,2=TR,3=BR (col-major within quad)
                    for b in range(4):
                        if rho & (1 << b):
                            col = qxo * 2 + (b >> 1)
                            row = half * 2 + (b & 1)
                            t |= 1 << (col * 4 + row)
            sig[sy, gx] = t
    return sig


def _sig_from_dec(dec: np.ndarray, width: int, height: int) -> np.ndarray:
    """Column-significance array derived from decoded cleanup samples
    (a cleanup-significant sample always has nonzero magnitude, so
    sig == (dec != 0)); same layout as _sig_from_inf.  Lets batch
    decoders run SPP/MRP without re-deriving per-quad rho info."""
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2
    pb = np.zeros((n_sy * 4, n_gx * 4), dtype=bool)
    pb[:dec.shape[0], :dec.shape[1]] = dec != 0
    yy, xx = np.mgrid[0:n_sy * 4, 0:n_gx * 4]
    wgt = (np.uint32(1) << ((xx % 4) * 4 + (yy % 4)).astype(np.uint32))
    contr = np.where(pb, wgt, np.uint32(0))
    sig = np.zeros((n_sy + 1, n_gx + 1), dtype=np.uint32)
    sig[:n_sy, :n_gx] = contr.reshape(n_sy, 4, n_gx, 4) \
        .sum(axis=(1, 3), dtype=np.uint32)
    return sig


def _decode_spp_mrp(data, dec, p, num_passes, lengths1, lengths2,
                    width, height, sig, stripe_causal, sign_bit=31):
    """SigProp + MagRef passes (ojph_block_decoder32.cpp:1318-1611).
    ``sig`` is the column-significance array (_sig_from_inf /
    _sig_from_dec)."""
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2

    # ---- Significance Propagation Pass ----------------------------------
    sigprop = FwdReader(data, lengths1, lengths2, 0)
    prev_row_sig = np.zeros(n_gx + 1, dtype=np.uint32)

    for sy in range(n_sy):
        y = sy * 4
        pattern0 = 0xFFFF
        if height - y < 4:
            pattern0 = 0x7777
            if height - y < 3:
                pattern0 = 0x3333
                if height - y < 2:
                    pattern0 = 0x1111
        prev = 0
        pattern = pattern0
        for gx in range(n_gx):
            x = gx * 4
            s = max(x + 4 - width, 0)
            pattern = pattern >> (s * 4)

            ps = int(prev_row_sig[gx]) | (int(prev_row_sig[gx + 1]) << 16)
            ns = int(sig[sy + 1, gx]) | (int(sig[sy + 1, gx + 1]) << 16)
            u = (ps & 0x88888888) >> 3
            if not stripe_causal:
                u |= (ns & 0x11111111) << 3
            cs = int(sig[sy, gx]) | (int(sig[sy, gx + 1]) << 16)
            mbr = cs
            mbr |= (cs & 0x77777777) << 1
            mbr |= (cs & 0xEEEEEEEE) >> 1
            mbr |= u
            tt = mbr
            mbr |= tt << 4
            mbr |= tt >> 4
            mbr |= prev >> 12
            mbr &= pattern
            mbr &= ~cs & 0xFFFFFFFF

            new_sig = mbr
            if new_sig:
                cwd = sigprop.fetch()
                cnt = 0
                col_mask = 0xF
                inv_sig = ~cs & pattern & 0xFFFFFFFF
                spread = (0x33, 0x76, 0xEC, 0xC8)
                for i in range(0, 16, 4):
                    if (col_mask & new_sig) == 0:
                        col_mask <<= 4
                        continue
                    sample_mask = 0x1111 & col_mask
                    for k in range(4):
                        if new_sig & sample_mask:
                            new_sig &= ~sample_mask & 0xFFFFFFFF
                            if cwd & 1:
                                new_sig |= (spread[k] << i) & inv_sig
                            cwd >>= 1
                            cnt += 1
                        sample_mask <<= 1
                    col_mask <<= 4
                if new_sig:
                    val = 3 << (p - 2)
                    col_mask = 0xF
                    for i in range(4):
                        if (col_mask & new_sig) == 0:
                            col_mask <<= 4
                            continue
                        sample_mask = 0x1111 & col_mask
                        for k in range(4):
                            if new_sig & sample_mask:
                                dec[y + k, x + i] = \
                                    dec.dtype.type(((cwd & 1) << sign_bit)
                                                   | val)
                                cwd >>= 1
                                cnt += 1
                            sample_mask += sample_mask
                        col_mask <<= 4
                sigprop.advance(cnt)

            new_sig |= cs
            prev_row_sig[gx] = new_sig & 0xFFFF

            tt = new_sig & 0xFFFF
            new_sig16 = tt | ((tt & 0x7777) << 1) | ((tt & 0xEEEE) >> 1)
            prev = (new_sig16 | u) & 0xF000

    # ---- Magnitude Refinement Pass ---------------------------------------
    if num_passes > 2:
        magref = RevMrpReader(data, lengths1, lengths2)
        half = 1 << (p - 2)
        for sy in range(n_sy):
            y = sy * 4
            for gx2 in range(0, n_gx, 2):
                x = gx2 * 4
                cwd = magref.fetch()
                sig32 = int(sig[sy, gx2]) \
                    | ((int(sig[sy, gx2 + 1]) if gx2 + 1 < n_gx else 0) << 16)
                if sig32:
                    col_mask = 0xF
                    for j in range(8):
                        if sig32 & col_mask:
                            sample_mask = 0x11111111 & col_mask
                            for k in range(4):
                                if sig32 & sample_mask:
                                    sym = cwd & 1
                                    v = ((1 - sym) << (p - 1)) | half
                                    dec[y + k, x + j] ^= \
                                        dec.dtype.type(v)
                                    cwd >>= 1
                                sample_mask += sample_mask
                        col_mask <<= 4
                magref.advance(bin(sig32).count('1'))
