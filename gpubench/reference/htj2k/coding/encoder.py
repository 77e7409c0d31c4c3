"""HT cleanup-pass block encoder — reference implementation in Python.

Encodes one codeblock of sign-magnitude samples (sign bit 31, magnitude
aligned so the least significant coded bitplane is bit p=30-missing_msbs)
into a single HT cleanup segment: MagSgn | MEL | VLC(reversed), with the
S_cup interface-locator word in the last two bytes.  Byte-exact with
ojph_encode_codeblock32 (OpenJPH src/core/coding/
ojph_block_encoder.cpp:542-1017).
"""
from __future__ import annotations

import numpy as np

from .tables import MEL_E, get_tables


class MelEncoder:
    """MEL adaptive run-length encoder (ojph_block_encoder.cpp:273-347)."""

    def __init__(self):
        self.out = bytearray()
        self.remaining_bits = 8
        self.tmp = 0
        self.run = 0
        self.k = 0
        self.threshold = 1

    def _emit_bit(self, v: int):
        self.tmp = (self.tmp << 1) + v
        self.remaining_bits -= 1
        if self.remaining_bits == 0:
            self.out.append(self.tmp)
            self.remaining_bits = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def encode(self, bit: bool):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._emit_bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << int(MEL_E[self.k])
        else:
            self._emit_bit(0)
            t = int(MEL_E[self.k])
            while t > 0:
                t -= 1
                self._emit_bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << int(MEL_E[self.k])


class VlcEncoder:
    """Backward-growing VLC bit packer (ojph_block_encoder.cpp:352-407).

    Bits are packed LSB-first; bytes are emitted back-to-front.  After a
    byte > 0x8F, the next byte may carry 8 bits only if it would not
    become 0x7F followed by the stuffing rule; mirrored exactly.
    """

    def __init__(self):
        # Bytes in *emission* order; the file order is
        # reversed(out) + the 0xFF sentinel (whose low nibble starts as
        # the 4 dummy bits in tmp and is later replaced by scup's low
        # nibble via the interface-locator word).
        self.out = bytearray()
        self.used_bits = 4
        self.tmp = 0xF
        self.last_greater_than_8F = True

    def encode(self, cwd: int, cwd_len: int):
        while cwd_len > 0:
            avail_bits = 8 - (1 if self.last_greater_than_8F else 0) \
                - self.used_bits
            t = min(avail_bits, cwd_len)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used_bits
            self.used_bits += t
            avail_bits -= t
            cwd_len -= t
            cwd >>= t
            if avail_bits == 0:
                if self.last_greater_than_8F and self.tmp != 0x7F:
                    self.last_greater_than_8F = False
                    continue
                self.out.append(self.tmp)
                self.last_greater_than_8F = self.tmp > 0x8F
                self.tmp = 0
                self.used_bits = 0

    @property
    def pos(self) -> int:
        return len(self.out) + 1  # reference vlc.pos starts at 1


def terminate_mel_vlc(mel: MelEncoder, vlc: VlcEncoder) -> tuple:
    """Fuse termination (ojph_block_encoder.cpp:412-441).

    Returns (mel_bytes, vlc_bytes) in file order; vlc_bytes ends with the
    0xFF sentinel whose content is later replaced by the scup word."""
    if mel.run > 0:
        mel._emit_bit(1)

    mel_tmp = (mel.tmp << mel.remaining_bits) & 0xFF
    mel_mask = (0xFF << mel.remaining_bits) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used_bits) if vlc.used_bits else 0
    mel_bytes = bytearray(mel.out)
    vlc_list = list(vlc.out)  # emission order (reverse of file order)

    if (mel_mask | vlc_mask) != 0:
        fuse = mel_tmp | vlc.tmp
        if (((fuse ^ mel_tmp) & mel_mask)
                | ((fuse ^ vlc.tmp) & vlc_mask)) == 0 \
                and fuse != 0xFF and len(vlc_list) > 0:
            mel_bytes.append(fuse)
        else:
            mel_bytes.append(mel_tmp)  # mel_tmp cannot be 0xFF
            vlc_list.append(vlc.tmp)
    return bytes(mel_bytes), bytes(reversed(vlc_list)) + b'\xff'


class MsEncoder:
    """Forward MagSgn packer with 0xFF stuffing
    (ojph_block_encoder.cpp:446-533)."""

    def __init__(self):
        self.out = bytearray()
        self.max_bits = 8
        self.used_bits = 0
        self.tmp = 0

    def encode(self, cwd: int, cwd_len: int):
        while cwd_len > 0:
            t = min(self.max_bits - self.used_bits, cwd_len)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used_bits
            self.used_bits += t
            cwd >>= t
            cwd_len -= t
            if self.used_bits >= self.max_bits:
                self.out.append(self.tmp)
                self.max_bits = 7 if self.tmp == 0xFF else 8
                self.tmp = 0
                self.used_bits = 0

    def terminate(self):
        if self.used_bits:
            t = self.max_bits - self.used_bits
            self.tmp |= (0xFF & ((1 << t) - 1)) << self.used_bits
            self.used_bits += t
            if self.tmp != 0xFF:
                self.out.append(self.tmp)
        elif self.max_bits == 7:
            self.out.pop()


def _quad_sample(buf: np.ndarray, y: int, x: int, width: int, height: int,
                 p: int, bits: int = 32):
    """(significance, exponent e_q, magsgn value v_n) of one sample."""
    if x >= width or y >= height:
        return 0, 0, 0
    t = int(buf[y, x])
    val = (t + t) & ((1 << bits) - 1)
    val >>= p
    val &= ~1
    if val == 0:
        return 0, 0, 0
    val -= 1
    e_q = val.bit_length()  # B - clz(2*mu_p - 1)
    val -= 1
    s = val + (t >> (bits - 1))  # v_n = 2*(mu_p - 1) + sign
    return 1, e_q, s


def encode_codeblock(buf: np.ndarray, missing_msbs: int,
                     width: int, height: int, bits: int = 32) -> bytes:
    """Encode one codeblock; returns the cleanup segment bytes.

    ``buf`` is a [>=height, >=width] uint32 (or uint64 for the >30
    bit-plane path, ojph_encode_codeblock64) sign-magnitude array.
    """
    t = get_tables()
    enc_vlc0, enc_vlc1 = t['enc_vlc0'], t['enc_vlc1']
    uvlc = t['enc_uvlc']

    mel = MelEncoder()
    vlc = VlcEncoder()
    ms = MsEncoder()
    p = (30 if bits == 32 else 62) - missing_msbs

    qw = (width + 1) >> 1

    # e_val / cx_val line buffers (ojph_block_encoder.cpp:577-580):
    # per quad boundary, max E and OR of rho bits of the bottom row
    e_val = np.zeros(qw + 2, dtype=np.int32)
    cx_val = np.zeros(qw + 2, dtype=np.int32)

    def encode_quad_pair(y, x_pair, c_q0, initial, lep_idx, max_e_in):
        """Process two quads; returns (next c_q0, next max_e)."""
        nonlocal_vals = []
        tuples = []
        rhos = []
        u_qs = []
        e_qmaxs = []
        quad_data = []
        for k in range(2):
            x = x_pair + 2 * k
            if x >= width:
                break
            sig0, e0, s0 = _quad_sample(buf, y, x, width, height, p, bits)
            sig1, e1, s1 = _quad_sample(buf, y + 1, x, width, height, p, bits)
            sig2, e2, s2 = _quad_sample(buf, y, x + 1, width, height, p, bits)
            sig3, e3, s3 = _quad_sample(buf, y + 1, x + 1, width, height, p, bits)
            rho = sig0 | (sig1 << 1) | (sig2 << 2) | (sig3 << 3)
            e_qmax = max(e0, e1, e2, e3)
            quad_data.append(((e0, e1, e2, e3), (s0, s1, s2, s3)))
            rhos.append(rho)
            e_qmaxs.append(e_qmax)
        return rhos, e_qmaxs, quad_data

    # --- initial row of quads --------------------------------------------
    c_q0 = 0
    lep = 0  # index into e_val: reference lep pointer
    e_val[0] = 0
    cx_val[0] = 0
    qx = 0
    for x in range(0, width, 4):
        rhos, e_qmaxs, quad_data = encode_quad_pair(0, x, c_q0, True, lep, 0)
        # first quad
        rho0 = rhos[0]
        (e_q, s_q) = quad_data[0]
        Uq0 = max(e_qmaxs[0], 1)
        u_q0 = Uq0 - 1
        u_q1 = 0
        eps0 = 0
        if u_q0 > 0:
            eps0 |= (e_q[0] == e_qmaxs[0]) and e_q[0] > 0
            eps0 |= ((e_q[1] == e_qmaxs[0]) and e_q[1] > 0) << 1
            eps0 |= ((e_q[2] == e_qmaxs[0]) and e_q[2] > 0) << 2
            eps0 |= ((e_q[3] == e_qmaxs[0]) and e_q[3] > 0) << 3
        e_val[lep] = max(e_val[lep], e_q[1])
        lep += 1
        e_val[lep] = e_q[3]
        cx_val[lep - 1] |= (rho0 & 2) >> 1
        cx_val[lep] = (rho0 & 8) >> 3
        tuple0 = int(enc_vlc0[(c_q0 << 8) + (rho0 << 4) + eps0])
        vlc.encode(tuple0 >> 8, (tuple0 >> 4) & 7)
        if c_q0 == 0:
            mel.encode(rho0 != 0)
        for n in range(4):
            m = Uq0 - ((tuple0 >> n) & 1) if (rho0 >> n) & 1 else 0
            ms.encode(s_q[n] & ((1 << m) - 1), m)

        if len(rhos) > 1:
            rho1 = rhos[1]
            (e_q, s_q) = quad_data[1]
            c_q1 = (rho0 >> 1) | (rho0 & 1)
            Uq1 = max(e_qmaxs[1], 1)
            u_q1 = Uq1 - 1
            eps1 = 0
            if u_q1 > 0:
                eps1 |= (e_q[0] == e_qmaxs[1]) and e_q[0] > 0
                eps1 |= ((e_q[1] == e_qmaxs[1]) and e_q[1] > 0) << 1
                eps1 |= ((e_q[2] == e_qmaxs[1]) and e_q[2] > 0) << 2
                eps1 |= ((e_q[3] == e_qmaxs[1]) and e_q[3] > 0) << 3
            e_val[lep] = max(e_val[lep], e_q[1])
            lep += 1
            e_val[lep] = e_q[3]
            cx_val[lep - 1] |= (rho1 & 2) >> 1
            cx_val[lep] = (rho1 & 8) >> 3
            tuple1 = int(enc_vlc0[(c_q1 << 8) + (rho1 << 4) + eps1])
            vlc.encode(tuple1 >> 8, (tuple1 >> 4) & 7)
            if c_q1 == 0:
                mel.encode(rho1 != 0)
            for n in range(4):
                m = Uq1 - ((tuple1 >> n) & 1) if (rho1 >> n) & 1 else 0
                ms.encode(s_q[n] & ((1 << m) - 1), m)
            c_q0 = (rho1 >> 1) | (rho1 & 1)
        else:
            rho1 = 0
            c_q0 = 0

        # u_q encoding for the pair (ojph_block_encoder.cpp:763-785)
        if u_q0 > 0 and u_q1 > 0:
            mel.encode(min(u_q0, u_q1) > 2)
        if u_q0 > 2 and u_q1 > 2:
            vlc.encode(int(uvlc[u_q0 - 2][0]), int(uvlc[u_q0 - 2][1]))
            vlc.encode(int(uvlc[u_q1 - 2][0]), int(uvlc[u_q1 - 2][1]))
            vlc.encode(int(uvlc[u_q0 - 2][2]), int(uvlc[u_q0 - 2][3]))
            vlc.encode(int(uvlc[u_q1 - 2][2]), int(uvlc[u_q1 - 2][3]))
            if bits == 64:  # u_q extension (encoder64, :1269-1270)
                vlc.encode(int(uvlc[u_q0 - 2][4]), int(uvlc[u_q0 - 2][5]))
                vlc.encode(int(uvlc[u_q1 - 2][4]), int(uvlc[u_q1 - 2][5]))
        elif u_q0 > 2 and u_q1 > 0:
            vlc.encode(int(uvlc[u_q0][0]), int(uvlc[u_q0][1]))
            vlc.encode(u_q1 - 1, 1)
            vlc.encode(int(uvlc[u_q0][2]), int(uvlc[u_q0][3]))
            if bits == 64:  # (:1277)
                vlc.encode(int(uvlc[u_q0][4]), int(uvlc[u_q0][5]))
        else:
            vlc.encode(int(uvlc[u_q0][0]), int(uvlc[u_q0][1]))
            vlc.encode(int(uvlc[u_q1][0]), int(uvlc[u_q1][1]))
            vlc.encode(int(uvlc[u_q0][2]), int(uvlc[u_q0][3]))
            vlc.encode(int(uvlc[u_q1][2]), int(uvlc[u_q1][3]))
            if bits == 64:  # (:1285-1286)
                vlc.encode(int(uvlc[u_q0][4]), int(uvlc[u_q0][5]))
                vlc.encode(int(uvlc[u_q1][4]), int(uvlc[u_q1][5]))

    e_val[lep + 1] = 0

    # --- non-initial rows --------------------------------------------------
    for y in range(2, height, 2):
        lep = 0
        max_e = max(int(e_val[0]), int(e_val[1])) - 1
        e_val[0] = 0
        lcxp = 0
        c_q0 = int(cx_val[0]) + (int(cx_val[1]) << 2)
        cx_val[0] = 0
        for x in range(0, width, 4):
            rhos, e_qmaxs, quad_data = encode_quad_pair(y, x, c_q0, False,
                                                        lep, max_e)
            rho0 = rhos[0]
            (e_q, s_q) = quad_data[0]
            kappa = max(1, max_e) if (rho0 & (rho0 - 1)) else 1
            Uq0 = max(e_qmaxs[0], kappa)
            u_q0 = Uq0 - kappa
            u_q1 = 0
            eps0 = 0
            if u_q0 > 0:
                eps0 |= (e_q[0] == e_qmaxs[0]) and e_q[0] > 0
                eps0 |= ((e_q[1] == e_qmaxs[0]) and e_q[1] > 0) << 1
                eps0 |= ((e_q[2] == e_qmaxs[0]) and e_q[2] > 0) << 2
                eps0 |= ((e_q[3] == e_qmaxs[0]) and e_q[3] > 0) << 3
            e_val[lep] = max(int(e_val[lep]), e_q[1])
            lep += 1
            max_e = max(int(e_val[lep]), int(e_val[lep + 1])) - 1
            e_val[lep] = e_q[3]
            cx_val[lcxp] |= (rho0 & 2) >> 1
            lcxp += 1
            c_q1 = int(cx_val[lcxp]) + (int(cx_val[lcxp + 1]) << 2)
            cx_val[lcxp] = (rho0 & 8) >> 3
            tuple0 = int(enc_vlc1[(c_q0 << 8) + (rho0 << 4) + eps0])
            vlc.encode(tuple0 >> 8, (tuple0 >> 4) & 7)
            if c_q0 == 0:
                mel.encode(rho0 != 0)
            for n in range(4):
                m = Uq0 - ((tuple0 >> n) & 1) if (rho0 >> n) & 1 else 0
                ms.encode(s_q[n] & ((1 << m) - 1), m)

            if len(rhos) > 1:
                rho1 = rhos[1]
                (e_q, s_q) = quad_data[1]
                kappa = max(1, max_e) if (rho1 & (rho1 - 1)) else 1
                c_q1 |= ((rho0 & 4) >> 1) | ((rho0 & 8) >> 2)
                Uq1 = max(e_qmaxs[1], kappa)
                u_q1 = Uq1 - kappa
                eps1 = 0
                if u_q1 > 0:
                    eps1 |= (e_q[0] == e_qmaxs[1]) and e_q[0] > 0
                    eps1 |= ((e_q[1] == e_qmaxs[1]) and e_q[1] > 0) << 1
                    eps1 |= ((e_q[2] == e_qmaxs[1]) and e_q[2] > 0) << 2
                    eps1 |= ((e_q[3] == e_qmaxs[1]) and e_q[3] > 0) << 3
                e_val[lep] = max(int(e_val[lep]), e_q[1])
                lep += 1
                max_e = max(int(e_val[lep]), int(e_val[lep + 1])) - 1
                e_val[lep] = e_q[3]
                cx_val[lcxp] |= (rho1 & 2) >> 1
                lcxp += 1
                c_q0 = int(cx_val[lcxp]) + (int(cx_val[lcxp + 1]) << 2)
                cx_val[lcxp] = (rho1 & 8) >> 3
                tuple1 = int(enc_vlc1[(c_q1 << 8) + (rho1 << 4) + eps1])
                vlc.encode(tuple1 >> 8, (tuple1 >> 4) & 7)
                if c_q1 == 0:
                    mel.encode(rho1 != 0)
                for n in range(4):
                    m = Uq1 - ((tuple1 >> n) & 1) if (rho1 >> n) & 1 else 0
                    ms.encode(s_q[n] & ((1 << m) - 1), m)
                c_q0 |= ((rho1 & 4) >> 1) | ((rho1 & 8) >> 2)
            else:
                rho1 = 0
                c_q0 = c_q1  # matches reference: c_q0 set before 2nd quad

            vlc.encode(int(uvlc[u_q0][0]), int(uvlc[u_q0][1]))
            vlc.encode(int(uvlc[u_q1][0]), int(uvlc[u_q1][1]))
            vlc.encode(int(uvlc[u_q0][2]), int(uvlc[u_q0][3]))
            vlc.encode(int(uvlc[u_q1][2]), int(uvlc[u_q1][3]))
            if bits == 64:  # u_q extension (encoder64, :1491-1492)
                vlc.encode(int(uvlc[u_q0][4]), int(uvlc[u_q0][5]))
                vlc.encode(int(uvlc[u_q1][4]), int(uvlc[u_q1][5]))

    mel_bytes, vlc_bytes = terminate_mel_vlc(mel, vlc)
    ms.terminate()

    out = bytearray(ms.out) + mel_bytes + vlc_bytes
    num_bytes = len(mel_bytes) + len(vlc_bytes)
    out[-1] = (num_bytes >> 4) & 0xFF
    out[-2] = (out[-2] & 0xF0) | (num_bytes & 0xF)
    return bytes(out)


# ---------------------------------------------------------------------------
# SigProp + MagRef pass emission (multi-pass HT segments)
#
# The reference encoder is cleanup-only (ojph_block_encoder.cpp:548
# asserts num_passes==1); its DECODER however handles 2- and 3-pass
# blocks (ojph_block_decoder32.cpp:1318-1611), so these writers are the
# exact inverse of that decode path (and of coding/decoder.py
# _decode_spp_mrp).  They let the framework emit finer truncation
# points than a whole cleanup bitplane: the cleanup pass codes
# magnitude bits >= p and SigProp/MagRef code plane p-1 for the
# member samples the decoder will visit.
# ---------------------------------------------------------------------------


class _SppEncoder(MsEncoder):
    """Forward packer for the SigProp segment: same 0xFF stuffing as
    MagSgn, but terminated with zero padding (the SigProp reader's
    exhaustion fill is 0, frwd_init<0> at ojph_block_decoder32.cpp:1371
    vs 0xFF for MagSgn)."""

    def terminate(self):
        if self.used_bits:
            self.out.append(self.tmp)


class _MrpEncoder(VlcEncoder):
    """Backward packer for the MagRef segment: VLC stuffing rules with
    the MagRef reader's initial state (rev_init_mrp starts with
    unstuff=true and an empty window, ojph_block_decoder32.cpp:517-575).
    Bytes are emitted in read order (file order reversed)."""

    def __init__(self):
        self.out = bytearray()
        self.used_bits = 0
        self.tmp = 0
        self.last_greater_than_8F = True

    def terminate(self) -> bytes:
        lst = list(self.out)
        if self.used_bits:
            lst.append(self.tmp)
        return bytes(reversed(lst))


_SPP_SPREAD = (0x33, 0x76, 0xEC, 0xC8)


def _pack_sig(mag: np.ndarray, p: int, width: int, height: int):
    """Cleanup significance packed 4 bits per column per 4x4 group
    (same layout as decoder._sig_from_inf)."""
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2
    sig = np.zeros((n_sy + 1, n_gx + 1), dtype=np.uint32)
    ys, xs = np.nonzero(mag[:height, :width] >> p)
    for y, x in zip(ys.tolist(), xs.tolist()):
        sig[y >> 2, x >> 2] |= 1 << (((x & 3) << 2) | (y & 3))
    return sig


def encode_spp_mrp(buf: np.ndarray, missing_msbs: int, width: int,
                   height: int, num_passes: int = 3,
                   stripe_causal: bool = False,
                   bits: int = 32) -> bytes:
    """Emit the refinement segment (SigProp [+ MagRef]) for ``buf``.

    ``buf`` uses the same convention as encode_codeblock: sign in the
    top bit, magnitude aligned so plane p = (30|62) - missing_msbs is
    the cleanup LSB.  SigProp codes plane p-1 for insignificant
    neighbors of significant samples; MagRef refines plane p-1 of
    cleanup-significant samples.  Returns SPP bytes + MRP bytes (one
    segment; the readers meet in the middle)."""
    p = (30 if bits == 32 else 62) - missing_msbs
    if p < 2:
        raise ValueError('multi-pass encoding needs p >= 2')
    dt = np.uint32 if bits == 32 else np.uint64
    sub = buf[:height, :width].astype(dt)
    mag = sub & dt((1 << (bits - 1)) - 1)
    sgn = (sub >> dt(bits - 1)).astype(np.uint8)

    sig = _pack_sig(mag, p, width, height)
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2

    # ---- SigProp pass (inverse of decoder.py:382-464) -------------------
    spp = _SppEncoder()
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
                col_mask = 0xF
                inv_sig = ~cs & pattern & 0xFFFFFFFF
                for i in range(0, 16, 4):
                    if (col_mask & new_sig) == 0:
                        col_mask <<= 4
                        continue
                    sample_mask = 0x1111 & col_mask
                    for k in range(4):
                        if new_sig & sample_mask:
                            new_sig &= ~sample_mask & 0xFFFFFFFF
                            bit = (int(mag[y + k, x + (i >> 2)])
                                   >> (p - 1)) & 1
                            spp.encode(bit, 1)
                            if bit:
                                new_sig |= (_SPP_SPREAD[k] << i) & inv_sig
                        sample_mask <<= 1
                    col_mask <<= 4
                if new_sig:
                    col_mask = 0xF
                    for i in range(4):
                        if (col_mask & new_sig) == 0:
                            col_mask <<= 4
                            continue
                        sample_mask = 0x1111 & col_mask
                        for k in range(4):
                            if new_sig & sample_mask:
                                spp.encode(int(sgn[y + k, x + i]), 1)
                            sample_mask += sample_mask
                        col_mask <<= 4

            new_sig |= cs
            prev_row_sig[gx] = new_sig & 0xFFFF

            tt = new_sig & 0xFFFF
            new_sig16 = tt | ((tt & 0x7777) << 1) | ((tt & 0xEEEE) >> 1)
            prev = (new_sig16 | u) & 0xF000
    spp.terminate()
    out = bytes(spp.out)

    # ---- MagRef pass (inverse of decoder.py:466-491) ---------------------
    if num_passes > 2:
        mrp = _MrpEncoder()
        for sy in range(n_sy):
            y = sy * 4
            for gx2 in range(0, n_gx, 2):
                x = gx2 * 4
                sig32 = int(sig[sy, gx2]) \
                    | ((int(sig[sy, gx2 + 1]) if gx2 + 1 < n_gx else 0)
                       << 16)
                if sig32:
                    col_mask = 0xF
                    for j in range(8):
                        if sig32 & col_mask:
                            sample_mask = 0x11111111 & col_mask
                            for k in range(4):
                                if sig32 & sample_mask:
                                    sym = (int(mag[y + k, x + j])
                                           >> (p - 1)) & 1
                                    mrp.encode(sym, 1)
                                sample_mask += sample_mask
                        col_mask <<= 4
        out += mrp.terminate()
    return out


def encode_codeblock_multipass(buf: np.ndarray, missing_msbs: int,
                               width: int, height: int,
                               num_passes: int = 3,
                               stripe_causal: bool = False,
                               bits: int = 32) -> tuple:
    """Encode one codeblock as cleanup + SigProp [+ MagRef].

    Returns (cleanup_segment, refinement_segment).  The caller signals
    num_passes and both segment lengths in the packet header."""
    seg1 = encode_codeblock(buf, missing_msbs, width, height, bits=bits)
    seg2 = encode_spp_mrp(buf, missing_msbs, width, height,
                          num_passes=num_passes,
                          stripe_causal=stripe_causal, bits=bits)
    return seg1, seg2
