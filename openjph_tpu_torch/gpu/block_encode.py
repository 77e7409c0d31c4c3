"""Plain PyTorch version of the HT cleanup-pass block encoder (K3): N
same-width codeblocks encoded at once, vectorised over the lanes.

The per-pair arithmetic is that of the JAX package's
tpu/block_encode.py::encode_cleanup_core (significance and exponents,
the VLC and UVLC codeword lookups, the MEL events, the MagSgn values;
ojph_block_encoder.cpp:542-1017), run as a Python loop over quad rows
and quad pairs whose body is tensor ops over the lanes.  The MEL
run-length coder runs inside the loop (it is a per-lane state machine),
and each stream's (value, length) records are then packed LSB-first
into dense 32-bit words by one vectorised writer, as the Pallas kernel
packs them (tpu/block_encode_pallas.py ``_append``, ``mel_event`` and
the MEL terminate of ``_finish``).  Lanes stop emitting at their
quad-row limit ``qhl`` (the kernel's ``live`` mask).

It is the reference the CUDA kernel is held against and the path CPU
tensors take; it is not fast.  uint32 quantities are held in int64
tensors.  An int64 ``buf`` (uint64 patterns, sign in bit 63, p = 63 -
kmax) is coded as the reference's ojph_encode_codeblock64 codes it
(the JAX package's coding/encoder.py::encode_codeblock(bits=64)): up to
63 MagSgn bits a sample, and each u_q's extension bits (enc_uvlc's last
two columns, four bits from u_q = 33) after the pair's suffixes.  Inputs and outputs follow the kernel's contract: ``buf``
int32 [N, hp, wp] holding uint32 sign-magnitude bit patterns, ``p`` =
31 - kmax and ``qhl`` int32 [N]; ``cat`` int32 [N, wm + wv + ws]
holding uint32 words (MEL at [0, wm), VLC at [wm, wm + wv), MagSgn
after), each stream's words past its used prefix zero; ``bits`` int32
[N, 3] bit counts (MEL, VLC, MagSgn); ``ovf`` bool [N], set where a
stream needs more words than its cap (words past the cap are dropped).
"""
from __future__ import annotations

import numpy as np
import torch

from ..coding.tables import get_tables
from .block_decode import clz64, srl, to_i32_bits

_MASK32 = 0xFFFFFFFF
_TABLES = {}


def tables(device, ext: bool = False) -> tuple:
    """(vlc [4096], uvlc [4, 75]) int64 encoder tables on ``device``:
    enc_vlc0|enc_vlc1 (the first quad row uses offset 0, later rows
    2048), and enc_uvlc's prefix, prefix length, suffix and suffix
    length columns; ``ext`` adds its extension and extension length
    columns (uvlc [6, 75])."""
    key = (str(device), ext)
    if key not in _TABLES:
        t = get_tables()
        vlc = np.concatenate([t['enc_vlc0'], t['enc_vlc1']])
        uvlc = t['enc_uvlc'][:, :6 if ext else 4].T
        _TABLES[key] = (
            torch.as_tensor(vlc.astype(np.int64), device=device),
            torch.as_tensor(np.ascontiguousarray(uvlc, np.int64),
                            device=device))
    return _TABLES[key]


def _mel_exp(k):
    return torch.where(k >= 11, k - 7, torch.clamp(k // 3, max=3))


def _qsample(t, p):
    """(sig, e, MagSgn value) of sign-magnitude samples t (int64 holding
    uint32) at p = 31 - kmax.  ``(t + t) >> p`` wraps in uint32, which
    drops the sign bit; e = 32 - clz(val - 1) where val != 0."""
    val = (((t + t) & _MASK32) >> p) & ~1
    sig = val != 0
    e = torch.frexp((val - 1).clamp(min=1).to(torch.float64)).exponent
    e = torch.where(sig, e.to(torch.int64), 0)
    s = torch.where(sig, (val - 2) + (t >> 31), 0)
    return sig, e, s


def _qsample64(t, p):
    """_qsample of uint64 patterns held in int64, at p = 63 - kmax:
    ``t + t`` wraps in int64 as in uint64, the shift is logical and e =
    64 - clz(val - 1), counted exactly (float64 would round)."""
    val = srl(t + t, p) & ~1
    sig = val != 0
    e = torch.where(sig, 64 - clz64((val - 1).clamp(min=1)), 0)
    s = torch.where(sig, (val - 2) + srl(t, 63), 0)
    return sig, e, s


class _Mel:
    """MEL run-length coder of every lane (MelEnc::encode); each event
    appends one (codeword, length) record, LSB-first."""

    def __init__(self, n, device):
        z = torch.zeros(n, dtype=torch.int64, device=device)
        self.run, self.k = z, z
        self.vals, self.lens = [], []

    def event(self, mask, bit):
        if mask.device.type == 'cpu' and not bool(mask.any()):
            # no lane has an event: its records would all be empty
            # (a host-side test, so on the CPU only)
            return
        e = _mel_exp(self.k)
        nz = mask & ~bit
        run2 = torch.where(nz, self.run + 1, self.run)
        hit = nz & (run2 >= (1 << e))
        isb = mask & bit
        # a '0' followed by the low e bits of the run, MSB-first: the
        # run's bits reversed into LSB-first order
        rev = torch.zeros_like(self.run)
        for i in range(5):
            pos = e - 1 - i
            rev = rev | torch.where(pos >= 0, ((self.run >> i) & 1)
                                    << pos.clamp(min=0), 0)
        self.vals.append(torch.where(hit, 1, torch.where(isb, rev << 1, 0)))
        self.lens.append(torch.where(hit, 1, torch.where(isb, 1 + e, 0)))
        self.run = torch.where(hit | isb, 0, run2)
        self.k = torch.where(hit, (self.k + 1).clamp(max=12),
                             torch.where(isb, (self.k - 1).clamp(min=0),
                                         self.k))

    def terminate(self):
        """A pending run is flushed with a '1' (ojph_block_encoder.cpp:412)."""
        pend = self.run > 0
        self.vals.append(pend.to(torch.int64))
        self.lens.append(pend.to(torch.int64))


def pack_records(vals, lens, cap: int):
    """LSB-first dense words of one stream per lane.  vals / lens
    [R, N] int64 records in append order (lengths 0..32).  Returns
    (words [N, cap] int64 holding uint32, bits [N], ovf [N])."""
    n = vals.shape[1]
    vals = vals & ((1 << lens) - 1)
    pos = torch.cumsum(lens, 0) - lens
    bits = pos[-1] + lens[-1]
    sh = vals << (pos & 31)                       # at most 62 bits
    w = pos >> 5
    out = torch.zeros((n, cap + 1), dtype=torch.int64, device=vals.device)
    # records of one lane cover disjoint bits, so adding is OR-ing; words
    # at or past the cap go to the spare column cap, which is dropped
    out.scatter_add_(1, w.clamp(max=cap).T, (sh & _MASK32).T)
    out.scatter_add_(1, (w + 1).clamp(max=cap).T, (sh >> 32).T)
    return out[:, :cap], bits, (bits + 31) // 32 > cap


def encode_cleanup_core(buf, p, width: int, height: int, caps, qhl):
    """Encode N same-shape codeblocks into dense MEL / VLC / MagSgn
    words (see the module docstring for the contract)."""
    n = buf.shape[0]
    dev = buf.device
    wide = buf.dtype == torch.int64
    vlc_tbl, uv = tables(dev, wide)
    qw = (width + 1) >> 1
    qh = (height + 1) >> 1
    pairs = (qw + 1) >> 1
    pu = p.to(torch.int64)[:, None, None]
    if wide:
        sig, ee, ss = _qsample64(buf, pu)
    else:
        sig, ee, ss = _qsample(buf.to(torch.int64) & _MASK32, pu)
    sig = sig.to(torch.int64)
    qhl = qhl.to(torch.int64)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    e_val = torch.zeros((n, qw + 4), dtype=torch.int64, device=dev)
    cx_val = torch.zeros_like(e_val)
    c_q, max_e = zero, zero
    mel = _Mel(n, dev)
    vlc_v, vlc_l, ms_v, ms_l = [], [], [], []
    kbit = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)

    def uvlc(idx):
        i = idx.clamp(0, 74)
        return tuple(col[i] for col in uv)

    def magsgn(rho, uq, tup, s, gate):
        for k in range(4):
            m = torch.where(((rho >> k) & 1) != 0, uq - ((tup >> k) & 1), 0)
            m = torch.where(gate, m, 0)
            if wide:
                # up to 63 bits: two records of at most 32
                ms_v.append(s[:, k] & _MASK32)
                ms_l.append(m.clamp(max=32))
                ms_v.append(srl(s[:, k], 32))
                ms_l.append((m.clamp(max=63) - 32).clamp(min=0))
            else:
                ms_v.append(s[:, k])
                ms_l.append(m.clamp(max=31))

    for qy in range(qh):
        init = qy == 0
        live = qy < qhl
        # the pair's 2x4 samples in quad order: quad 0 is columns 0-1,
        # quad 1 columns 2-3, each column top sample first
        rs = slice(2 * qy, 2 * qy + 2)
        row_sig = sig[:, rs].transpose(1, 2).reshape(n, -1)
        row_e = ee[:, rs].transpose(1, 2).reshape(n, -1)
        row_s = ss[:, rs].transpose(1, 2).reshape(n, -1)
        for j in range(pairs):
            second = 2 * j + 1 < qw
            le = 2 * j
            if j == 0:
                max_e = torch.maximum(e_val[:, 0], e_val[:, 1]) - 1
                c_q = zero if init else cx_val[:, 0] + (cx_val[:, 1] << 2)
                e_val[:, 0] = 0
                cx_val[:, 0] = 0
            sg = row_sig[:, 8 * j:8 * j + 8]
            e8 = row_e[:, 8 * j:8 * j + 8]
            s8 = row_s[:, 8 * j:8 * j + 8]
            rho0 = (sg[:, :4] * kbit).sum(1)
            rho1 = (sg[:, 4:] * kbit).sum(1) if second else zero
            emax0 = e8[:, :4].amax(1)
            emax1 = e8[:, 4:].amax(1)

            # ---- quad 0 ----
            if init:
                kappa0 = torch.ones_like(max_e)
            else:
                two0 = (rho0 & (rho0 - 1)) != 0
                kappa0 = torch.where(two0, max_e.clamp(min=1), 1)
            uq0 = torch.maximum(emax0, kappa0)
            u_q0 = uq0 - kappa0
            hit0 = (e8[:, :4] == emax0[:, None]) & (e8[:, :4] > 0)
            eps0 = ((hit0 & (u_q0 > 0)[:, None]) * kbit).sum(1)
            e_val[:, le] = torch.maximum(e_val[:, le], e8[:, 1])
            if not init:
                max_e = torch.maximum(e_val[:, le + 1], e_val[:, le + 2]) - 1
            e_val[:, le + 1] = e8[:, 3]
            cx_val[:, le] = cx_val[:, le] | ((rho0 & 2) >> 1)
            c_q1_base = cx_val[:, le + 1] + (cx_val[:, le + 2] << 2)
            cx_val[:, le + 1] = (rho0 & 8) >> 3
            tbase = 0 if init else 2048
            tuple0 = vlc_tbl[tbase + (c_q << 8) + (rho0 << 4) + eps0]
            vlc_v.append(tuple0 >> 8)
            vlc_l.append(torch.where(live, (tuple0 >> 4) & 7, 0))
            mel.event(live & (c_q == 0), rho0 != 0)
            magsgn(rho0, uq0, tuple0, s8[:, :4], live)

            # ---- quad 1 (absent when qw is odd and this is the last
            # pair: it then emits nothing and updates no context) ----
            if init:
                c_q1 = (rho0 >> 1) | (rho0 & 1)
                kappa1 = torch.ones_like(max_e)
            else:
                c_q1 = c_q1_base | ((rho0 & 4) >> 1) | ((rho0 & 8) >> 2)
                two1 = (rho1 & (rho1 - 1)) != 0
                kappa1 = torch.where(two1, max_e.clamp(min=1), 1)
            uq1 = torch.maximum(emax1, kappa1)
            u_q1 = uq1 - kappa1 if second else zero
            hit1 = (e8[:, 4:] == emax1[:, None]) & (e8[:, 4:] > 0)
            eps1 = ((hit1 & (u_q1 > 0)[:, None]) * kbit).sum(1)
            tuple1 = vlc_tbl[tbase + (c_q1 << 8) + (rho1 << 4) + eps1]
            live1 = live & second
            vlc_v.append(tuple1 >> 8)
            vlc_l.append(torch.where(live1, (tuple1 >> 4) & 7, 0))
            mel.event(live1 & (c_q1 == 0), rho1 != 0)
            magsgn(rho1, uq1, tuple1, s8[:, 4:], live1)
            if second:
                ev2 = torch.maximum(e_val[:, le + 1], e8[:, 5])
                if not init:
                    max_e = torch.maximum(e_val[:, le + 2],
                                          e_val[:, le + 3]) - 1
                c_q0n = cx_val[:, le + 2] + (cx_val[:, le + 3] << 2)
                e_val[:, le + 1] = ev2
                e_val[:, le + 2] = e8[:, 7]
                cx_val[:, le + 1] = cx_val[:, le + 1] | ((rho1 & 2) >> 1)
                cx_val[:, le + 2] = (rho1 & 8) >> 3

            # ---- u codes (ojph_block_encoder.cpp:763-785) ----
            if init:
                mel.event(live & (u_q0 > 0) & (u_q1 > 0),
                          torch.minimum(u_q0, u_q1) > 2)
            p0a, l0a, s0a, sl0a, *x0a = uvlc(u_q0 - 2)
            p1a, l1a, s1a, sl1a, *x1a = uvlc(u_q1 - 2)
            p0b, l0b, s0b, sl0b, *x0b = uvlc(u_q0)
            p1b, l1b, s1b, sl1b, *x1b = uvlc(u_q1)
            if init:
                case_a = (u_q0 > 2) & (u_q1 > 2)
                case_b = (u_q0 > 2) & (u_q1 > 0) & ~case_a
            else:
                case_a = case_b = torch.zeros_like(live)
            for cw, ln in (
                    (torch.where(case_a, p0a, p0b),
                     torch.where(case_a, l0a, l0b)),
                    (torch.where(case_a, p1a,
                                 torch.where(case_b, u_q1 - 1, p1b)),
                     torch.where(case_a, l1a, torch.where(case_b, 1, l1b))),
                    (torch.where(case_a, s0a, s0b),
                     torch.where(case_a, sl0a, sl0b)),
                    (torch.where(case_a, s1a, torch.where(case_b, 0, s1b)),
                     torch.where(case_a, sl1a,
                                 torch.where(case_b, 0, sl1b)))):
                vlc_v.append(cw)
                vlc_l.append(torch.where(live, ln, 0))
            if wide:
                # the u_q extensions (encoder64.cpp:1269-1286, 1491-1492)
                for cw, ln in (
                        (torch.where(case_a, x0a[0], x0b[0]),
                         torch.where(case_a, x0a[1], x0b[1])),
                        (torch.where(case_a, x1a[0],
                                     torch.where(case_b, 0, x1b[0])),
                         torch.where(case_a, x1a[1],
                                     torch.where(case_b, 0, x1b[1])))):
                    vlc_v.append(cw)
                    vlc_l.append(torch.where(live, ln, 0))

            # next pair's context
            if init:
                c_q = (rho1 >> 1) | (rho1 & 1) if second else zero
            else:
                c_q = (c_q0n | ((rho1 & 4) >> 1) | ((rho1 & 8) >> 2)
                       if second else c_q1_base)
    mel.terminate()

    words, bits, ovf = [], [], []
    for (v, ln), cap in zip(((mel.vals, mel.lens), (vlc_v, vlc_l),
                             (ms_v, ms_l)), caps):
        w, b, o = pack_records(torch.stack(v), torch.stack(ln), cap)
        words.append(w)
        bits.append(b)
        ovf.append(o)
    cat = to_i32_bits(torch.cat(words, 1))
    return (cat, torch.stack(bits, 1).to(torch.int32),
            ovf[0] | ovf[1] | ovf[2])
