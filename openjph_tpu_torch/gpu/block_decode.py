"""Plain PyTorch version of the HT cleanup-pass block decoder: N
same-shape codeblocks decoded at once, vectorised over the lanes
(the JAX package's tpu/block_decode.py::decode_cleanup_core, whose
semantics the Pallas kernel and this package's CUDA kernel share).

Within a block the three bitstreams force a sequential decode in quad
raster order (ojph_block_decoder32.cpp:855-1316), so this is a Python
loop over quad pairs whose body is a few dozen tensor ops over [N]
lanes.  It is the reference the CUDA kernel is held against and the
path CPU tensors take; it is not fast.

Streams arrive as dense, LSB-first, unstuffed words (bitprep.py
conventions), one row per lane.  uint32 quantities are held in int64
tensors; a reader's window is one int64 holding at most 63 valid bits
(a refill adds a 32-bit word whenever fewer than 32 remain).
Outputs follow the kernel's contract: ``dec`` int32 [N, height, width]
holding the uint32 sign-magnitude bit pattern, rows at or past
2*qh_lim zeroed; ``err`` bool [N], set where U_q > missing_msbs + 2
on a quad row below qh_lim.
"""
from __future__ import annotations

import numpy as np
import torch

from ..coding.tables import MEL_E, get_tables

_MASK32 = 0xFFFFFFFF
_TABLES = {}


def tables(device) -> tuple:
    """(vlc [2048], uvlc [576]) int64 decoder tables on ``device``:
    dec_vlc0|dec_vlc1 and dec_uvlc0|dec_uvlc1 (row 0 uses offsets 0,
    later rows 1024 and 320)."""
    key = str(device)
    if key not in _TABLES:
        t = get_tables()
        vlc = np.concatenate([t['dec_vlc0'], t['dec_vlc1']])
        uvlc = np.concatenate([t['dec_uvlc0'], t['dec_uvlc1']])
        _TABLES[key] = (torch.as_tensor(vlc.astype(np.int64), device=device),
                        torch.as_tensor(uvlc.astype(np.int64),
                                        device=device),
                        torch.as_tensor(MEL_E.astype(np.int64),
                                        device=device))
    return _TABLES[key]


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit pattern."""
    x = x & _MASK32
    return (x - ((x >> 31) << 32)).to(torch.int32)


class _Reader:
    """Dense LSB-first word stream per lane; reads past the row clamp
    onto its last word (the guard word)."""

    def __init__(self, words: torch.Tensor):
        self.words = words.to(torch.int64) & _MASK32
        n = words.shape[0]
        z = torch.zeros(n, dtype=torch.int64, device=words.device)
        self.win, self.nb, self.wi = z, z, z

    def refill(self):
        need = self.nb < 32
        idx = self.wi.clamp(max=self.words.shape[1] - 1)
        w = torch.gather(self.words, 1, idx[:, None])[:, 0]
        sh = self.nb.clamp(max=31)
        self.win = torch.where(need, self.win | (w << sh), self.win)
        self.nb = torch.where(need, self.nb + 32, self.nb)
        self.wi = torch.where(need, self.wi + 1, self.wi)

    def peek(self) -> torch.Tensor:
        return self.win & _MASK32

    def adv(self, n):
        self.win = self.win >> n
        self.nb = self.nb - n

    def take(self, n) -> torch.Tensor:
        v = self.win & ((1 << n) - 1)
        self.adv(n)
        return v


def _bitrev(v, length, maxlen: int = 5):
    """Bit-reverse the low ``length`` bits of v (length <= maxlen)."""
    r = torch.zeros_like(v)
    for i in range(maxlen):
        bit = (v >> i) & 1
        pos = length - 1 - i
        r = r | torch.where(pos >= 0, bit << pos.clamp(min=0),
                            torch.zeros_like(v))
    return r


def _mel_get_run(mask, mel: _Reader, mel_k, run, mel_e):
    """Masked MEL run decode (dec_mel_st); lanes outside ``mask`` keep
    their state and consume nothing."""
    eva = mel_e[mel_k.clamp(0, 12)]
    b = mel.take(mask.to(torch.int64))
    one = mask & (b == 1)
    vrev = mel.take(torch.where(mask & (b == 0), eva,
                                torch.zeros_like(eva)))
    v = _bitrev(vrev, eva)
    new_run = torch.where(one, ((1 << eva) - 1) << 1, (v << 1) + 1)
    new_k = torch.where(one, (mel_k + 1).clamp(max=12),
                        (mel_k - 1).clamp(min=0))
    return torch.where(mask, new_run, run), torch.where(mask, new_k, mel_k)


def decode_cleanup_core(mel_w, vlc_w, ms_w, p, width: int, height: int,
                        qh_lim=None):
    """Decode N same-shape cleanup segments from dense word rows
    (melw/vlcw/msw [N, W*]), p = 30 - missing_msbs [N] and the per-lane
    quad-row limit qh_lim [N] (None: every row).  Returns (dec int32
    [N, height, width], err bool [N])."""
    dev = mel_w.device
    n = mel_w.shape[0]
    qw = (width + 1) >> 1
    qh = (height + 1) >> 1
    vlc_tbl, uvlc_tbl, mel_e = tables(dev)
    p = p.to(torch.int64)
    qhl = (torch.full((n,), qh, dtype=torch.int64, device=dev)
           if qh_lim is None else qh_lim.to(torch.int64))
    mmsbp2 = 32 - p
    one_i = torch.ones(n, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    true = torch.ones(n, dtype=torch.bool, device=dev)

    mel, vlc, ms = _Reader(mel_w), _Reader(vlc_w), _Reader(ms_w)
    # run = mel.get_run() before the quad loop (decoder32.cpp:862)
    mel.refill()
    run, mel_k = _mel_get_run(true, mel, zero, zero, mel_e)
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    inf_prev = [zero] * (qw + 3)
    scr = [zero] * (qw + 2)
    rows = []
    for r in range(qh):
        initial = r == 0
        tbl_base = 0 if initial else 1024
        ubase = 0 if initial else 320
        in_lim = r < qhl
        inf_cur = [zero] * (qw + 3)
        newv = [zero] * (qw + 2)
        prev_vn = zero
        c_q = zero
        row_vals = []
        for qx2 in range(0, qw, 2):
            second = qx2 + 1 < qw
            vlc.refill()
            mel.refill()
            a0, a1, a2 = inf_prev[qx2], inf_prev[qx2 + 1], inf_prev[qx2 + 2]
            # ---- first quad of the pair ----
            if not initial:
                c_q = c_q | ((a0 & 0xA0) << 2) | ((a1 & 0x20) << 4)
            t0 = vlc_tbl[(tbl_base + c_q + (vlc.peek() & 0x7F))
                         .clamp(0, 2047)]
            cz = c_q == 0
            run = torch.where(cz, run - 2, run)
            t0 = torch.where(cz & (run != -1), zero, t0)
            run, mel_k = _mel_get_run(cz & (run < 0), mel, mel_k, run,
                                      mel_e)
            inf_cur[qx2] = t0
            if initial:
                c_q = ((t0 & 0x10) << 3) | ((t0 & 0xE0) << 2)
            else:
                c_q = (((t0 & 0x40) << 2) | ((t0 & 0x80) << 1)
                       | (a0 & 0x80) | ((a1 & 0xA0) << 2)
                       | ((a2 & 0x20) << 4))
            vlc.adv(t0 & 7)
            # ---- second quad of the pair ----
            t1 = vlc_tbl[(tbl_base + c_q + (vlc.peek() & 0x7F))
                         .clamp(0, 2047)]
            if second:
                cz1 = c_q == 0
                run = torch.where(cz1, run - 2, run)
                t1 = torch.where(cz1 & (run != -1), zero, t1)
                run, mel_k = _mel_get_run(cz1 & (run < 0), mel, mel_k,
                                          run, mel_e)
            else:
                t1 = zero
            inf_cur[qx2 + 1] = t1
            if initial:
                c_q = ((t1 & 0x10) << 3) | ((t1 & 0xE0) << 2)
            else:
                c_q = ((t1 & 0x40) << 2) | ((t1 & 0x80) << 1) | (a1 & 0x80)
            vlc.adv(t1 & 7)
            # ---- u for the pair (decoder32.cpp:1001-1088) ----
            uvlc_mode = ((t0 & 8) << 3) | ((t1 & 8) << 4)
            if initial:
                needu = uvlc_mode == 0xC0
                run = torch.where(needu, run - 2, run)
                uvlc_mode = torch.where(needu & (run == -1),
                                        uvlc_mode + 0x40, uvlc_mode)
                run, mel_k = _mel_get_run(needu & (run < 0), mel, mel_k,
                                          run, mel_e)
            ue = uvlc_tbl[(ubase + uvlc_mode + (vlc.peek() & 0x3F))
                          .clamp(0, 575)]
            vlc.adv(ue & 7)
            ue = ue >> 3
            tmp = vlc.take(ue & 0xF)
            ue = ue >> 4
            len0 = ue & 7
            ue = ue >> 3
            kappa0 = 1 if initial else 0
            u0 = kappa0 + (ue & 7) + (tmp & (~(0xFF << len0) & _MASK32))
            u1 = kappa0 + (ue >> 3) + (tmp >> len0) if second else zero
            # ---- MagSgn for the pair's quads ----
            for qx, q_inf, u_q in ((qx2, t0, u0), (qx2 + 1, t1, u1)):
                if qx >= qw:
                    break
                gamma = q_inf & 0xF0
                gamma = gamma & ((gamma - 0x10) & _MASK32)
                emax_v = scr[qx] | scr[qx + 1]
                emax = 31 - _clz32(emax_v | 2)
                kappa = torch.where(gamma != 0, emax, one_i)
                U_q = u_q if initial else (u_q + kappa) & _MASK32
                err = err | ((U_q > mmsbp2) & in_lim)
                two_cols = qx * 2 + 1 < width
                vals, v_ns = [], []
                for bit in range(4):
                    sig = ((q_inf >> (4 + bit)) & 1) != 0
                    if bit >= 2 and not two_cols:
                        sig = torch.zeros_like(sig)
                    ms.refill()
                    m_n = torch.where(
                        sig, _i32((U_q - ((q_inf >> (12 + bit)) & 1))
                                  & _MASK32), zero).clamp(0, 31)
                    ms_val = ms.peek()
                    ms.adv(m_n)
                    v_n = ms_val & ((1 << m_n) - 1)
                    v_n = v_n | (((q_inf >> (8 + bit)) & 1) << m_n)
                    v_n = torch.where(sig, v_n | 1, zero)
                    val = ((ms_val << 31) | _shl32((v_n + 2) & _MASK32,
                                                   p - 1)) & _MASK32
                    vals.append(torch.where(sig, val, zero))
                    v_ns.append(v_n)
                newv[qx] = prev_vn | v_ns[1]
                prev_vn = v_ns[3]
                row_vals.append(torch.stack(vals, dim=1))
        newv[qw] = prev_vn
        inf_prev = inf_cur
        scr = newv
        rows.append(torch.stack(row_vals, dim=0))     # [qw, N, 4]
    # [qh, qw, N, (dx, dy)] -> [N, 2qh, 2qw]
    v = torch.stack(rows, dim=0).reshape(qh, qw, n, 2, 2)
    dec = v.permute(2, 0, 4, 1, 3).reshape(n, qh * 2, qw * 2)
    dec = dec[:, :height, :width]
    live = (torch.arange(height, device=dev)[None, :]
            < 2 * qhl[:, None])[:, :, None]
    dec = torch.where(live, dec, torch.zeros_like(dec))
    return to_i32_bits(dec), err


def _i32(x):
    """uint32 values (int64) -> their signed int32 reading (int64)."""
    return x - ((x >> 31) << 32)


def _shl32(v, n):
    """uint32 shift left; 0 for n outside [0, 31] (JAX's semantics)."""
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, (v << n.clamp(0, 31)) & _MASK32,
                       torch.zeros_like(v))


def _clz32(x):
    """Leading zeros of uint32 values (x > 0) held in int64."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << (32 - s))
        x = torch.where(big, x, x << s)
        n = torch.where(big, n, n + s)
    return n
