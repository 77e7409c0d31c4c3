"""Plain PyTorch version of the HT cleanup-pass block decoder: N
same-shape codeblocks decoded at once, vectorised over the lanes
(the JAX package's tpu/block_decode.py::decode_cleanup_core, whose
semantics the Pallas kernel and this package's CUDA kernel share).

The decode is split as the JAX package splits it, and as the CUDA
kernel's phases run it: ``_step1`` runs the MEL / VLC / UVLC chain, a
Python loop over quad pairs whose body is a few dozen tensor ops over
[N] lanes, and yields each quad's ``inf`` and ``u``; ``_step2`` does
the MagSgn work one quad row at a time, vectorised over lanes and quads
(bit offsets from a prefix sum of the samples' bit counts).  It is the
reference the CUDA kernel is held against and the path CPU tensors
take; it is not fast.

Streams arrive as dense, LSB-first, unstuffed words (as
native.prep_cleanup_streams makes them), one row per lane.  uint32
quantities are held in int64 tensors; a reader's window is one int64
holding at most 63 valid bits (a refill adds a 32-bit word whenever
fewer than 32 remain).  Outputs follow the kernel's contract:
``dec`` int32 [N, height, width] holding the uint32 sign-magnitude bit
pattern, rows at or past 2*qh_lim zeroed; ``err`` bool [N], set where
U_q > missing_msbs + 2 on a quad row below qh_lim.

The 64-bit mode (``bits=64``; the reference's ojph_decode_codeblock64,
which the JAX package runs on its host for more than 30 bit planes)
takes p = 62 - missing_msbs, extends u_q past 32 by four more VLC bits
(decoder64.cpp:1000-1010, 1122-1132), reads up to 64 MagSgn bits a
sample and returns ``dec`` int64 holding the uint64 pattern (sign in
bit 63).  Torch has almost no arithmetic on uint64, so such patterns
live in int64 tensors; ``srl`` / ``shl`` / ``clz64`` give them unsigned
shifts and bit lengths.
"""
from __future__ import annotations

import numpy as np
import torch

from ..coding.tables import MEL_E, get_tables

_MASK32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)
_TABLES = {}
_BIAS = {}


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


def uvlc_bias(device) -> torch.Tensor:
    """dec_uvlc0_bias [320] int64 on ``device``: the u offsets that the
    initial quad row's UVLC modes imply, which the 64-bit decoder's u_q
    extension subtracts."""
    key = str(device)
    if key not in _BIAS:
        _BIAS[key] = torch.as_tensor(
            get_tables()['dec_uvlc0_bias'].astype(np.int64), device=device)
    return _BIAS[key]


def srl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int64-held uint64 patterns; 0 for n >= 64."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    k = n.clamp(1, 63)
    r = (x >> k) & ~(torch.full_like(k, -1) << (64 - k))
    return torch.where(n <= 0, x, torch.where(n >= 64, 0, r))


def shl(v: torch.Tensor, n, bits: int = 64) -> torch.Tensor:
    """Left shift in a ``bits``-wide unsigned word (int64-held); 0 for n
    outside [0, bits - 1], as the JAX package's uint32 shifts give."""
    n = torch.as_tensor(n, dtype=torch.int64, device=v.device)
    r = v << n.clamp(0, bits - 1)
    if bits == 32:
        r = r & _MASK32
    return torch.where((n >= 0) & (n < bits), r, 0)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64-held uint64 patterns (x != 0)."""
    hi = srl(x, 32)
    return torch.where(hi != 0, _clz32(hi.clamp(min=1)),
                       32 + _clz32((x & _MASK32).clamp(min=1)))


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
    if mask.device.type == 'cpu' and not bool(mask.any()):
        # no lane decodes a run: skip the ops (a host-side test, so on
        # the CPU only; on a card it would cost a sync a call)
        return run, mel_k
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


def _step1(mel_w, vlc_w, qw: int, qh: int, wide: bool = False):
    """MEL, VLC and UVLC of every quad row (decoder32.cpp:855-1088; the
    JAX package's _step1), one pair of quads per loop step; ``wide``
    adds the 64-bit decoder's u_q extension.  Returns (inf, u) int64
    [N, qh, qw]: each quad's VLC record and its u."""
    dev = mel_w.device
    n = mel_w.shape[0]
    vlc_tbl, uvlc_tbl, mel_e = tables(dev)
    bias_tbl = uvlc_bias(dev) if wide else None
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    true = torch.ones(n, dtype=torch.bool, device=dev)

    mel, vlc = _Reader(mel_w), _Reader(vlc_w)
    # run = mel.get_run() before the quad loop (decoder32.cpp:862)
    mel.refill()
    run, mel_k = _mel_get_run(true, mel, zero, zero, mel_e)
    inf_prev = [zero] * (qw + 2)
    infs, us = [], []
    for r in range(qh):
        initial = r == 0
        tbl_base = 0 if initial else 1024
        ubase = 0 if initial else 320
        inf_cur = [zero] * (qw + 2)
        u_cur = [zero] * qw
        c_q = zero
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
            if second:
                t1 = vlc_tbl[(tbl_base + c_q + (vlc.peek() & 0x7F))
                             .clamp(0, 2047)]
                cz1 = c_q == 0
                run = torch.where(cz1, run - 2, run)
                t1 = torch.where(cz1 & (run != -1), zero, t1)
                run, mel_k = _mel_get_run(cz1 & (run < 0), mel, mel_k,
                                          run, mel_e)
                inf_cur[qx2 + 1] = t1
            else:
                t1 = zero
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
            u_idx = ubase + uvlc_mode + (vlc.peek() & 0x3F)
            ue = uvlc_tbl[u_idx.clamp(0, 575)]
            vlc.adv(ue & 7)
            ue = ue >> 3
            tmp = vlc.take(ue & 0xF)
            ue = ue >> 4
            len0 = ue & 7
            ue = ue >> 3
            kappa0 = 1 if initial else 0
            u0 = kappa0 + (ue & 7) + (tmp & (~(0xFF << len0) & _MASK32))
            u1 = kappa0 + (ue >> 3) + (tmp >> len0)
            if wide:
                # u_q past 32: four more bits each, u0's first
                # (decoder64.cpp:1000-1010, 1122-1132); the pair may
                # then read more than one refill's 32 bits
                bias = (bias_tbl[u_idx.clamp(0, 319)] if initial
                        else zero)
                vlc.refill()
                ext = (u0 - kappa0) - (bias & 3) > 32
                u0 = u0 + torch.where(ext, (vlc.peek() & 0xF) << 2, 0)
                vlc.adv(torch.where(ext, 4, 0))
                vlc.refill()
                ext = (u1 - kappa0) - (bias >> 2) > 32
                u1 = u1 + torch.where(ext, (vlc.peek() & 0xF) << 2, 0)
                vlc.adv(torch.where(ext, 4, 0))
            u_cur[qx2] = u0
            if second:
                u_cur[qx2 + 1] = u1
        inf_prev = inf_cur
        infs.append(torch.stack(inf_cur[:qw], dim=1))
        us.append(torch.stack(u_cur, dim=1))
    return torch.stack(infs, dim=1), torch.stack(us, dim=1)


def _step2(ms_w, inf, u, p, width: int, qh_lim, bits: int = 32):
    """MagSgn of every quad row (decoder32.cpp:1089-1316; the JAX
    package's _step2), one loop step per quad row, vectorised over lanes
    and quads: each sample's bit count m_n, an exclusive prefix sum of
    the counts for its bit offset, and a gather of the words at each
    offset.  ``bits`` = 64: decoder64's samples, up to 64 MagSgn bits
    each.  Returns (dec int64 [N, 2qh, 2qw] uint32 values, or uint64
    patterns, err bool [N], set where U_q > missing_msbs + 2 on a row
    below qh_lim)."""
    dev = ms_w.device
    n, qh, qw = inf.shape
    wide = bits == 64
    ms = ms_w.to(torch.int64) & _MASK32
    last = ms.shape[1] - 1
    p = p.to(torch.int64)
    mmsbp2 = ((bits - p) & _MASK32)[:, None]
    sh = (p - 1)[:, None, None]
    qhl = qh_lim.to(torch.int64)
    bit = torch.arange(4, device=dev)
    # sample `bit` of quad qx is column 2qx + (bit >> 1): the right column
    # exists only where 2qx + 1 < width
    two_cols = (2 * torch.arange(qw, device=dev) + 1) < width
    col_ok = (bit < 2)[None, :] | two_cols[:, None]            # [qw, 4]
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    base = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    scr = torch.zeros((n, qw + 1), dtype=torch.int64, device=dev)
    rows = []
    for r in range(qh):
        q_inf, u_q = inf[:, r], u[:, r]                         # [N, qw]
        if r == 0:
            U_q = u_q
        else:
            gamma = q_inf & 0xF0
            gamma = gamma & ((gamma - 0x10) & _MASK32)
            e_or = scr[:, :qw] | scr[:, 1:] | 2
            emax = 63 - clz64(e_or) if wide else 31 - _clz32(e_or)
            U_q = (u_q + torch.where(gamma != 0, emax, 1)) & _MASK32
        err = err | ((U_q > mmsbp2).any(1) & (r < qhl))
        q4 = q_inf[:, :, None]
        sig = (((q4 >> (4 + bit)) & 1) != 0) & col_ok
        m_n = torch.where(sig, _i32((U_q[:, :, None] - ((q4 >> (12 + bit))
                                                         & 1)) & _MASK32),
                          0).clamp(0, bits - 1)
        flat = m_n.reshape(n, qw * 4)
        pos = base + torch.cumsum(flat, 1) - flat
        base = base + flat.sum(1, keepdim=True)
        k = pos >> 5
        s = pos & 31
        w0 = torch.gather(ms, 1, k.clamp(max=last))
        w1 = torch.gather(ms, 1, (k + 1).clamp(max=last))
        if wide:
            # 64 bits at offset s: three words, shifts wrapping mod 2**64
            w2 = torch.gather(ms, 1, (k + 2).clamp(max=last))
            win = ((w0 >> s) | (w1 << (32 - s)) | shl(w2, 64 - s)) \
                .reshape(n, qw, 4)
            v_n = ((win & ~(torch.full_like(m_n, -1) << m_n))
                   | (((q4 >> (8 + bit)) & 1) << m_n) | 1)
            v_n = torch.where(sig, v_n, 0)
            val = (win << 63) | shl(v_n + 2, sh)
        else:
            win = (((w0 >> s) | (w1 << (32 - s))) & _MASK32) \
                .reshape(n, qw, 4)
            v_n = ((win & ((1 << m_n) - 1))
                   | (((q4 >> (8 + bit)) & 1) << m_n) | 1)
            v_n = torch.where(sig, v_n, 0)
            val = ((win << 31) | shl((v_n + 2) & _MASK32, sh, 32)) \
                & _MASK32
        rows.append(torch.where(sig, val, 0))
        # the next row's exponents: scr[qx] = v_n3(qx - 1) | v_n1(qx)
        scr = torch.zeros((n, qw + 1), dtype=torch.int64, device=dev)
        scr[:, :qw] = v_n[:, :, 1]
        scr[:, 1:] |= v_n[:, :, 3]
    # [N, qh, qw, (col, row)] -> [N, 2qh, 2qw]
    v = torch.stack(rows, dim=1).reshape(n, qh, qw, 2, 2)
    return v.permute(0, 1, 4, 2, 3).reshape(n, qh * 2, qw * 2), err


def decode_cleanup_core(mel_w, vlc_w, ms_w, p, width: int, height: int,
                        qh_lim=None, bits: int = 32):
    """Decode N same-shape cleanup segments from dense word rows
    (melw/vlcw/msw [N, W*]), p = 30 - missing_msbs [N] (``bits`` = 64:
    62 - missing_msbs) and the per-lane quad-row limit qh_lim [N]
    (None: every row).  Returns (dec int32 [N, height, width], or int64
    with ``bits`` = 64, err bool [N])."""
    dev = mel_w.device
    n = mel_w.shape[0]
    qw = (width + 1) >> 1
    qh = (height + 1) >> 1
    if qh_lim is None:
        qh_lim = torch.full((n,), qh, dtype=torch.int64, device=dev)
    inf, u = _step1(mel_w, vlc_w, qw, qh, wide=bits == 64)
    dec, err = _step2(ms_w, inf, u, p, width, qh_lim, bits)
    dec = dec[:, :height, :width]
    live = (torch.arange(height, device=dev)[None, :]
            < 2 * qh_lim.to(torch.int64)[:, None])[:, :, None]
    dec = torch.where(live, dec, torch.zeros_like(dec))
    if bits == 32:
        return to_i32_bits(dec), err
    # missing_msbs >= 62: "64 bits insufficient" (decoder64), a zero
    # block flagged, as in the kernel
    bad = p.to(torch.int64) < 1
    return torch.where(bad[:, None, None], 0, dec), err | bad


def _i32(x):
    """uint32 values (int64) -> their signed int32 reading (int64)."""
    return x - ((x >> 31) << 32)


def _clz32(x):
    """Leading zeros of uint32 values (x > 0) held in int64."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << (32 - s))
        x = torch.where(big, x, x << s)
        n = torch.where(big, n, n + s)
    return n
