"""Plain PyTorch version of the HT refinement passes, SigProp and MagRef
(ojph_block_decoder32.cpp:1318-1611), over N same-shape codeblocks at
once: the JAX package's tpu/block_refine.py::refine_core op for op, on
int64 tensors holding uint32 values, as gpu/block_decode.py holds the
cleanup pass.  It is the reference the CUDA kernel
(csrc/ht_refine_decode.cu) is held against and the path CPU tensors
take; it is not fast.

SigProp walks the 4-row stripes of a block and the 4x4 groups of each
stripe in raster order, one loop step per group over the [N] lanes;
inside a step the 16 candidate decisions run in order, each one a few
tensor ops (a decision spreads new candidates forward within the
group).  MagRef reads one bit per cleanup-significant sample, 32 samples
(two groups) a step.  Both read dense LSB-first word rows: SigProp the
refinement segment forward with zero fill, MagRef backward with its own
unstuffing (native.prep_refine_streams, or unstuff.raw_refine_to_dense
on the device's raw blob).

A 64-bit ``dec`` (int64 holding uint64 patterns, decoder64's samples
for more than 30 bit planes) is refined with the sign in bit 63 and p =
62 - missing_msbs; nothing else differs.

Lanes are gated one by one: ``npasses`` (SigProp from 2, MagRef at 3),
``h_lim`` (rows at or past a lane's true height neither consume bits nor
change samples, so height-merged groups work) and ``causal`` (the
stripe-causal COD flag 0x8 of the lane's component).
"""
from __future__ import annotations

import numpy as np
import torch

from .block_decode import _MASK32, _Reader, shl, to_i32_bits

# spread[k] per row k of a column: the neighbours (same column rows
# k..k+1 and next column rows k-1..k+1, plus the sample itself) that
# become SigProp candidates when sample k turns significant
# (ojph_block_decoder32.cpp:1452-1474)
_SPREAD = (0x33, 0x76, 0xEC, 0xC8)
# the candidate-spread mask of group bit position pos = 4*col + row
SPREAD_POS = tuple(_SPREAD[pos & 3] << (pos & ~3) for pos in range(16))

_POPC16 = {}


def _popcount(x):
    """Population count of uint32 values held in int64 (a 16-bit table,
    kept per device)."""
    key = str(x.device)
    if key not in _POPC16:
        a = np.arange(1 << 16, dtype=np.uint32)
        c = np.zeros_like(a)
        for k in range(16):
            c += (a >> k) & 1
        _POPC16[key] = torch.from_numpy(c.astype(np.int64)).to(x.device)
    t = _POPC16[key]
    return t[x & 0xFFFF] + t[(x >> 16) & 0xFFFF]


def sig_pack(dec, n_sy: int, n_gx: int, h_lim):
    """Cleanup significance as int64 [N, n_sy+1, n_gx+1]: bit
    (4*col+row) of entry (sy, gx) is sample (4sy+row, 4gx+col) != 0,
    for rows below the lane's ``h_lim``; one zero row and column pad
    the neighbour reads (ojph_block_decoder32.cpp:1333-1356)."""
    n, h, w = dec.shape
    dev = dec.device
    rows_ok = (torch.arange(h, device=dev)[None, :, None]
               < h_lim.to(torch.int64)[:, None, None])
    nz = (dec != 0) & rows_ok
    hp, wp = n_sy * 4, n_gx * 4
    nz = torch.nn.functional.pad(nz, (0, wp - w, 0, hp - h))
    yy = torch.arange(hp, device=dev) % 4
    xx = torch.arange(wp, device=dev) % 4
    wgt = torch.ones((), dtype=torch.int64, device=dev) \
        << (xx[None, :] * 4 + yy[:, None])
    contr = torch.where(nz, wgt[None], torch.zeros_like(wgt[None]))
    sig = contr.reshape(n, n_sy, 4, n_gx, 4).sum(dim=(2, 4))
    return torch.nn.functional.pad(sig, (0, 1, 0, 1))


def _sigprop(dec, spp_w, sig, p, h_lim, causal, do_spp, width: int,
             height: int, n_sy: int, n_gx: int, bits: int = 32):
    """Significance propagation over the cleanup output ``dec`` (int64
    uint32 values, or uint64 patterns with ``bits`` = 64, [N, height,
    width]); ojph_block_decoder32.cpp:1358-1556."""
    n = dec.shape[0]
    dev = dec.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    cs_all = sig[:, :, :-1] | (sig[:, :, 1:] << 16)
    val16 = shl(torch.full_like(p, 3), p - 2, bits)
    h_lim = h_lim.to(torch.int64)
    ar16 = torch.arange(16, device=dev)
    masks16 = (1 << ar16) - 1
    rd = _Reader(spp_w)
    prow = torch.zeros((n, n_gx + 1), dtype=torch.int64, device=dev)
    vals = []
    for sy in range(n_sy):
        prev = zero
        rl = h_lim - 4 * sy
        pattern0 = torch.where(
            rl >= 4, 0xFFFF, torch.where(
                rl == 3, 0x7777, torch.where(
                    rl == 2, 0x3333, torch.where(rl == 1, 0x1111, 0))))
        for gx in range(n_gx):
            shift = 4 * max(4 * gx + 4 - width, 0)
            cs, ns = cs_all[:, sy, gx], cs_all[:, sy + 1, gx]
            pattern = torch.where(do_spp, pattern0 >> shift, 0)
            ps = prow[:, gx] | (prow[:, gx + 1] << 16)
            u = (ps & 0x88888888) >> 3
            u = torch.where(causal, u, u | ((ns & 0x11111111) << 3))
            mbr = cs
            mbr = mbr | ((cs & 0x77777777) << 1)
            mbr = mbr | ((cs & 0xEEEEEEEE) >> 1)
            mbr = mbr | u
            mbr = mbr | (mbr << 4) | (mbr >> 4)
            mbr = mbr | (prev >> 12)
            mbr = mbr & pattern & ~cs
            new_sig = mbr
            inv_sig = ~cs & pattern

            rd.refill()
            cwd = rd.peek()
            cnt = zero
            # candidate loop: bit-serial over the 16 group samples, each
            # decision spreading new candidates forward within the group
            for pos in range(16):
                take = (new_sig >> pos) & 1
                setb = (take & cwd & 1) != 0
                new_sig = new_sig & (~(1 << pos) & _MASK32)
                new_sig = torch.where(
                    setb, new_sig | (SPREAD_POS[pos] & inv_sig), new_sig)
                cwd = torch.where(take != 0, cwd >> 1, cwd)
                cnt = cnt + take
            # sign read: the next popcount(new_sig) bits, one per newly
            # significant sample in position order
            pc = _popcount(new_sig[:, None] & masks16[None, :])
            newly = ((new_sig[:, None] >> ar16[None, :]) & 1) != 0
            sgn = (cwd[:, None] >> pc) & 1
            vals.append(torch.where(newly, (sgn << (bits - 1))
                                    | val16[:, None], 0))
            rd.adv(cnt + _popcount(new_sig))

            new_sig = new_sig | cs
            prow[:, gx] = new_sig & 0xFFFF
            tt = new_sig & 0xFFFF
            n16 = tt | ((tt & 0x7777) << 1) | ((tt & 0xEEEE) >> 1)
            prev = (n16 | u) & 0xF000
    # [steps, N, 16] with bit order 4*col+row -> [N, 4*n_sy, 4*n_gx]
    v = torch.stack(vals).reshape(n_sy, n_gx, n, 4, 4)
    full = v.permute(2, 0, 4, 1, 3).reshape(n, n_sy * 4, n_gx * 4)
    full = full[:, :height, :width]
    return torch.where(full != 0, full, dec)


def _magref(dec, mrp_w, sig, p, do_mrp, width: int, height: int,
            n_sy: int, n_gx: int, bits: int = 32):
    """Magnitude refinement (ojph_block_decoder32.cpp:1564-1610): one
    bit per cleanup-significant sample, XORed into bits p-1 / p-2."""
    n = dec.shape[0]
    dev = dec.device
    n_g2 = (n_gx + 1) // 2
    sig32_all = sig[:, :n_sy, 0:2 * n_g2:2] \
        | (sig[:, :n_sy, 1:2 * n_g2 + 1:2] << 16)
    half = shl(torch.ones_like(p), p - 2, bits)
    upper = shl(torch.ones_like(p), p - 1, bits)
    ar32 = torch.arange(32, device=dev)
    masks32 = (1 << ar32) - 1
    rd = _Reader(mrp_w)
    xors = []
    for sy in range(n_sy):
        for g2 in range(n_g2):
            sig32 = torch.where(do_mrp, sig32_all[:, sy, g2], 0)
            rd.refill()
            cwd = rd.peek()
            pc = _popcount(sig32[:, None] & masks32[None, :])
            has = ((sig32[:, None] >> ar32[None, :]) & 1) != 0
            sym = (cwd[:, None] >> pc) & 1
            v = torch.where(sym != 0, half[:, None],
                            upper[:, None] | half[:, None])
            xors.append(torch.where(has, v, 0))
            rd.adv(_popcount(sig32))
    # [steps, N, 32] with bit order 4*col+row over 8 columns
    v = torch.stack(xors).reshape(n_sy, n_g2, n, 8, 4)
    full = v.permute(2, 0, 4, 1, 3).reshape(n, n_sy * 4, n_g2 * 8)
    return dec ^ full[:, :height, :width]


def refine_core(dec, spp_w, mrp_w, p, npasses, h_lim, causal, width: int,
                height: int):
    """Apply SigProp (npasses >= 2) and MagRef (npasses == 3) to the
    cleanup output ``dec`` (int32 [N, height, width] holding uint32 bit
    patterns, or int64 holding uint64 ones).  spp_w / mrp_w: dense word
    rows [N, W*]; p = 30 - missing_msbs (int64 ``dec``: 62 -
    missing_msbs), npasses, h_lim [N] ints; causal [N] (nonzero: the
    stripe-causal mode).  Returns the refined [N, height, width] of
    ``dec``'s dtype; ``dec`` is not modified."""
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2
    p = p.to(torch.int64)
    do_spp = npasses >= 2
    do_mrp = npasses >= 3
    causal = causal != 0
    bits = 64 if dec.dtype == torch.int64 else 32
    d = dec if bits == 64 else dec.to(torch.int64) & _MASK32
    sig = sig_pack(d, n_sy, n_gx, h_lim)
    out = _sigprop(d, spp_w, sig, p, h_lim, causal, do_spp, width, height,
                   n_sy, n_gx, bits)
    out = _magref(out, mrp_w, sig, p, do_mrp, width, height, n_sy, n_gx,
                  bits)
    out = torch.where(do_spp[:, None, None], out, d)
    return out if bits == 64 else to_i32_bits(out)
