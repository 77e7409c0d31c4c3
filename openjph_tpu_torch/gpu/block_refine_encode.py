"""Plain PyTorch version of the HT refinement-pass encoder, SigProp and
MagRef (K5): N same-width codeblocks coded at once, vectorised over the
lanes.

It is the JAX package's coding/encoder.py::encode_spp_mrp (which that
package runs on its host, once a codeblock), batched over the lanes of
an encode lane group: the cleanup significance packed 4 bits a column
per 4x4 group (``_pack_sig``, the layout of block_refine.sig_pack);
SigProp's chain over the stripes and groups with its ``_SPP_SPREAD``,
``prev`` and ``u`` terms and the stripe-causal gate, each group's 16
candidate decisions one tensor step each; the decision bits, then the
signs of the samples that turned significant, as each group's two
records; MagRef's bit per cleanup-significant sample, in pairs of
groups.  The records are packed LSB-first into dense words
(block_encode.pack_records), and both packers' stuffing runs as a loop
over output bytes with per-lane state: SigProp is ``_SppEncoder`` (MagSgn
stuffing, 7 bits after an 0xFF, zero fill, no 0xFF tail), MagRef
``_MrpEncoder`` (the VLC rule, its ``last_greater_than_8F`` starting
true) with its bytes reversed into file order.

It is the reference the CUDA kernel (csrc/ht_refine_encode.cu) is held
against and the path CPU tensors take; it is not fast.  uint32
quantities are held in int64 tensors.

Contract, the kernel's: ``buf`` int32 [N, hp, wp] holding uint32
sign-magnitude samples (sign in bit 31), zero-padded, as the cleanup
encoder takes them; ``p`` [N] the cleanup's LSB plane (30 -
missing_msbs: SigProp and MagRef code plane p - 1), ``h_lim`` [N] the
lane's true height (rows at or past it are not part of the codeblock),
``npasses`` [N] (below 2: no refinement segment; 2: SigProp; 3: SigProp
and MagRef), ``causal`` one flag for the batch (the stripe-causal COD
mode); ``width`` the lanes' true width, ``height`` the group's height
(at least every h_lim), ``cap`` words a lane.  Returns (``out`` int32
[N, cap]: each lane's segment, the SigProp bytes then the MagRef bytes,
four bytes a word in memory order, zero past its length; ``lens`` int32
[N, 2]: the SigProp and MagRef byte counts; ``ovf`` bool [N]: set where
the segment needs more than ``cap`` words, whose bytes past the cap are
dropped).
"""
from __future__ import annotations

import torch

from .block_decode import to_i32_bits
from .block_encode import pack_records
from .block_refine import SPREAD_POS, _popcount, sig_pack

_MASK31 = 0x7FFFFFFF


def cap_words(width: int, height: int) -> int:
    """Words a lane's segment can need: SigProp codes at most two bits a
    sample and MagRef one, and stuffing puts at least 7 bits in a byte;
    two bytes spare each."""
    n = width * height
    return -(-(-(-2 * n // 7) + 2 + -(-n // 7) + 2) // 4)


def _pext(val, mask, nbit: int):
    """The bits of ``val`` at the set bits of ``mask`` (nbit wide),
    gathered LSB-first, and their count: the order in which the coders
    emit a group's bits."""
    ar = torch.arange(nbit, device=val.device)
    has = (mask[..., None] >> ar) & 1
    rank = _popcount(mask[..., None] & ((1 << ar) - 1))
    bit = (val[..., None] >> ar) & has
    return (bit << rank).sum(-1), _popcount(mask)


def _spp_decisions(sig, bitw, h_lim, do_spp, causal: bool, width: int,
                   n_sy: int, n_gx: int):
    """SigProp's chain (encode_spp_mrp's first pass): per group, the
    samples it visits and those that turn significant, [N, n_sy, n_gx]
    each, as 16-bit masks in the group's bit order (4*col + row)."""
    n = sig.shape[0]
    dev = sig.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    cs_all = sig[:, :, :-1] | (sig[:, :, 1:] << 16)
    prow = torch.zeros((n, n_gx + 1), dtype=torch.int64, device=dev)
    visited, newsig = [], []
    for sy in range(n_sy):
        rl = h_lim - 4 * sy
        pattern0 = torch.where(
            rl >= 4, 0xFFFF, torch.where(
                rl == 3, 0x7777, torch.where(
                    rl == 2, 0x3333, torch.where(rl == 1, 0x1111, 0))))
        pattern0 = torch.where(do_spp, pattern0, 0)
        prev = zero
        for gx in range(n_gx):
            pattern = pattern0 >> (4 * max(4 * gx + 4 - width, 0))
            cs, ns = cs_all[:, sy, gx], cs_all[:, sy + 1, gx]
            ps = prow[:, gx] | (prow[:, gx + 1] << 16)
            u = (ps & 0x88888888) >> 3
            if not causal:
                u = u | ((ns & 0x11111111) << 3)
            mbr = cs | ((cs & 0x77777777) << 1) | ((cs & 0xEEEEEEEE) >> 1)
            mbr = mbr | u
            mbr = mbr | (mbr << 4) | (mbr >> 4)
            mbr = mbr | (prev >> 12)
            new_sig = mbr & pattern & ~cs
            inv_sig = ~cs & pattern
            bw = bitw[:, sy, gx]
            seen = zero
            # the candidates in order, each decision spreading new
            # candidates forward within the group
            for pos in range(16):
                take = (new_sig >> pos) & 1
                seen = seen | (take << pos)
                hit = (take & (bw >> pos)) != 0
                new_sig = new_sig & ~(1 << pos)
                new_sig = torch.where(hit, new_sig | (SPREAD_POS[pos]
                                                      & inv_sig), new_sig)
            visited.append(seen)
            newsig.append(new_sig)
            new_sig = new_sig | cs
            prow[:, gx] = new_sig & 0xFFFF
            tt = new_sig & 0xFFFF
            n16 = tt | ((tt & 0x7777) << 1) | ((tt & 0xEEEE) >> 1)
            prev = (n16 | u) & 0xF000
    shape = (n_sy, n_gx, n)
    return (torch.stack(visited).reshape(shape).permute(2, 0, 1),
            torch.stack(newsig).reshape(shape).permute(2, 0, 1))


def _stuff(words, nbits, mrp: bool):
    """Stuffed bytes of LSB-first bit rows, in emission order: a byte
    takes the next 8 bits, or 7 where the rule says so (SigProp: after
    an 0xFF byte; MagRef: where the last byte was above 0x8F, or is the
    first, and the next 7 bits are all ones); a partial last byte is
    kept, zero-filled.  Returns (bytes [N, B] int64, counts [N])."""
    n = words.shape[0]
    dev = words.device
    w = torch.cat([words, torch.zeros((n, 2), dtype=torch.int64,
                                      device=dev)], 1)
    steps = -(-int(nbits.max()) // 7) if n else 0
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros_like(pos)
    # SigProp: the last byte; MagRef: last_greater_than_8F
    last = torch.ones(n, dtype=torch.bool, device=dev) if mrp \
        else torch.zeros_like(pos)
    out = []
    for _ in range(steps):
        live = pos < nbits
        wi = (pos >> 5)[:, None]
        win = ((w.gather(1, wi) | (w.gather(1, wi + 1) << 32))[:, 0]
               >> (pos & 31)) & 0xFF
        if mrp:
            seven = last & ((win & 0x7F) == 0x7F)
        else:
            seven = last == 0xFF
        byte = torch.where(seven, win & 0x7F, win)
        out.append(torch.where(live, byte, 0))
        cnt = cnt + live
        if mrp:
            last = torch.where(live, byte > 0x8F, last)
        else:
            last = torch.where(live, byte, last)
        pos = pos + torch.where(live, torch.where(seven, 7, 8), 0)
    if not out:
        return torch.zeros((n, 0), dtype=torch.int64, device=dev), cnt
    return torch.stack(out, 1), cnt


def encode_refine_core(buf, p, h_lim, npasses, causal: bool, width: int,
                       height: int, cap: int):
    """SigProp and MagRef segments of N codeblocks (see the module
    docstring for the contract)."""
    n, hp, wp = buf.shape
    dev = buf.device
    n_sy = (height + 3) >> 2
    n_gx = (width + 3) >> 2
    h_lim = h_lim.to(torch.int64)
    npasses = npasses.to(torch.int64)
    do_spp = npasses >= 2
    do_mrp = npasses >= 3
    t = buf.to(torch.int64) & 0xFFFFFFFF
    inside = (torch.arange(hp, device=dev)[None, :, None] < h_lim[:, None,
                                                                  None]) \
        & (torch.arange(wp, device=dev)[None, None, :] < width)
    mag = torch.where(inside, t & _MASK31, 0)
    pu = p.to(torch.int64).clamp(1, 31)[:, None, None]
    t, wt = t[:, :, :width], mag[:, :, :width]
    sig = sig_pack(wt >> pu, n_sy, n_gx, h_lim)
    bitw = sig_pack((wt >> (pu - 1)) & 1, n_sy, n_gx, h_lim)
    sgnw = sig_pack(t >> 31, n_sy, n_gx, h_lim)

    # ---- SigProp: per group its decision bits, then its signs ----------
    seen, new = _spp_decisions(sig, bitw, h_lim, do_spp, causal, width,
                               n_sy, n_gx)
    dv, dl = _pext(bitw[:, :n_sy, :n_gx], seen, 16)
    sv, sl = _pext(sgnw[:, :n_sy, :n_gx], new, 16)
    vals = torch.stack([dv, sv], -1).reshape(n, -1).T
    lens = torch.stack([dl, sl], -1).reshape(n, -1).T
    spp_bits = lens.sum(0)
    spp_w, _, _ = pack_records(vals, lens, -(-int(spp_bits.max()) // 32)
                               + 1 if n else 1)
    spp, spp_n = _stuff(spp_w, spp_bits, mrp=False)

    # ---- MagRef: a bit per cleanup-significant sample, pairs of groups --
    n_g2 = (n_gx + 1) // 2
    sig32 = sig[:, :n_sy, 0:2 * n_g2:2] | (sig[:, :n_sy, 1:2 * n_g2 + 1:2]
                                          << 16)
    bit32 = bitw[:, :n_sy, 0:2 * n_g2:2] \
        | (bitw[:, :n_sy, 1:2 * n_g2 + 1:2] << 16)
    sig32 = torch.where(do_mrp[:, None, None], sig32, 0)
    mv, ml = _pext(bit32, sig32, 32)
    mrp_bits = ml.reshape(n, -1).sum(1)
    mrp_w, _, _ = pack_records(mv.reshape(n, -1).T, ml.reshape(n, -1).T,
                               -(-int(mrp_bits.max()) // 32) + 1
                               if n else 1)
    mrp, mrp_n = _stuff(mrp_w, mrp_bits, mrp=True)

    # ---- the segment: SigProp bytes, then MagRef's in file order --------
    nb = cap * 4
    at = torch.arange(nb, device=dev)[None, :]
    sp_i = at.clamp(max=max(spp.shape[1] - 1, 0)).expand(n, nb)
    mr_i = (spp_n[:, None] + mrp_n[:, None] - 1 - at).clamp(
        0, max(mrp.shape[1] - 1, 0))
    seg = torch.zeros((n, nb), dtype=torch.int64, device=dev)
    if spp.shape[1]:
        seg = torch.where(at < spp_n[:, None], spp.gather(1, sp_i), seg)
    if mrp.shape[1]:
        in_mrp = (at >= spp_n[:, None]) & (at < (spp_n + mrp_n)[:, None])
        seg = torch.where(in_mrp, mrp.gather(1, mr_i), seg)
    seg = seg.reshape(n, cap, 4)
    words = seg[..., 0] | (seg[..., 1] << 8) | (seg[..., 2] << 16) \
        | (seg[..., 3] << 24)
    lens_out = torch.stack([spp_n, mrp_n], 1)
    return (to_i32_bits(words), lens_out.to(torch.int32),
            (spp_n + mrp_n) > nb)
