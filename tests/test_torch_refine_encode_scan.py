"""A numpy model of the refinement-pass encoder's scans (K5,
gpu/csrc/ht_refine_encode.cu) held to its plain version
(gpu/block_refine_encode.py: _spp_decisions, _stuff, encode_refine_core)
and to the JAX package's coding/encoder.py::encode_spp_mrp.

The kernel runs on the card only.  Its serial parts are warp scans of
maps over 16 states: SigProp's decisions, a stripe at a time, as
OR-affine maps of the 4-bit spread a column passes to the next (a 20-bit
word: nibble j the image of e_j, nibble 4 the image of 0), walked by a
lane over the groups it owns and scanned across the lanes that own
groups; both packers' stuffing as nibble tables of a 64-bit chunk's 16
entry states (the first byte's offset, the flag of the byte before),
each state stepped from stuffing event to stuffing event (held here to
byte-by-byte walks), scanned across the lanes that own chunks, then
replayed.  The model
mirrors the kernel's lanes, ownership, word layouts, scans and replays,
so a fault in the scheme shows here, not first on the card.
"""
import numpy as np
import pytest
import torch

from openjph_tpu.coding.encoder import _SPP_SPREAD, encode_spp_mrp

from openjph_tpu_torch.gpu import block_refine_encode as P

from test_torch_multipass_encode import K5_SHAPES, _lanes

SPREAD_ID = 0x08421
STATE_ID = 0xFEDCBA9876543210
LANES = 32


def _warp_scan(xs, live, op):
    """warp_scan: Kogge-Stone over lanes 0..live-1, each step reading the
    lanes' values of the step before; op(a, b) is a then b."""
    xs = list(xs)
    o = 1
    while o < live:
        xs = [op(xs[i - o], x) if i >= o else x for i, x in enumerate(xs)]
        o <<= 1
    return xs


def _add(a, b):
    return a + b


def _popc(x):
    x = np.asarray(x, np.int64)
    return sum((x >> k) & 1 for k in range(32))


def _pext16_ref(v, m):
    """The bits of v at the set bits of m (16 wide), from bit 0, a bit at
    a time."""
    r = np.zeros(np.broadcast(v, m).shape, np.int64)
    k = np.zeros_like(r)
    for b in range(16):
        on = (m >> b) & 1
        r |= ((v >> b) & on) << k
        k += on
    return r


def _pext16(v, m):
    """pext16: the same gather in four branch-free rounds (Hacker's
    Delight's compress), on 32-bit words."""
    v = v & m
    mk = (~m << 1) & 0xFFFFFFFF
    for i in range(4):
        mp = mk ^ ((mk << 1) & 0xFFFFFFFF)
        for sh in (2, 4, 8):
            mp = mp ^ ((mp << sh) & 0xFFFFFFFF)
        mv = mp & m
        m = (m ^ mv) | (mv >> (1 << i))
        t = v & mv
        v = (v ^ t) | (t >> (1 << i))
        mk = mk & ~mp
    return v


# ---------------------------------------------------------------------------
# SigProp's decisions: OR-affine maps of a column's incoming spread
# ---------------------------------------------------------------------------

def _spread_then(f, g):
    """SpreadThen: f then g."""
    r = ((g >> 16) & 0xF) * 0x11111
    for j in range(4):
        r = r | ((((f >> j) & 0x11111) * 0xF)
                 & (((g >> (4 * j)) & 0xF) * 0x11111))
    return r


def _col5(st, c, a):
    """One column (candidates c, visitable plane-bit-1 positions a, 4
    bits each) applied to five packed spreads: two fill steps, as the
    spread of the second's rows covers what a third would add."""
    a5 = a * 0x11111
    a1 = a5 & 0xEEEEE
    s = a5 & ((c * 0x11111) | st)
    for _ in range(2):
        s = s | ((s << 1) & a1)
    return s | ((s & 0x77777) << 1) | ((s & 0xEEEEE) >> 1)


def _col(sp, c, inv, a):
    """One column from its true incoming spread: (spread passed on,
    visited, new)."""
    s = a & (c | sp)
    for _ in range(3):
        s = s | ((s << 1) & a)
    vis = inv & (c | sp | (s << 1)) & 0xF
    return (s | (s << 1) | (s >> 1)) & 0xF, vis, s


def _nib(x, i):
    return (x >> (4 * i)) & 0xF


def _walk5(st, c, a):
    for i in range(4):
        st = _col5(st, _nib(c, i), _nib(a, i))
    return st


def _walk(sp, c, inv, a):
    vis = nw = 0
    for i in range(4):
        sp, v, s = _col(sp, _nib(c, i), _nib(inv, i), _nib(a, i))
        vis = vis | (v << (4 * i))
        nw = nw | (s << (4 * i))
    return sp, vis, nw


def _apply(f, sp):
    """An OR-affine map applied to the spread sp."""
    r = (f >> 16) & 0xF
    for j in range(4):
        r = r | np.where((sp >> j) & 1, _nib(f, j), 0)
    return r


def _cols6(lft, mid, rgt):
    return (lft >> 12) | (mid << 4) | ((rgt & 0xF) << 20)


def _group_in(sig, bs, vn, sy, g, pattern0, width, causal):
    """group_in: (candidates, inv, a) of group g of stripe sy; sig [N,
    n_sy + 1, n_gx + 2] and vn [N, n_sy, n_gx + 2] hold group g at g + 1,
    bs [N, n_sy, n_gx]."""
    cs = sig[:, sy, g + 1]
    cs24 = _cols6(sig[:, sy, g], cs, sig[:, sy, g + 2])
    u24 = 0
    if sy > 0:
        fin = sig[:, sy - 1] | (vn[:, sy - 1] >> 16)
        u24 = (_cols6(fin[:, g], fin[:, g + 1], fin[:, g + 2])
               & 0x888888) >> 3
    if not causal:
        nr = sig[:, sy + 1]
        u24 = u24 | ((_cols6(nr[:, g], nr[:, g + 1], nr[:, g + 2])
                      & 0x111111) << 3)
    m24 = cs24 | ((cs24 & 0x777777) << 1) | ((cs24 & 0xEEEEEE) >> 1) | u24
    c = ((m24 | (m24 << 4) | (m24 >> 4)) >> 4) & 0xFFFF
    pattern = pattern0 >> (4 * max(4 * g + 4 - width, 0))
    inv = ~cs & pattern & 0xFFFF
    return c, inv, inv & bs[:, sy, g]


def _phase_a(buf, p, h_lim, width, n_sy, n_gx):
    """Phase A: (sig [N, n_sy + 1, n_gx + 2], bs [N, n_sy, n_gx]) from
    the samples, rows below min(h_lim, hp) and columns below width."""
    n, hp, wp = buf.shape
    v = np.zeros((n, 4 * n_sy, 4 * n_gx), np.int64)
    v[:, :hp, :wp] = buf.astype(np.int64)
    y = np.arange(4 * n_sy)[None, :, None]
    x = np.arange(4 * n_gx)[None, None, :]
    v = np.where((y < np.minimum(h_lim, hp)[:, None, None]) & (x < width),
                 v, 0)
    mag = v & 0x7FFFFFFF
    pp = np.clip(p, 1, 31).astype(np.int64)[:, None, None]
    planes = [(mag >> pp) != 0, (mag >> (pp - 1)) & 1, v >> 31]
    words = []
    for pl in planes:
        pl = pl.astype(np.int64).reshape(n, n_sy, 4, n_gx, 4)
        w = np.zeros((n, n_sy, n_gx), np.int64)
        for r in range(4):
            for c in range(4):
                w |= pl[:, :, r, :, c] << (4 * c + r)
        words.append(w)
    sig = np.zeros((n, n_sy + 1, n_gx + 2), np.int64)
    sig[:, :n_sy, 1:n_gx + 1] = words[0]
    return sig, words[1] | (words[2] << 16)


def _chain(sig, bs, h_lim, causal, width, n_sy, n_gx):
    """Phase C: vn [N, n_sy, n_gx + 2] (visited | new << 16), a stripe at
    a time, the lanes' maps scanned where more than one lane owns
    groups."""
    n = sig.shape[0]
    vn = np.zeros((n, n_sy, n_gx + 2), np.int64)
    gpl = -(-n_gx // LANES)
    live = -(-n_gx // gpl)
    own = [range(i * gpl, min(i * gpl + gpl, n_gx)) for i in range(LANES)]
    zero = np.zeros(n, np.int64)
    for sy in range(n_sy):
        rl = h_lim - 4 * sy
        pattern0 = np.select([rl >= 4, rl == 3, rl == 2, rl == 1],
                             [0xFFFF, 0x7777, 0x3333, 0x1111], 0)
        ins = [zero] * LANES
        if live > 1:
            maps = []
            for lane in range(LANES):
                m = np.full(n, SPREAD_ID, np.int64)
                for g in own[lane]:
                    c, _, a = _group_in(sig, bs, vn, sy, g, pattern0, width,
                                        causal)
                    m = _walk5(m, c, a)
                maps.append(m)
            maps = _warp_scan(maps, live, _spread_then)
            ins = [zero] + [(m >> 16) & 0xF for m in maps[:-1]]
        for lane in range(LANES):
            sp = ins[lane]
            for g in own[lane]:
                c, inv, a = _group_in(sig, bs, vn, sy, g, pattern0, width,
                                      causal)
                sp, vis, nw = _walk(sp, c, inv, a)
                vn[:, sy, g + 1] = vis | (nw << 16)
    return vn


def _records(sig, bs, vn, do_mrp, n_sy, n_gx, nwords):
    """Phase B: both unstuffed streams [N, nwords] and their bit counts,
    a lane taking consecutive groups, a scan of the lanes' lengths
    placing them."""
    n = sig.shape[0]
    ng = n_sy * n_gx
    per = -(-ng // LANES)
    vnf = vn[:, :, 1:n_gx + 1].reshape(n, ng)
    csf = sig[:, :n_sy, 1:n_gx + 1].reshape(n, ng)
    bsf = bs.reshape(n, ng)
    vis, nw = vnf & 0xFFFF, vnf >> 16
    recs = {
        'spp': (_pext16(bsf, vis) | (_pext16(bsf >> 16, nw) << _popc(vis)),
                _popc(vnf)),
        'mrp': (_pext16(bsf, csf), _popc(csf) * do_mrp[:, None]),
    }
    out = {}
    for key, (val, ln) in recs.items():
        val = np.where(ln > 0, val, 0)
        pad = np.zeros((n, LANES * per), np.int64)
        pad[:, :ng] = ln
        lane_len = pad.reshape(n, LANES, per)
        inc = _warp_scan(list(lane_len.sum(2).T), LANES, _add)
        base = np.stack(inc, 1) - lane_len.sum(2)
        pos = (base[:, :, None] + np.cumsum(lane_len, 2)
               - lane_len).reshape(n, -1)[:, :ng]
        words = np.zeros((n, nwords + 2), np.int64)
        rows = np.repeat(np.arange(n)[:, None], ng, 1)
        sh = val << (pos & 31)
        np.bitwise_or.at(words, (rows, pos >> 5), sh & 0xFFFFFFFF)
        np.bitwise_or.at(words, (rows, (pos >> 5) + 1), sh >> 32)
        out[key] = (words, inc[-1])
    return out


def _spp_model(buf, p, h_lim, npasses, causal, width, height):
    n_sy, n_gx = (height + 3) >> 2, (width + 3) >> 2
    sig, bs = _phase_a(buf, p, h_lim, width, n_sy, n_gx)
    h_eff = np.where(npasses >= 2, h_lim, 0)
    return sig, bs, _chain(sig, bs, h_eff, causal, width, n_sy, n_gx)


# ---------------------------------------------------------------------------
# the packers: 16-state tables of 64-bit chunks
# ---------------------------------------------------------------------------

def _state_then(f, g):
    """StateThen: f then g, nibble tables."""
    r = 0
    for s in range(16):
        r |= ((g >> (4 * ((f >> (4 * s)) & 0xF))) & 0xF) << (4 * s)
    return r


def _bits(words, nbits):
    """A stream's bits, LSB-first, zero from nbits on, with a chunk's
    window of spare zeros."""
    w = np.asarray(words, np.int64)
    b = ((w[:, None] >> np.arange(32)) & 1).reshape(-1)[:nbits]
    return np.concatenate([b, np.zeros(64 * (-(-nbits // 64)) + 128 - nbits,
                                       np.int64)])


def _byte_at(bits, pos):
    pos = np.asarray(pos)
    return sum(bits[pos + k] << k for k in range(8))


def _step(b, f, mrp):
    seven = (f & ((b & 0x7F) == 0x7F)) if mrp else f
    b = np.where(seven, b & 0x7F, b)
    return b, ((b > 0x8F) if mrp else (b == 0xFF)), np.where(seven, 7, 8)


def _chunk_maps(bits, nbits, mrp):
    """chunk_map of every chunk: all 16 entry states at once."""
    nch = -(-nbits // 64)
    c = np.arange(nch)[:, None]
    s = np.arange(16)[None, :]
    q = np.broadcast_to(s & 7, (nch, 16)).copy()
    f = np.broadcast_to((s >> 3) == 1, (nch, 16)).copy()
    lim = np.minimum(64, nbits - 64 * c)
    for _ in range(10):
        act = q < lim
        b, fn, adv = _step(_byte_at(bits, 64 * c + np.minimum(q, 63)), f, mrp)
        f = np.where(act, fn, f)
        q = np.where(act, q + adv, q)
    ex = np.where(q >= 64, (q - 64) | (f.astype(np.int64) << 3), 0)
    return [sum(int(ex[k, j]) << (4 * j) for j in range(16))
            for k in range(nch)]


EVERY8 = 0x0101010101010101
M64 = (1 << 64) - 1


def _chunk_map_events(bits, c, mrp):
    """chunk_map as the kernel computes it: each state's walk steps along
    its offsets mod 8 from stuffing event to stuffing event, found in bit
    masks of the chunk's window."""
    w = int.from_bytes(np.packbits(bits[64 * c:64 * c + 96].astype(np.uint8),
                                   bitorder='little').tobytes(), 'little')

    def shr(k):
        return (w >> k) & M64

    r7 = shr(0)
    for k in range(1, 7):
        r7 &= shr(k)
    ff = r7 & shr(7)
    gt = shr(7) & (shr(4) | shr(5) | shr(6))
    ev = gt & (r7 >> 8) if mrp else ff
    out = 0
    for s in range(16):
        q, f = s & 7, False
        if s >= 8 and (not mrp or (r7 >> q) & 1):
            q += 7
        while q < 64:
            at = ev & ((EVERY8 << (q & 7)) & M64) & ((M64 << q) & M64)
            if not at:
                f = bool(mrp and (gt >> (56 + (q & 7))) & 1)
                q = 64 + (q & 7)
                break
            e = (at & -at).bit_length() - 1
            if not mrp and e >= 56:
                q, f = e + 8, True
                break
            q = e + 15
        out |= ((q - 64) | (f << 3)) << (4 * s)
    return out


def _replay(bits, nbits, c, q, f, mrp):
    """chunk_replay: (bytes, next q, next f)."""
    out = []
    lim = min(64, nbits - 64 * c)
    while q < lim:
        b, f, adv = _step(int(_byte_at(bits, 64 * c + q)), bool(f), mrp)
        out.append(int(b))
        f = bool(f)
        q += int(adv)
    return out, q - 64, f


def _pack(words, nbits, mrp):
    """pack: one stream's stuffed bytes in emission order."""
    if nbits <= 0:
        return []
    bits = _bits(words, nbits)
    nch = -(-nbits // 64)
    per = -(-nch // LANES)
    live = -(-nch // per)
    own = [range(i * per, min(i * per + per, nch)) for i in range(LANES)]
    cmaps = [_chunk_map_events(bits, c, mrp) for c in range(nch)]
    maps = []
    for lane in range(LANES):
        m = STATE_ID
        for c in own[lane]:
            m = _state_then(m, cmaps[c])
        maps.append(m)
    maps = _warp_scan(maps, live, _state_then)
    s0 = 8 if mrp else 0
    lane_bytes = []
    for lane in range(LANES):
        s = s0 if lane == 0 else (maps[lane - 1] >> (4 * s0)) & 0xF
        q, f, got = s & 7, bool(s >> 3), []
        for c in own[lane]:
            b, q, f = _replay(bits, nbits, c, q, f, mrp)
            got += b
        lane_bytes.append(got)
    # the byte counts' scan places each lane's bytes
    inc = _warp_scan([len(b) for b in lane_bytes], LANES, _add)
    out = [0] * inc[-1]
    for lane, b in enumerate(lane_bytes):
        at = inc[lane] - len(b)
        out[at:at + len(b)] = b
    return out


def _segments(buf, p, h_lim, npasses, causal, width, height):
    """The model's whole K5 on N lanes: per lane (SigProp bytes, MagRef
    bytes in emission order)."""
    n_sy, n_gx = (height + 3) >> 2, (width + 3) >> 2
    sig, bs, vn = _spp_model(buf, p, h_lim, npasses, causal, width, height)
    nwords = (2 * width * height + 31) // 32 + 2
    st = _records(sig, bs, vn, npasses >= 3, n_sy, n_gx, nwords)
    out = []
    for i in range(buf.shape[0]):
        if npasses[i] < 2:
            out.append(([], []))
            continue
        out.append(tuple(_pack(st[k][0][i], int(st[k][1][i]), k == 'mrp')
                         for k in ('spp', 'mrp')))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _column_ref(c, inv, bits, sp):
    """encode_spp_mrp's decisions on one column (nibble 0) from its
    candidates, visitable positions, plane bits and incoming spread:
    (visited, new, the spread its new samples put on the next column)."""
    inv_sig = inv | 0xF0  # the next column's nibble takes the spread
    new_sig = (c | sp) & inv
    vis = np.zeros_like(new_sig)
    for k in range(4):
        take = (new_sig >> k) & 1
        vis |= take << k
        new_sig = new_sig & ~(1 << k)
        hit = take & (bits >> k) & 1
        new_sig = np.where(hit == 1, new_sig | (_SPP_SPREAD[k] & inv_sig),
                           new_sig)
    return vis, new_sig & 0xF, (new_sig >> 4) & 0xF


def test_column_maps_exhaustive():
    """Every (candidates, inv, bits) column against all 16 incoming
    spreads: the replayed step and the packed OR-affine map both give
    the reference's decisions and passed spread."""
    c, inv, bits, sp = (x.reshape(-1) for x in np.meshgrid(
        *(np.arange(16, dtype=np.int64),) * 4, indexing='ij'))
    vis_ref, new_ref, out_ref = _column_ref(c, inv, bits, sp)
    out, vis, new = _col(sp, c, inv, inv & bits)
    assert np.array_equal(vis, vis_ref)
    assert np.array_equal(new, new_ref)
    assert np.array_equal(out, out_ref)
    m = _col5(np.full_like(c, SPREAD_ID), c, inv & bits)
    assert np.array_equal(_apply(m, sp), out_ref)


def test_group_maps_compose():
    """A group's map (four columns walked on the packed states) is its
    replay for all 16 spreads, and SpreadThen composes two groups' maps
    as the two replays in turn; StateThen composes nibble tables."""
    rng = np.random.RandomState(1)
    n = 4000
    gs = [tuple(rng.randint(0, 1 << 16, n).astype(np.int64)
                for _ in range(3)) for _ in range(2)]
    gs = [(c, inv, inv & b) for c, inv, b in gs]
    maps = [_walk5(np.full(n, SPREAD_ID, np.int64), c, a) for c, _, a in gs]
    both = _spread_then(maps[0], maps[1])
    assert np.array_equal(_walk5(maps[0], gs[1][0], gs[1][2]), both)
    for s in range(16):
        sp = np.full(n, s, np.int64)
        one, _, _ = _walk(sp, *gs[0])
        assert np.array_equal(_apply(maps[0], sp), one)
        two, _, _ = _walk(one, *gs[1])
        assert np.array_equal(_apply(both, sp), two)
    for _ in range(50):
        f, g = rng.randint(0, 16, 16), rng.randint(0, 16, 16)
        pk = [sum(int(t[s]) << (4 * s) for s in range(16)) for t in (f, g)]
        h = _state_then(*pk)
        assert [(h >> (4 * s)) & 0xF for s in range(16)] == list(g[f])
        assert _state_then(STATE_ID, pk[0]) == pk[0] == \
            _state_then(pk[0], STATE_ID)


def test_pext16_exhaustive():
    """The branch-free gather against the bit-at-a-time one on every
    16-bit mask, with random and all-ones values."""
    m = np.arange(1 << 16, dtype=np.int64)
    for v in (np.random.RandomState(2).randint(0, 1 << 16, m.size),
              np.full(m.size, 0xFFFF), np.full(m.size, 0xA5A5)):
        v = v.astype(np.int64) | (0x5A5A << 16)  # bits above 16 ignored
        assert np.array_equal(_pext16(v, m), _pext16_ref(v & 0xFFFF, m))


CHAIN_SHAPES = K5_SHAPES + [(1024, 4, 4), (4, 1024, 1024)]


def _shape_lanes(w, h, hp):
    n = 4 if w * h > 256 else 12
    buf, ps = _lanes(w * 7 + h, w, h, hp, n)
    rng = np.random.RandomState(w + 3 * h)
    h_lim = np.where(rng.rand(n) < 0.5, h, rng.randint(1, h + 1, n))
    npasses = np.array([3, 2, 0, 3, 1, 3] * 2)[:n]
    return buf, ps, h_lim.astype(np.int32), npasses.astype(np.int32)


def _plain(buf, ps, h_lim, npasses, causal, w, hp):
    return P.encode_refine_core(
        torch.from_numpy(np.ascontiguousarray(buf).view(np.int32)),
        torch.from_numpy(ps), torch.from_numpy(h_lim),
        torch.from_numpy(npasses), causal, w, hp, P.cap_words(w, hp))


@pytest.mark.parametrize('w,h,hp', CHAIN_SHAPES,
                         ids=[f'{w}x{h}_in_{hp}' for w, h, hp in CHAIN_SHAPES])
def test_scan_model_matches_plain(w, h, hp):
    """Seeded lanes (mixed heights and pass counts), causal off and on:
    the model's decisions equal _spp_decisions', and its segments (its
    records, chunk tables, scans and replays) the plain version's."""
    buf, ps, h_lim, npasses = _shape_lanes(w, h, hp)
    n_sy, n_gx = (hp + 3) >> 2, (w + 3) >> 2
    for causal in (False, True):
        sig, bs, vn = _spp_model(buf, ps, h_lim, npasses, causal, w, hp)
        sig_t = torch.from_numpy(np.ascontiguousarray(sig[:, :, 1:]))
        bit_t = torch.from_numpy(np.pad(bs & 0xFFFF, ((0, 0), (0, 1),
                                                      (0, 1))))
        seen, new = P._spp_decisions(
            sig_t, bit_t, torch.from_numpy(h_lim).long(),
            torch.from_numpy(npasses >= 2), causal, w, n_sy, n_gx)
        assert np.array_equal(vn[:, :, 1:n_gx + 1] & 0xFFFF, seen.numpy())
        assert np.array_equal(vn[:, :, 1:n_gx + 1] >> 16, new.numpy())
        out, lens, _ = _plain(buf, ps, h_lim, npasses, causal, w, hp)
        raw = out.numpy().view(np.uint8).reshape(buf.shape[0], -1)
        for i, (spp, mrp) in enumerate(_segments(buf, ps, h_lim, npasses,
                                                 causal, w, hp)):
            assert [len(spp), len(mrp)] == lens[i].tolist(), (i, causal)
            seg = bytes(spp) + bytes(mrp[::-1])
            assert seg == bytes(raw[i, :len(seg)]), (i, causal)


@pytest.mark.parametrize('w,h', [(64, 64), (1024, 4), (4, 1024), (13, 7)])
def test_scan_model_matches_encode_spp_mrp(w, h):
    """The model's segments against the JAX package's host coder, 2 and 3
    passes, causal off and on."""
    buf, ps = _lanes(w + 11 * h, w, h, h, 3)
    n = buf.shape[0]
    for npasses in (2, 3):
        for causal in (False, True):
            segs = _segments(buf, ps, np.full(n, h), np.full(n, npasses),
                             causal, w, h)
            for i, (spp, mrp) in enumerate(segs):
                want = encode_spp_mrp(buf[i], 30 - int(ps[i]), w, h,
                                      num_passes=npasses,
                                      stripe_causal=causal)
                assert bytes(spp) + bytes(mrp[::-1]) == want, (i, npasses)


def _streams(seed):
    """Unstuffed streams rich in runs of ones: all ones of lengths around
    chunk edges, runs of 6 to 20 ones starting just before a chunk edge,
    runs of ones at the stream's end, dense noise."""
    rng = np.random.RandomState(seed)
    out = []
    for nbits in (1, 7, 8, 9, 63, 64, 65, 71, 72, 127, 128, 129, 449, 2048,
                  4096, 8192):
        out.append(np.ones(nbits, np.int64))
    for edge in (64, 128, 1984, 2048, 4032):
        for back in range(0, 16, 3):
            b = (rng.rand(edge + 200) < 0.5).astype(np.int64)
            run = rng.randint(6, 21)
            b[edge - back:edge - back + run] = 1
            out.append(b)
    for tail in (7, 8, 9, 15, 16, 17):
        b = (rng.rand(300 + tail) < 0.5).astype(np.int64)
        b[-tail:] = 1
        out.append(b)
    for dens in (0.9, 0.97):
        out.append((rng.rand(5000) < dens).astype(np.int64))
    return out


@pytest.mark.parametrize('mrp', [False, True], ids=['sigprop', 'magref'])
def test_chunk_maps_events_match_byte_walks(mrp):
    """The event-stepping chunk tables equal the byte-by-byte walks of all
    16 states on every whole chunk of the run-rich streams and of seeded
    windows of every density."""
    rng = np.random.RandomState(3 + mrp)
    streams = _streams(7 + mrp) + [
        (rng.rand(64 * 40) < d).astype(np.int64)
        for d in (0.5, 0.8, 0.9, 0.95, 0.98, 1.0)]
    for b in streams:
        bits = np.concatenate([b, np.zeros(192, np.int64)])
        full = len(b) // 64  # chunks wholly inside the stream
        if not full:
            continue
        brute = _chunk_maps(bits, 64 * full, mrp)
        for c in range(full):
            assert _chunk_map_events(bits, c, mrp) == brute[c], (len(b), c)


@pytest.mark.parametrize('mrp', [False, True], ids=['sigprop', 'magref'])
def test_packer_model_matches_stuff(mrp):
    """The chunked packer (16-state tables, their scan, the replays and
    the byte-count scan) against _stuff on streams of runs of ones across
    chunk edges and at the stream's end."""
    streams = _streams(5 + mrp)
    nw = max(-(-len(b) // 32) for b in streams)
    words = np.zeros((len(streams), nw), np.int64)
    for i, b in enumerate(streams):
        for k in range(len(b)):
            words[i, k >> 5] |= int(b[k]) << (k & 31)
    nbits = torch.tensor([len(b) for b in streams])
    want, cnt = P._stuff(torch.from_numpy(words), nbits, mrp)
    for i, b in enumerate(streams):
        got = _pack(words[i], len(b), mrp)
        assert len(got) == int(cnt[i]), i
        assert got == want[i, :len(got)].tolist(), i
