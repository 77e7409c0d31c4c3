"""The port's refinement passes (SigProp / MagRef) held against the JAX
package on the same inputs: the plain refine_core (gpu/block_refine.py,
behind the wrapper gpu/block_refine_cuda.py) against
tpu/block_refine.py::decode_cleanup_refine, the raw refinement readers
(gpu/unstuff.py) against tpu/unstuff.py::unstuff_spp / unstuff_mrp, the
host stream prep against prep_refine_streams_np, and the native scalar
codeblock decoder against coding/decoder.py::decode_codeblock.  All
bit-exact.  The CUDA kernel itself runs only on the card, where
chip_smoke.py holds it against these plain versions.
"""
import numpy as np
import pytest
import torch

from openjph_tpu.coding.decoder import decode_codeblock
from openjph_tpu.coding.encoder import (encode_codeblock,
                                        encode_codeblock_multipass)
from openjph_tpu.tpu.bitprep import prep_cleanup_streams_np
from openjph_tpu.tpu.block_refine import (decode_cleanup_refine,
                                          prep_refine_streams_np)
from openjph_tpu.tpu.unstuff import _ROW, unstuff_mrp, unstuff_spp

from openjph_tpu_torch import native
from openjph_tpu_torch.gpu import block_decode as pbd
from openjph_tpu_torch.gpu import block_refine as pbr
from openjph_tpu_torch.gpu import block_refine_cuda as R
from openjph_tpu_torch.gpu.unstuff import raw_refine_to_dense


def _rand_block(rng, w, h, kmax, density=0.4):
    m = rng.randint(0, 1 << (kmax - 1), (h, w))
    m[rng.rand(h, w) > density] = 0
    sgn = (rng.rand(h, w) < 0.5).astype(np.uint32)
    return ((sgn << 31)
            | (m.astype(np.uint32) << (31 - kmax))).astype(np.uint32)


def _block(rng, w, h, kmax, passes, density=0.4, nonempty=False):
    """(coded bytes, len1, len2) of one random codeblock."""
    buf = _rand_block(rng, w, h, kmax, density)
    if nonempty:
        buf[0, 0] |= np.uint32(1) << np.uint32(31 - kmax)
    if passes == 1:
        seg1, seg2 = encode_codeblock(buf, kmax - 2, w, h), b''
    else:
        seg1, seg2 = encode_codeblock_multipass(buf, kmax - 2, w, h,
                                                num_passes=passes)
    return seg1 + seg2, len(seg1), len(seg2)


def _items(case):
    """The batches of tests/test_refine_batch.py: (items, width, group
    height), an item being (data, lcup, len2, mm, npasses, h, causal)."""
    rng = np.random.RandomState({'16x16': 1, '8x8': 2, '64x64': 3,
                                 '36x20': 4, 'mixed_heights': 5,
                                 'sparse_dense': 6}[case])
    items = []
    if case == 'mixed_heights':
        w, kmax = 16, 8
        for i, h in enumerate([16, 13, 7, 4, 1, 16, 9, 3]):
            passes = (i % 3) + 1
            d, l1, l2 = _block(rng, w, h, kmax, passes, density=0.6)
            items.append((d, l1, l2, kmax - 2, passes, h, bool(i & 2)))
        return items, w, 16
    if case == 'sparse_dense':
        w = h = 32
        kmax = 10
        for i, (dens, passes) in enumerate([(0.02, 3), (1.0, 3), (0.02, 2),
                                            (1.0, 2)]):
            d, l1, l2 = _block(rng, w, h, kmax, passes, density=dens,
                               nonempty=True)
            items.append((d, l1, l2, kmax - 2, passes, h, bool(i & 1)))
        return items, w, h
    w, h = (int(v) for v in case.split('x'))
    kmax = 8
    for i in range(12):
        passes = (i % 3) + 1
        d, l1, l2 = _block(rng, w, h, kmax, passes)
        items.append((d, l1, l2, kmax - 2, passes, h, bool(i & 1)))
    return items, w, h


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize('case', ['16x16', '8x8', '64x64', '36x20',
                                  'mixed_heights', 'sparse_dense'])
def test_refine_core_matches_jax(case):
    items, w, hmax = _items(case)
    datas = [np.frombuffer(it[0], np.uint8) for it in items]
    lcups = np.array([it[1] for it in items], np.int64)
    len2s = np.array([it[2] for it in items], np.int64)
    scups = np.array([(int(d[lc - 1]) << 4) + (int(d[lc - 2]) & 0xF)
                      for d, lc in zip(datas, lcups)], np.int64)
    p = np.array([30 - it[3] for it in items], np.int32)
    nps = np.array([it[4] for it in items], np.int32)
    nps = np.where(len2s == 0, np.minimum(nps, 1), nps).astype(np.int32)
    hs = np.array([it[5] for it in items], np.int32)
    caus = np.array([it[6] for it in items], bool)
    streams = prep_cleanup_streams_np(datas, lcups, scups)
    ref = prep_refine_streams_np(datas, lcups, len2s)
    want, err = decode_cleanup_refine(
        streams['mel'], streams['vlc'], streams['ms'], ref['spp'],
        ref['mrp'], p, nps, hs, caus, w, hmax)
    assert not np.asarray(err).any()
    want = np.asarray(want)

    gates = (_t(p), _t(nps), _t(hs), _t(caus.astype(np.int32)))
    dec, err = pbd.decode_cleanup_core(
        _t(streams['mel']), _t(streams['vlc']), _t(streams['ms']), gates[0],
        w, hmax, torch.from_numpy((hs + 1) // 2))
    assert not err.any()
    got = R.refine(dec, _t(ref['spp']), _t(ref['mrp']), *gates, w, hmax)
    # rows at or past a lane's true height are not compared: the JAX
    # cleanup decodes garbage there, the port's writes zeros
    for i, it in enumerate(items):
        np.testing.assert_array_equal(
            got[i, :it[5]].numpy().view(np.uint32), want[i, :it[5]],
            err_msg=f'lane {i}')
    # the raw readers on the same segments, packed into one blob
    blob = np.zeros(64 + int(len2s.sum()) + 64, np.uint8)
    roff, at = [], 64
    for d, lc, l2 in zip(datas, lcups, len2s):
        blob[at:at + l2] = d[lc:lc + l2]
        roff.append(at)
        at += l2
    got_raw = R.refine_raw(dec, torch.from_numpy(blob),
                           _t(np.array(roff, np.int32)),
                           _t(len2s.astype(np.int32)), *gates, w, hmax)
    assert torch.equal(got_raw, got)
    # and the scalar oracle on each lane's true rows
    for i, it in enumerate(items):
        h = it[5]
        np.testing.assert_array_equal(
            got[i, :h].numpy().view(np.uint32),
            decode_codeblock(it[0], it[3], it[4], it[1], it[2], w, h,
                             stripe_causal=it[6]), err_msg=f'lane {i}')


def _stuffing_rich_lanes(seed, n=40, maxlen=180):
    """Refinement segments rich in 0xFF, 0x7F and > 0x8F bytes, with the
    readers' edge cases first: a first byte whose low 7 bits are ones, a
    last byte that drops its bit 7 (which stays visible), runs of 0xFF."""
    rng = np.random.RandomState(seed)
    lanes = [[], [0xFF], [0x7F], [0x90, 0xFF], [0x12, 0x90, 0xFF],
             [0xFF, 0xFF, 0xFF], [0x7F, 0x7F, 0x90, 0x7F],
             [0xFF, 0x80, 0xFF, 0x00], [0x8F, 0xFF, 0xFE, 0xFF]]
    alpha = np.array([0xFF, 0x7F, 0x8F, 0x90, 0xFE, 0x80, 0x00, 0xFF],
                     np.uint8)
    while len(lanes) < n:
        k = rng.randint(1, maxlen)
        seg = np.where(rng.rand(k) < 0.5, rng.choice(alpha, k),
                       rng.randint(0, 256, k))
        lanes.append([int(b) for b in seg])
    return lanes


def test_raw_refine_readers_match_jax():
    lanes = _stuffing_rich_lanes(11)
    len2 = np.array([len(s) for s in lanes], np.int64)
    nw = int((len2.max() * 8 + 31) // 32 + 3)
    # the JAX readers fetch clipped word windows: lead and tail margins
    margin = 4 * (nw + _ROW + 2)
    blob = np.zeros(2 * margin + int(len2.sum()) + 4 * nw, np.uint8)
    roff, at = [], margin
    for s in lanes:
        blob[at:at + len(s)] = s
        roff.append(at)
        at += len(s)
    blob = blob[:len(blob) // 4 * 4]
    roff = np.array(roff, np.int32)
    spp, mrp = raw_refine_to_dense(torch.from_numpy(blob),
                                   torch.from_numpy(roff),
                                   torch.from_numpy(len2), nw)
    b32 = blob.view(np.uint32)
    want_spp = np.asarray(unstuff_spp(b32, roff, len2.astype(np.int32), nw))
    want_mrp = np.asarray(unstuff_mrp(b32, roff, len2.astype(np.int32), nw))
    np.testing.assert_array_equal(spp.numpy().astype(np.uint32), want_spp)
    np.testing.assert_array_equal(mrp.numpy().astype(np.uint32), want_mrp)
    # ... and the host prep of the same segments
    ref = prep_refine_streams_np([bytes(s) for s in lanes],
                                 np.zeros(len(lanes), np.int64), len2,
                                 min_words=(nw, nw))
    np.testing.assert_array_equal(want_spp, ref['spp'])
    np.testing.assert_array_equal(want_mrp, ref['mrp'])


def test_prep_refine_streams_match_jax():
    rng = np.random.RandomState(12)
    lanes = _stuffing_rich_lanes(13, n=30, maxlen=400)
    datas, lcups = [], []
    for s in lanes:
        pre = rng.randint(0, 256, rng.randint(2, 50)).astype(np.uint8)
        datas.append(pre.tobytes() + bytes(s))
        lcups.append(len(pre))
    lcups = np.array(lcups, np.int64)
    len2 = np.array([len(s) for s in lanes], np.int64)
    want = prep_refine_streams_np(datas, lcups, len2, min_words=(128, 128))
    got = native.prep_refine_streams(datas, lcups, len2,
                                     min_words=(128, 128))
    for k in ('spp', 'mrp'):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize('passes,causal', [(1, False), (2, False), (2, True),
                                           (3, False), (3, True)])
def test_native_decode_codeblock_matches_jax(passes, causal):
    rng = np.random.RandomState(20 + passes)
    for w, h in ((32, 32), (36, 20), (64, 8)):
        kmax = 9
        d, l1, l2 = _block(rng, w, h, kmax, passes, density=0.5)
        want = decode_codeblock(d, kmax - 2, passes, l1, l2, w, h,
                                stripe_causal=causal)
        got = native.decode_codeblock(d, kmax - 2, passes, l1, l2, w, h,
                                      stripe_causal=causal)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_cpu_refine_launches_no_kernel():
    items, w, h = _items('8x8')
    n = len(items)
    R.reset_launches()
    dec = torch.zeros((n, h, w), dtype=torch.int32)
    z = torch.zeros(n, dtype=torch.int32)
    full = torch.full((n,), 3, dtype=torch.int32)
    words = torch.zeros((n, 8), dtype=torch.int32)
    R.refine(dec, words, words, full + 5, full, full + 5, z, w, h)
    R.refine_raw(dec, torch.zeros(64, dtype=torch.uint8), z, z, full + 5,
                 full, full + 5, z, w, h)
    assert sum(R.LAUNCHES.values()) == 0


# ---- the kernel's algorithm, modelled lane by lane on the CPU ----
#
# csrc/ht_refine_decode.cu runs SigProp as a context word a group (phase
# D1, all lanes), a chain of column steps through spp_column_table on one
# lane (D2), then MagRef's reads and SigProp's sign reads, and the stores
# of both, a step of two groups a lane (E).
# _kernel_model repeats those phases for one lane, in the kernel's order
# and with its words, from the table alone; the tests below hold it to
# the plain refine_core and to the JAX package's.

_M32 = 0xFFFFFFFF


def _vspread(x):
    return ((x & 0x77777777) << 1) | ((x & 0xEEEEEEEE) >> 1)


def _shl(v, n):
    return (v << n) & _M32 if 0 <= n < 32 else 0


def _kernel_model(dec, spp, mrp, p, npasses, hl, causal, w, h, table):
    """One lane through phases A, D1, D2 and E: dec uint32 [h, w], spp /
    mrp uint32 word rows (zero past their end), the gates as ints;
    returns the refined uint32 [h, w]."""
    out = dec.copy()
    if npasses < 2:
        return out
    n_sy, n_gx = (h + 3) >> 2, (w + 3) >> 2
    gs = n_gx + 1

    def word(a, i):
        return int(a[i]) if i < len(a) else 0

    def bits32(a, off):
        k = off >> 5
        return ((word(a, k) | word(a, k + 1) << 32) >> (off & 31)) & _M32

    # A: cleanup significance, bit 4*col + row, rows below min(hl, h)
    sig = [[0] * gs for _ in range(n_sy + 1)]
    for y, x in zip(*np.nonzero(dec[:max(0, min(hl, h))])):
        sig[y >> 2][x >> 2] |= 1 << (((x & 3) << 2) | (y & 3))
    nst = 0 if hl <= 0 else min(n_sy, (hl + 3) >> 2)
    zero = [0] * gs
    # D1: each group's fixed context, candidates | not significant << 16
    ctx = [[0] * gs for _ in range(n_sy)]
    for sy in range(nst):
        c, n, a = sig[sy], sig[sy + 1], sig[sy - 1] if sy else zero
        for gx in range(n_gx):
            cs = c[gx] | c[gx + 1] << 16
            ns = n[gx] | n[gx + 1] << 16
            ps = a[gx] | a[gx + 1] << 16
            u = ((ps & 0x88888888) >> 3) | (
                0 if causal else (ns & 0x11111111) << 3)
            m = cs | _vspread(cs) | u
            m = (m | m << 4 | m >> 4) & _M32
            if gx:
                lu = ((a[gx - 1] & 0x8888) >> 3) | (
                    0 if causal else (n[gx - 1] & 0x1111) << 3)
                m |= ((c[gx - 1] | _vspread(c[gx - 1]) | lu) & 0xF000) >> 12
            rl = hl - 4 * sy
            pattern = {1: 0x1111, 2: 0x3333, 3: 0x7777}.get(min(rl, 4),
                                                             0xFFFF)
            pattern >>= 4 * max(4 * gx + 4 - w, 0)
            inv = ~cs & pattern
            ctx[sy][gx] = (m & inv) | inv << 16
    # D2: the chain; the window doubled, a funnel shift of the words
    # around bit off + 31 = 32 * j + u, the word after them read ahead
    res = [[0] * gs for _ in range(n_sy)]
    lo, hi, nxt = 0, word(spp, 0), word(spp, 1)
    j, u, off = 0, 31, 0
    for sy in range(nst):
        e = udl = 0
        for gx in range(n_gx):
            c = ctx[sy][gx]
            a_lo, a_hi = (res[sy - 1][gx], res[sy - 1][gx + 1]) if sy \
                else (0, 0)
            ud = (((a_lo & 0xFFFF) | a_hi << 16) & 0x88888888) >> 3
            inv = c >> 16
            stat = (c | ud | ud << 4 | ud >> 4 | udl) & inv
            nsig = cnt = used = 0
            if stat | ((e >> 5) & inv & 0xF):
                v = ((hi << 32 | lo) >> u) & _M32
                for col in range(4):
                    ic = (inv >> 4 * col) & 0xF
                    fix = ((stat >> 4 * col) & 0xF) << 5 | ic << 9
                    # byte offset 2 * index into the uint16 table
                    e = int(table[((v & 0x1E) | (e & ic << 5) | fix) >> 1])
                    v >>= e & 0x1F
                    cnt += e & 0xF
                    used += e >> 13
                    nsig |= ((e >> 9) & 0xF) << 4 * col
            else:
                e = 0
            used += cnt
            res[sy][gx] = nsig | (off + cnt) << 16
            off += used
            t = u + used
            u = t & 31
            if t >= 32:
                lo, hi, j = hi, nxt, j + 1
            nxt = word(spp, j + 1)
            udl = (ud & 0xF000) >> 12
    # E: a step (two groups of a stripe) at a time: its MagRef bits at the
    # offset the steps before it read, each group's sign bits at its
    # stored offset; a changed sample's bit is the one its rank among the
    # set bits names
    val16, half = _shl(3, p - 2), _shl(1, p - 2)
    both, base = _shl(1, p - 1) | half, 0

    def rank(m, b):
        return bin(m & ((1 << b) - 1)).count('1')

    for sy in range(nst):
        for at in range(0, n_gx, 2):
            msig = sig[sy][at] | sig[sy][at + 1] << 16 if npasses >= 3 else 0
            mbits = bits32(mrp, base)
            base += bin(msig).count('1')
            r0, r1 = res[sy][at], res[sy][at + 1]
            n0, n1 = r0 & 0xFFFF, r1 & 0xFFFF
            sb = (bits32(spp, r0 >> 16), bits32(spp, r1 >> 16))
            for b in range(32):
                y, x = 4 * sy + (b & 3), 4 * at + (b >> 2)
                if y >= h:
                    continue
                if (msig >> b) & 1:
                    bit = (mbits >> rank(msig, b)) & 1
                    out[y, x] ^= half if bit else both
                elif ((n0 | n1 << 16) >> b) & 1:
                    g, k = (0, rank(n0, b)) if b < 16 else (1, rank(n1, b - 16))
                    val = ((sb[g] >> k) & 1) << 31 | val16
                    if val:
                        out[y, x] = val
    return out


def _model_lanes(seed, w, h, n):
    """n seeded lanes as the card's synthetic batches make them: any
    32-bit cleanup samples at three densities, cut h_lim, passes 1-3,
    both causal modes, p 0-30, stuffing-rich segments; their dense
    streams from the plain raw readers, long enough that no read passes
    their end.  Returns (dec, spp, mrp, gates, (blob, roff, len2))."""
    rng = np.random.RandomState(seed)
    on = rng.rand(n, h, w) < rng.choice([0.02, 0.3, 0.9], (n, 1, 1))
    vals = rng.randint(1, 1 << 32, (n, h, w), dtype=np.uint64)
    dec = np.where(on, vals, 0).astype(np.uint32)
    h_lim = rng.randint(0, h + 1, n)
    h_lim[:n // 2] = h
    gates = dict(p=rng.randint(0, 31, n), npasses=rng.randint(1, 4, n),
                 h_lim=h_lim, causal=np.arange(n) % 2)
    gates['npasses'][:2] = (2, 3)
    # two of the readers' edge cases, then random segments; every third
    # lane's bytes thinned to about one bit in eight, so that few samples
    # turn significant and a single context term decides a candidate
    lanes = _stuffing_rich_lanes(seed, n=n + 7, maxlen=2 * w * h // 8)[7:]
    for i in range(2, n, 3):
        k = len(lanes[i])
        lanes[i] = list(np.array(lanes[i]) & rng.randint(0, 256, k)
                        & rng.randint(0, 256, k) & rng.randint(0, 256, k))
    len2 = np.array([len(s) for s in lanes], np.int64)
    blob = np.zeros(64 + int(len2.sum()) + 64, np.uint8)
    roff, at = [], 64
    for s in lanes:
        blob[at:at + len(s)] = s
        roff.append(at)
        at += len(s)
    area = 16 * ((h + 3) >> 2) * ((w + 3) >> 2)
    nw = max(int(len2.max()) * 8, 2 * area) // 32 + 8
    roff = np.array(roff, np.int64)
    spp, mrp = raw_refine_to_dense(torch.from_numpy(blob),
                                   torch.from_numpy(roff),
                                   torch.from_numpy(len2), nw)
    return (dec, spp.numpy().astype(np.uint32), mrp.numpy().astype(np.uint32),
            gates, (blob, roff, len2))


def _model_all(dec, spp, mrp, gates, w, h):
    table = R.spp_column_table()
    return np.stack([
        _kernel_model(dec[i], spp[i], mrp[i], int(gates['p'][i]),
                      int(gates['npasses'][i]), int(gates['h_lim'][i]),
                      bool(gates['causal'][i]), w, h, table)
        for i in range(dec.shape[0])])


def test_spp_column_table_exhaustive():
    """Every entry against the candidate loop of the plain SigProp
    restricted to one column: candidates lowest first, a decision on a 1
    spreading to the rest of the column's not-yet-significant rows; the
    spread onto the next column and the count of sign bits."""
    table = R.spp_column_table()
    assert table.dtype == np.uint16 and table.nbytes == R.TABLE_BYTES
    col_spread = [s & 0xF for s in pbr.SPREAD_POS[:4]]
    next_spread = [(s >> 4) & 0xF for s in pbr.SPREAD_POS[:4]]
    for i in range(R.TABLE_ENTRIES):
        cwd, new_sig, inv = i & 0xF, (i >> 4) & 0xF, i >> 8
        cnt = nxt = 0
        for pos in range(4):
            take = (new_sig >> pos) & 1
            new_sig &= ~(1 << pos)
            if take and cwd & 1:
                new_sig |= (col_spread[pos] & inv) | 1 << pos
                nxt |= next_spread[pos]
            if take:
                cwd >>= 1
                cnt += 1
        want = (cnt | nxt << 5 | new_sig << 9
                | bin(new_sig).count('1') << 13)
        assert int(table[i]) == want, f'entry {i:#x}'


@pytest.mark.parametrize('w,h', [(64, 64), (36, 20), (13, 7), (62, 33),
                                 (3, 64)])
def test_kernel_model_matches_plain(w, h):
    n = 9
    dec, spp, mrp, gates, _ = _model_lanes(30 + w, w, h, n)
    want = R.refine(_t(dec), _t(spp), _t(mrp),
                    *(_t(gates[k].astype(np.int32))
                      for k in ('p', 'npasses', 'h_lim', 'causal')), w, h)
    got = _model_all(dec, spp, mrp, gates, w, h)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    assert not np.array_equal(got, dec)


@pytest.mark.parametrize('w,h', [(16, 16), (36, 20)])
def test_kernel_model_matches_jax(w, h):
    import jax
    from openjph_tpu.tpu.block_refine import refine_core as jax_refine
    dec, spp, mrp, gates, _ = _model_lanes(50 + w, w, h, 4)
    want = jax.jit(jax_refine, static_argnums=(7, 8))(
        dec, spp, mrp, gates['p'].astype(np.int32),
        gates['npasses'].astype(np.int32), gates['h_lim'].astype(np.int32),
        gates['causal'].astype(bool), w, h)
    got = _model_all(dec, spp, mrp, gates, w, h)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.cuda
@pytest.mark.parametrize('packed', [False, True])
def test_cuda_kernel_matches_plain(packed):
    """Both reader modes of the kernel against their plain versions on
    the model's seeded lanes, with the table entry and the shared-memory
    size of a codeblock; ``packed``: the lanes repeated past 16 an SM, so
    that a block's SigProp chains share its first warp."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    lib = R.load()
    # a codeblock's shared memory: the chain's slot, the significance
    # words, a context and a result word a group and the two streams
    assert lib.ht_refine_warp_bytes(64, 64) == 5216
    assert lib.ht_refine_warp_bytes(13, 7) % 16 == 0
    table = R.spp_column_table()
    assert lib.ht_refine_set_tables(table.ctypes.data, table.nbytes) == 0
    assert lib.ht_refine_set_tables(table.ctypes.data, 64) != 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    R.reset_launches()
    for w, h in ((64, 64), (36, 20), (13, 7), (3, 64)):
        dec, spp, mrp, gates, (blob, roff, len2) = _model_lanes(30 + w, w,
                                                                h, 6)
        reps = (16 * sms) // dec.shape[0] + 1 if packed else 1
        assert lib.ht_refine_packs(reps * dec.shape[0], w, h,
                                   R.PER_BLOCK) == int(packed)
        g = [_t(gates[k].astype(np.int32))
             for k in ('p', 'npasses', 'h_lim', 'causal')]
        want = R.refine(_t(dec), _t(spp), _t(mrp), *g, w, h)
        want = want.repeat(reps, 1, 1)
        lanes = [_t(a).repeat(reps, *([1] * (a.ndim - 1))).to(dev)
                 for a in (dec, spp, mrp, roff.astype(np.int32),
                           len2.astype(np.int32))]
        g = [t.repeat(reps).to(dev) for t in g]
        got = R.refine(lanes[0].clone(), *lanes[1:3], *g, w, h)
        got_raw = R.refine_raw(lanes[0],
                               torch.from_numpy(blob).to(dev), *lanes[3:],
                               *g, w, h)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got_raw.cpu(), want)
    assert R.LAUNCHES == {'ht_refine_decode_dense': 4,
                          'ht_refine_decode_raw': 4}
