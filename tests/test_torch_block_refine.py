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
    for got in (native.prep_refine_streams(datas, lcups, len2,
                                           min_words=(128, 128)),
                pbr.prep_refine_streams(datas, lcups, len2,
                                        min_words=(128, 128)),
                pbr.prep_refine_streams_np(datas, lcups, len2,
                                           min_words=(128, 128))):
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
