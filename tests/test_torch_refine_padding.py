"""Multi-pass codeblocks whose cleanup segment makes a padding sample
significant: column ``width`` of the last quad column of an odd-width
block, or row ``height`` of the last quad row of an odd-height one.  Only
a damaged or hand-made stream does this.  The JAX package has three
answers there: its fused path (tpu/block_refine.py::sig_pack,
decode_cleanup_refine, behind decode_tpu) takes significance from the
cleanup samples inside the block; its native host decoder (behind
openjph_tpu.decode) takes it from the quads' rho, so SigProp counts the
padding sample as a neighbour and MagRef spends a bit on it, writing that
bit into the sample after it in memory; its Python decoder raises
IndexError.  The port keeps the fused semantics on every path: its plain
cleanup and refine (gpu/block_decode.py, gpu/block_refine.py, which K4 is
held to on the card), its native oracle (native.decode_codeblock) and its
frame decode.

The constructed blocks are coded one sample wider (or taller) than they
are declared, with the extra column (row) nonzero, by the JAX package's
encode_codeblock_multipass: 7 and 5 wide from 8 and 6, 15 and 13 tall
from 16 and 14; 2 and 3 passes; stripe-causal off and on.  The damaged
stream is a one-codeblock 11x7 3-pass stripe-causal frame with one data
bit flipped.  Run as a script, this file writes the card's fixture of the
blocks (openjph_tpu_torch/testdata/refine_padding_lanes.npz) and the
damaged stream.
"""
import functools
import os

import numpy as np
import pytest
import torch

import openjph_tpu
from openjph_tpu.coding.encoder import encode_codeblock_multipass
from openjph_tpu.tpu.bitprep import prep_cleanup_streams_np
from openjph_tpu.tpu.block_refine import (decode_cleanup_refine,
                                          prep_refine_streams_np)

import openjph_tpu_torch
from openjph_tpu_torch import native
from openjph_tpu_torch.gpu import block_decode as pbd
from openjph_tpu_torch.gpu import block_refine_cuda as R
from openjph_tpu_torch.native import (prep_cleanup_streams,
                                     prep_refine_streams)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')
LANES_NPZ = os.path.join(TESTDATA, 'refine_padding_lanes.npz')
DAMAGED = os.path.join(TESTDATA, 'gray_11x7_rev_p3_causal_flip.j2c')

# name: (declared width, declared height, coded width, coded height)
SHAPES = {'w7': (7, 16, 8, 16), 'w5': (5, 16, 6, 16),
          'h15': (8, 15, 8, 16), 'h13': (8, 13, 8, 14)}
CASES = [(name, passes, causal) for name in SHAPES for passes in (2, 3)
         for causal in (False, True)]
KMAX = 8
# the damaged stream: seeded 4-bit noise, one codeblock, one bit flipped
DAMAGED_KWARGS = dict(bit_depth=4, reversible=True, num_decomps=0,
                      block_size=(16, 16), vert_causal=True, ht_passes=3)
DAMAGED_FLIP = (148, 6)     # byte offset, bit
# samples where openjph_tpu.decode, clipped to 4 bits, differs from the
# fused decode (and the port) on the damaged stream
HOST_DIFFERS = 9


def _block(name, passes, causal):
    """One constructed codeblock as the planner would see it."""
    w, h, cw, ch = SHAPES[name]
    rng = np.random.RandomState(
        1000 + 10 * list(SHAPES).index(name) + 2 * passes + causal)
    m = rng.randint(0, 1 << (KMAX - 1), (ch, cw))
    m[rng.rand(ch, cw) > 0.4] = 0
    pad = (slice(None), slice(w, None)) if cw > w else \
        (slice(h, None), slice(None))
    # the padding column (row) has its top plane set: significant in the
    # cleanup pass
    m[pad] = rng.randint(1 << (KMAX - 2), 1 << (KMAX - 1), m[pad].shape)
    sgn = (rng.rand(ch, cw) < 0.5).astype(np.uint32)
    buf = ((sgn << 31) | (m.astype(np.uint32) << (31 - KMAX))) \
        .astype(np.uint32)
    seg1, seg2 = encode_codeblock_multipass(buf, KMAX - 2, cw, ch,
                                            num_passes=passes,
                                            stripe_causal=causal)
    return dict(data=seg1 + seg2, len1=len(seg1), len2=len(seg2),
                mm=KMAX - 2, npasses=passes, causal=int(causal), w=w, h=h,
                cw=cw, ch=ch)


@functools.lru_cache(maxsize=None)
def _blocks_of_width(width):
    """The blocks declared ``width`` wide, each with
    decode_cleanup_refine's output, from one JAX call (the 15- and
    13-tall blocks share the 8-wide call through their lanes' true
    heights, as a height-merged group of the fused planner does)."""
    cases = [c for c in CASES if SHAPES[c[0]][0] == width]
    sel = [_block(*c) for c in cases]
    datas = [np.frombuffer(b['data'], np.uint8) for b in sel]
    lc = np.array([b['len1'] for b in sel], np.int64)
    sc = np.array([(int(d[n - 1]) << 4) + (int(d[n - 2]) & 0xF)
                   for d, n in zip(datas, lc)], np.int64)
    st = prep_cleanup_streams_np(datas, lc, sc)
    rs = prep_refine_streams_np(datas, lc,
                                np.array([b['len2'] for b in sel]))
    dec, err = decode_cleanup_refine(
        st['mel'], st['vlc'], st['ms'], rs['spp'], rs['mrp'],
        np.array([30 - b['mm'] for b in sel], np.int32),
        np.array([b['npasses'] for b in sel], np.int32),
        np.array([b['h'] for b in sel], np.int32),
        np.array([b['causal'] for b in sel], bool), width, 16)
    assert not np.asarray(err).any()
    dec = np.asarray(dec)
    for k, b in enumerate(sel):
        b['samples'] = dec[k, :b['h']].copy()
    return dict(zip(cases, sel))


def _case(name, passes, causal):
    return _blocks_of_width(SHAPES[name][0])[(name, passes, causal)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _port_cleanup(b, w, h):
    """The port's plain cleanup of one block at (w, h), from its own
    stream prep: dec, int32 [1, h, w]."""
    d = np.frombuffer(b['data'], np.uint8)
    lc = np.array([b['len1']], np.int64)
    sc = np.array([(int(d[b['len1'] - 1]) << 4)
                   + (int(d[b['len1'] - 2]) & 0xF)], np.int64)
    st = prep_cleanup_streams([b['data']], lc, sc)
    dec, err = pbd.decode_cleanup_core(
        *(torch.from_numpy(st[k].view(np.int32)) for k in ('mel', 'vlc',
                                                           'ms')),
        _t([30 - b['mm']]), w, h, _t([(h + 1) // 2]))
    assert not err.any()
    return dec


@pytest.mark.parametrize('name,passes,causal', CASES)
def test_plain_refine_takes_the_fused_significance(name, passes, causal):
    """The port's plain cleanup then its plain refine (the wrapper on CPU
    tensors) equal decode_cleanup_refine bit for bit, and the case is one
    of padding significance: the cleanup at the coded size has a nonzero
    sample in the padding column (row)."""
    b = _case(name, passes, causal)
    w, h = b['w'], b['h']
    full = _port_cleanup(b, b['cw'], b['ch'])[0].numpy()
    assert (full[:, w:] if b['cw'] > w else full[h:]).any()
    dec = _port_cleanup(b, w, h)
    rs = prep_refine_streams([b['data']], np.array([b['len1']]),
                             np.array([b['len2']]))
    got = R.refine(dec, torch.from_numpy(rs['spp'].view(np.int32)),
                   torch.from_numpy(rs['mrp'].view(np.int32)),
                   _t([30 - b['mm']]), _t([passes]), _t([h]),
                   _t([int(causal)]), w, h)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  b['samples'])


@pytest.mark.parametrize('name,passes,causal', CASES)
def test_native_oracle_stays_inside_the_block(name, passes, causal):
    """native.decode_codeblock equals the plain refine (so the sample
    after a significant padding column, (r + 1, 0), keeps its value), its
    padding row keeps the cleanup's samples, and nothing past the
    decoder's rows is written."""
    b = _case(name, passes, causal)
    w, h = b['w'], b['h']
    args = (b['data'], b['mm'], passes, b['len1'], b['len2'], w, h,
            causal)
    got = native.decode_codeblock(*args)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, b['samples'])
    rows = (h + 1) // 2 * 2
    guard = np.uint64(0xA5A5A5A5A5A5A5A5)
    bufs = []
    for npasses in (1, passes):
        buf = np.full((rows + 1) * w, guard, np.uint64)
        native._decode_codeblock_into(buf, *args[:2], npasses, *args[3:])
        assert (buf[rows * w:] == guard).all()
        bufs.append(buf[:rows * w].reshape(rows, w))
    np.testing.assert_array_equal(bufs[1][:h], b['samples'])
    np.testing.assert_array_equal(bufs[1][h:], bufs[0][h:])


def lanes_fixture() -> dict:
    """The arrays of refine_padding_lanes.npz, the layout of
    wide_multipass_codeblocks.npz: per lane its declared w, h, mm,
    npasses, causal, len1, len2; the coded bytes concatenated with their
    offsets; decode_cleanup_refine's samples concatenated with theirs."""
    blocks = [_case(*c) for c in CASES]
    out = {k: np.array([b[k] for b in blocks], np.int32)
           for k in ('w', 'h', 'mm', 'npasses', 'causal', 'len1', 'len2')}
    out['data'] = np.frombuffer(b''.join(b['data'] for b in blocks),
                                np.uint8)
    out['off'] = np.cumsum([0] + [len(b['data']) for b in blocks])
    out['samples'] = np.concatenate([b['samples'].ravel() for b in blocks])
    out['soff'] = np.cumsum([0] + [b['samples'].size for b in blocks])
    return out


def test_card_fixture_matches_the_jax_refine():
    with np.load(LANES_NPZ) as z:
        assert sorted(z.files) == sorted(lanes_fixture())
        for k, v in lanes_fixture().items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def damaged_stream() -> bytes:
    rng = np.random.RandomState(121)
    h, w = int(rng.randint(5, 16)) | 1, int(rng.randint(5, 16)) | 1
    plane = rng.randint(0, 16, (h, w)).astype(np.int32)
    s = bytearray(openjph_tpu.encode([plane], **DAMAGED_KWARGS))
    s[DAMAGED_FLIP[0]] ^= 1 << DAMAGED_FLIP[1]
    return bytes(s)


@functools.lru_cache(maxsize=None)
def _damaged():
    with open(DAMAGED, 'rb') as fh:
        return fh.read()


def test_damaged_stream_is_its_recipe():
    assert damaged_stream() == _damaged()


@pytest.mark.parametrize('resilient', [False, True])
def test_damaged_stream_decodes_as_decode_tpu(resilient, monkeypatch):
    """The port's CPU decode of the damaged stream equals decode_tpu.
    Strict decode_tpu takes its fused path; under resilience the JAX
    planner sends the multi-pass lanes of a damaged stream to its slow
    path, which refines them through decode_cleanup_refine as well but
    reconstructs on the host, unclipped, so it is compared clipped to 4
    bits.  Both accept the stream.  openjph_tpu.decode (its native host
    decoder) differs from them on HOST_DIFFERS samples, and equals them
    with the port's native oracle in place of its own: the whole
    difference is the padding significance of the 11x7 codeblock."""
    s = _damaged()
    got = openjph_tpu_torch.decode(s, device='cpu', resilient=resilient)
    want = openjph_tpu.decode_tpu(s, resilient=resilient)
    assert len(got) == len(want) == 1
    want = np.asarray(want[0])
    if resilient:
        want = np.clip(want, 0, 15)
    assert got[0].shape == want.shape == (7, 11)
    np.testing.assert_array_equal(got[0], want)
    if not resilient:
        host = np.clip(np.asarray(openjph_tpu.decode(s)[0]), 0, 15)
        assert int((host != got[0]).sum()) == HOST_DIFFERS
        import openjph_tpu.native as jax_native
        monkeypatch.setattr(jax_native, 'decode_codeblock',
                            native.decode_codeblock)
        host = np.clip(np.asarray(openjph_tpu.decode(s)[0]), 0, 15)
        np.testing.assert_array_equal(host, got[0])


def write_fixtures():
    np.savez_compressed(LANES_NPZ, **lanes_fixture())
    with open(DAMAGED, 'wb') as fh:
        fh.write(damaged_stream())


if __name__ == '__main__':
    write_fixtures()
