"""Damaged streams through the port's fused frame decode on the CPU, in
both runner modes: the contract of tests/test_truncated.py.  A stream
cut at 15 lengths, or with 8 bytes flipped inside a codeblock, decodes
under ``resilient=True`` to full-size planes equal to the JAX package's
host decoder (openjph_tpu.decode(..., resilient=True)), clipped to the
sample range as the fused paths clip; strict decode raises ValueError /
EOFError or returns full-size planes, never NotImplementedError.  Cut
and flipped multi-pass streams hold the refinement decoder to the same
contract on lanes whose cleanup pass failed.

Also: the Tier-2 record arrays that the planner reads equal the JAX
package's object-mode parse of the same bytes; the reference's pass-count
clamp order; warning 0x00080006 once per decode; and the committed
resilient reference of openjph_tpu_torch/testdata/.

One CPU decode of the 256x256 stream takes most of a second, so the cut
test runs all 15 cuts in raw mode and three of them (3, 8, 13) in dense
mode.
"""
import io
import os
import warnings

import numpy as np
import pytest

from openjph_tpu import codec as jcodec
from openjph_tpu import decode, encode
from openjph_tpu.core import message as jmsg

import openjph_tpu_torch
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.gpu import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')
W = H = 256
NUM_CUTS = 16


@pytest.fixture(scope='module')
def full_stream():
    # tests/test_truncated.py's stream
    x = np.arange(W)[None, :]
    y = np.arange(H)[:, None]
    img = ((x * 7 + y * 13 + ((x * y) >> 3)) & 0xFF).astype(np.int32)
    s = encode(img, reversible=True, num_decomps=5, block_size=(64, 64))
    assert len(s) > NUM_CUTS * 64
    return img, s


@pytest.fixture(autouse=True)
def _quiet():
    # a damaged codestream is expected to be noisy
    old, jold = msg._level, jmsg._level
    msg.set_message_level(msg.NO_MSG)
    jmsg.set_message_level(jmsg.NO_MSG)
    yield
    msg._level, jmsg._level = old, jold


def _mixed(seed, h, w):
    """tests/test_torch_multipass.py's image: noise, half of it zero."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w)).astype(np.int32)
    img[rng.rand(h, w) < 0.5] = 0
    return img


# tests/test_torch_multipass.py's 3-pass and 2-pass stripe-causal streams
MULTIPASS = {
    'p3': lambda: encode(_mixed(2, 64, 64), reversible=True, num_decomps=1,
                         ht_passes=3, block_size=(32, 32)),
    'p2_causal': lambda: encode(_mixed(3, 64, 64), reversible=True,
                                num_decomps=1, ht_passes=2, vert_causal=True,
                                block_size=(32, 32)),
}


def _host(part, **kw):
    """The reference: the host decoder, clipped as the fused paths clip."""
    return [np.clip(p, 0, 255) for p in decode(part, resilient=True, **kw)]


def _check(part, raw, skip_res=0):
    """Resilient decode equals the reference; strict decode raises a
    sanctioned error or returns full-size planes.  Returns whether
    strict mode detected the damage."""
    ref = _host(part, skip_res=skip_res) if skip_res == 0 \
        else decode(part, resilient=True, skip_res=skip_res)
    got = openjph_tpu_torch.decode(part, device='cpu', skip_res=skip_res,
                                   resilient=True, raw=raw)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    try:
        strict = openjph_tpu_torch.decode(part, device='cpu',
                                          skip_res=skip_res, raw=raw)
    except (ValueError, EOFError):
        return True
    assert [g.shape for g in strict] == [r.shape for r in ref]
    return False


def _flips(s, start):
    """tests/test_truncated.py's byte flips: 8 bytes ^ 0xA5 at offsets
    from ``start`` in steps of 97."""
    for off in range(start, len(s) - 64, 97):
        bad = bytearray(s)
        for j in range(8):
            bad[off + j] ^= 0xA5
        yield off, bytes(bad)


def _first_detected_flip(s):
    """The first flip from 3/4 of the stream on that the host decoder's
    strict mode rejects (tests/test_truncated.py's search, with the host
    decoder as the detector)."""
    for off, bad in _flips(s, len(s) * 3 // 4):
        try:
            decode(bad)
        except (ValueError, EOFError):
            return off, bad
    pytest.fail('no byte flip was detected')


@pytest.mark.parametrize('raw,cuts', [(True, range(1, NUM_CUTS)),
                                      (False, (3, 8, 13))],
                         ids=['raw', 'dense'])
def test_every_cut_decodes_as_the_host_decoder(full_stream, raw, cuts):
    _, s = full_stream
    detected = 0
    for cut in cuts:
        part = s[:len(s) * cut // NUM_CUTS]
        detected += _check(part, raw)
    assert detected > 0


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_complete_stream_decodes_in_both_modes(raw):
    img = _mixed(4, 48, 40)
    s = encode(img, reversible=True, num_decomps=2)
    for resilient in (False, True):
        got = openjph_tpu_torch.decode(s, device='cpu', raw=raw,
                                       resilient=resilient)
        assert np.array_equal(got[0], img)


def test_byte_flip_zeroes_the_broken_block(full_stream):
    """Strict raises ValueError from the kernels' error flags; resilient
    equals the reference in both runner modes, with the flagged lanes
    zeroed by the runner."""
    _, s = full_stream
    _, bad = _first_detected_flip(s)
    with pytest.raises(ValueError, match='U_q exceeds'):
        openjph_tpu_torch.decode(bad, device='cpu')
    ref = _host(bad)
    for raw in (True, False):
        d = openjph_tpu_torch.GpuDecoder(bad, device='cpu', raw=raw,
                                         resilient=True)
        got = d.decode()
        assert got[0].shape == (H, W)
        assert np.array_equal(got[0], ref[0])
        assert d.zeroed[1] > 0


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
@pytest.mark.parametrize('name', list(MULTIPASS))
def test_damaged_multipass_streams_decode_as_the_host_decoder(name, raw):
    """Cuts and a detected flip of a multi-pass stream: the refinement
    decoder runs on the damaged groups, lanes whose cleanup failed
    included, before the runner zeroes them."""
    s = MULTIPASS[name]()
    for k in (3, 5, 7):
        _check(s[:len(s) * k // 8], raw)
    _, bad = _first_detected_flip(s)
    plan = tp._build_plan(tp.GpuDecoder(bad, device='cpu', resilient=True))
    assert plan.has_refine
    assert _check(bad, raw)


def test_resilient_skip_res(full_stream):
    _, s = full_stream
    _check(s[:len(s) // 2], True, skip_res=1)


def _coded_fields(cb):
    if cb is None or (cb.num_passes == 0 and not cb.data
                      and cb.pass_length[0] == 0):
        return None
    return (cb.missing_msbs, cb.num_passes, tuple(cb.pass_length),
            bytes(cb.data or b''))


def _assert_parses_agree(part):
    rec = tp.GpuDecoder(part, device='cpu', resilient=True)
    rec._materialize_coded()
    obj = jcodec.Decoder(part, resilient=True)
    n = 0
    for st, jst in zip(rec.tiles, obj.tiles):
        for per_res, jper_res in zip(st.coded, jst.coded):
            for per_band, jper_band in zip(per_res, jper_res):
                for band, jband in zip(per_band, jper_band):
                    assert (band is None) == (jband is None)
                    for cb, jcb in zip(band or (), jband or ()):
                        assert _coded_fields(cb) == _coded_fields(jcb)
                        n += 1
    return n


def test_record_parse_equals_object_parse(full_stream):
    """Under resilience, on every cut and flip of this file, the
    port's Tier-2 record arrays materialise to the
    CodedBlocks of the JAX package's object-mode resilient parse."""
    _, s = full_stream
    parts = [s[:len(s) * cut // NUM_CUTS] for cut in range(1, NUM_CUTS)]
    parts.append(_first_detected_flip(s)[1])
    for build in MULTIPASS.values():
        m = build()
        parts += [m[:len(m) * k // 8] for k in (3, 5, 7)]
        parts.append(_first_detected_flip(m)[1])
    assert sum(_assert_parses_agree(p) for p in parts) > 0


def _first_live_row(dec):
    """(record rows, index, (tile, comp, res, band)) of the first live
    codeblock of a parse."""
    for ti, st in enumerate(dec.tiles):
        for (c, r), recs in st.rec.items():
            for b, (rb, _) in recs.items():
                for i in range(rb.shape[0]):
                    if rb[i, 4] and rb[i, 1] and rb[i, 2] and rb[i, 5]:
                        return rb, i, (ti, c, r, b)
    raise AssertionError('no live codeblock')


def test_pass_count_clamps_in_the_reference_order():
    """A record of 4 passes with no refinement bytes is one pass
    (coding/decoder.py:193-196 clamps before the more-than-3 check):
    the lane is planned live with one pass, and the frame decodes as the
    host decoder decodes the same edit of its CodedBlock."""
    img = _mixed(5, 48, 40)
    s = encode(img, reversible=True, num_decomps=2)
    d = tp.GpuDecoder(s, device='cpu')
    rb, i, (ti, c, r, b) = _first_live_row(d)
    assert rb[i, 1] == 1
    rb[i, 1], rb[i, 3] = 4, 0
    plan = tp._build_plan(d)
    assert plan.broken == 0
    live = plan.lanes[0] >= 0
    assert np.all(plan.lanes[5][live] == 1)
    got = d._decode_fast(plan)
    jd = jcodec.Decoder(s)
    cb = jd.tiles[ti].coded[c][r][b][i]
    cb.num_passes, cb.pass_length[1] = 4, 0
    ref = jd.decode()
    assert np.array_equal(ref[0], img)
    assert np.array_equal(got[0], ref[0])


def test_broken_lane_raises_or_is_zeroed_with_one_warning(full_stream):
    """A lane the host decoder rejects (lcup < 2) raises its ValueError
    in strict mode; under resilience it is zeroed with the kernels'
    flagged lanes, and 0x00080006 is issued once for the decode."""
    _, s = full_stream
    _, bad = _first_detected_flip(s)
    d = tp.GpuDecoder(bad, device='cpu')
    rb, i, _ = _first_live_row(d)
    rb[i, 2] = 1
    with pytest.raises(ValueError, match='wrong codeblock length'):
        d.decode()
    d = tp.GpuDecoder(bad, device='cpu', resilient=True)
    rb, i, _ = _first_live_row(d)
    rb[i, 2] = 1
    msg.set_message_level(msg.INFO)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        got = d.decode()
    codes = [str(w.message) for w in seen if '0x00080006' in str(w.message)]
    assert len(codes) == 1
    assert d.zeroed[0] == 1 and d.zeroed[1] > 0
    assert got[0].shape == (H, W)


CAUSAL = 'gray_512x256_rev_p2_causal.j2c'
CAUSAL_REF = 'gray_512x256_rev_p2_causal_resilient.npz'


def causal_reference():
    """The clipped host decode, under resilience, of three cuts of the
    2-pass stripe-causal fixture (testdata/README.md)."""
    with open(os.path.join(TESTDATA, CAUSAL), 'rb') as fh:
        s = fh.read()
    out = {}
    for k in (1, 2, 3):
        n = len(s) * k // 4
        out[f'cut_{n}'] = np.clip(decode(s[:n], resilient=True)[0], 0,
                                  255).astype(np.uint8)
    return out


def test_committed_resilient_reference_is_the_host_decode():
    want = causal_reference()
    with np.load(os.path.join(TESTDATA, CAUSAL_REF)) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.uint8
            assert np.array_equal(z[k], v)


if __name__ == '__main__':
    # writes the committed reference (testdata/README.md)
    buf = io.BytesIO()
    np.savez_compressed(buf, **causal_reference())
    with open(os.path.join(TESTDATA, CAUSAL_REF), 'wb') as fh:
        fh.write(buf.getvalue())
