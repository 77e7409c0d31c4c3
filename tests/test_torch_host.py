"""The port's copied host layer held against the JAX package's on the
same streams: decoder tables, Tier-2's record tables, the planner (key and
per-lane arrays) and both packers (raw-bytes blob + meta, dense words +
meta, and the refine meta of multi-pass streams).  A codec carries no weights; these are the state the port takes
over from the reference.  The JAX planner pads lane groups to multiples
of 8 on the CPU, as the port does everywhere.  The raw-bytes buffer is
held equal in a fresh buffer and in a reused one that starts out full of
0xAB and takes a larger burst before a smaller one, the latter also
written by the native library's threads in parts; a damaged stream
decoded under resilience has broken lanes, packed as dead lanes are: the
byte 0x0F, then zeros.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from openjph_tpu import encode
from openjph_tpu.coding.tables import get_tables as jax_tables
from openjph_tpu.tpu import pipeline as jp

from openjph_tpu_torch.coding.tables import get_tables
from openjph_tpu_torch import native
from openjph_tpu_torch.gpu import pipeline as tp


def _img(rng, h, w, noise=60):
    """Ramp with noisy rows: smooth and busy codeblocks, and enough
    0xFF / 0x7F coded bytes to exercise bit stuffing."""
    ramp = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None]) % 256
    img = ramp + rng.randint(-noise, noise + 1, (h, w)) \
        * ((np.arange(h)[:, None] // 4) % 2)
    return np.clip(img, 0, 255).astype(np.int32)


def _cases():
    rng = np.random.RandomState(21)
    g = _img(rng, 72, 90)
    rgb = [_img(rng, 40, 52) for _ in range(3)]
    return {
        'gray53': (encode([g], reversible=True, num_decomps=3,
                          block_size=(32, 32)), 0),
        'rct_tiles': (encode(rgb, reversible=True, num_decomps=2,
                             tile_size=(32, 24), block_size=(16, 16)), 0),
        'ict97': (encode(rgb, reversible=False, num_decomps=2,
                         block_size=(16, 32)), 0),
        'skip1': (encode([g], reversible=True, num_decomps=3,
                         block_size=(16, 16)), 1),
        'multipass': (encode([g], reversible=True, num_decomps=2,
                             ht_passes=3), 0),
        'damaged': (_damaged(encode([g], reversible=True, num_decomps=3,
                                    block_size=(32, 32))), 0),
    }


def _damaged(stream):
    """``stream`` with the last cleanup byte of every third live lane set
    to 0xFF: its scup reads above 4079, so the planner finds those
    codeblocks broken (strict decode raises, resilient decode plans them
    dead)."""
    plan = tp._build_plan(tp.GpuDecoder(stream, device='cpu'))
    pos, lcup = plan.lanes[:2]
    bad = bytearray(stream)
    for i in np.flatnonzero(pos >= 0)[1::3]:
        bad[pos[i] + lcup[i] - 1] = 0xFF
    return bytes(bad)


@pytest.fixture(scope='module')
def cases():
    return _cases()


def _decoders(stream, skip, resilient=False):
    kw = dict(skipped_res_for_read=skip, skipped_res_for_recon=skip,
              resilient=resilient)
    return (jp.TpuDecoder(stream, **kw),
            tp.GpuDecoder(stream, device='cpu', **kw))


def _out(kind, monkeypatch):
    """Where the raw pack writes: None (a fresh buffer), or a reused
    host buffer that already holds 0xAB bytes, more than a test burst
    needs; split, the reused buffer written by the native library's
    threads in parts of 64 bytes and more, as a burst of megabytes is."""
    if kind == 'fresh':
        return None
    if kind == 'split':
        monkeypatch.setattr(native, 'PACK_PART_BYTES', 64)
    out = tp._HostBuffer()
    out.take(1 << 20).view(np.uint8).fill(0xAB)
    return out


def _pack_raw(pairs, out):
    """tp._pack_device's buffer; a reused one is a view of ``out``."""
    (buf,) = tp._pack_device(pairs, out)
    if out is not None:
        assert np.shares_memory(buf, out.take(buf.nbytes))
    return buf


def _norm(x):
    """Plan keys of both packages in one comparable form (each package
    has its own AtkKernel class)."""
    if hasattr(x, 'steps') and hasattr(x, 'reversible'):
        return ('atk', x.index, x.reversible, tuple(x.steps), x.K)
    if isinstance(x, np.ndarray):
        return ('arr', x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_norm(v) for v in x)
    return x


def test_tables_match_jax():
    mine, ref = get_tables(), jax_tables()
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert np.array_equal(np.asarray(mine[k]), np.asarray(ref[k])), k
        assert np.asarray(mine[k]).dtype == np.asarray(ref[k]).dtype, k


@pytest.mark.parametrize('name', ['gray53', 'rct_tiles', 'ict97', 'skip1',
                                  'multipass'])
def test_tier2_records_and_plan_match_jax(cases, name):
    stream, skip = cases[name]
    jd, td = _decoders(stream, skip)
    for js, ts in zip(jd.tiles, td.tiles):
        assert sorted(js.rec) == sorted(ts.rec)
        for k in js.rec:
            for b in js.rec[k]:
                assert np.array_equal(js.rec[k][b][0], ts.rec[k][b][0])
                assert np.array_equal(js.rec[k][b][1], ts.rec[k][b][1])
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    assert jplan is not None and tplan is not None
    assert _norm(tplan.key) == _norm(jplan.key)
    assert _norm(tplan.placements) == _norm(jplan.placements)
    assert tplan.has_refine == jplan.has_refine == (name == 'multipass')
    assert [g.n_pad % 8 for g in tplan.groups] == [0] * len(tplan.groups)
    for a, b in zip(tplan.lanes, jplan.lanes):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('out', ['fresh', 'reused', 'split'])
@pytest.mark.parametrize('name', ['gray53', 'rct_tiles', 'ict97', 'skip1',
                                  'damaged'])
def test_packers_match_jax(cases, name, out, monkeypatch):
    stream, skip = cases[name]
    jd, td = _decoders(stream, skip, resilient=name == 'damaged')
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    assert (tplan.broken > 0) == (name == 'damaged')
    # raw-bytes blob + meta: equal wherever the JAX packer returns one
    r = jp._pack_device([(jd, jplan)])
    assert r is not None
    (jbuf,), _ = r
    tbuf = _pack_raw([(td, tplan)], _out(out, monkeypatch))
    assert tbuf.dtype == jbuf.dtype and np.array_equal(tbuf, jbuf)
    # dead lanes (qhl 0): the byte 0x0F, then zeros to the range's end
    n = tplan.lanes[0].shape[0]
    meta = tbuf[-8 * n:].view(np.int32).reshape(n, 8)
    blob = tbuf.view(np.uint8)
    dead = np.flatnonzero(meta[:, 7] == 0)
    assert dead.size >= tplan.broken
    for at, ms, sh in meta[dead, :3]:
        assert blob[at] == 0x0F and not blob[at + 1:at + ms + sh].any()
    # dense words + meta, native and numpy packers
    for a, b in zip(tp._pack_burst_fast([(td, tplan)]),
                    jp._pack_burst_fast([(jd, jplan)])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tp._pack_burst([td._group_arrays(tplan)]),
                    jp._pack_burst([jd._group_arrays(jplan)])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('out', ['fresh', 'reused', 'split'])
def test_two_frame_pack_matches_jax(cases, out, monkeypatch):
    """Two frames, then one into the same buffer where it is reused."""
    stream, _ = cases['gray53']
    jd, td = _decoders(stream, 0)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    out = _out(out, monkeypatch)
    for n in (2, 1):
        (jbuf,), _ = jp._pack_device([(jd, jplan)] * n)
        tbuf = _pack_raw([(td, tplan)] * n, out)
        assert np.array_equal(tbuf, jbuf)


def test_split_packs_from_two_threads_match_jax(cases, monkeypatch):
    """Two threads that pack in parts at once take turns on the native
    library's kept threads: every buffer equals the JAX package's."""
    stream, _ = cases['gray53']
    jd, td = _decoders(stream, 0)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    (want,), _ = jp._pack_device([(jd, jplan)] * 2)
    monkeypatch.setattr(native, 'PACK_PART_BYTES', 64)

    def packs(_):
        out = tp._HostBuffer()
        return all(np.array_equal(_pack_raw([(td, tplan)] * 2, out), want)
                   for _ in range(20))

    with ThreadPoolExecutor(2) as ex:
        assert all(ex.map(packs, range(2)))


@pytest.mark.parametrize('out', ['fresh', 'reused', 'split'])
def test_multipass_pack_raises(cases, out, monkeypatch):
    """Multi-pass streams no longer raise: both packers give buffers
    byte-identical to the JAX package's, the refine meta plane (rmeta)
    included, for one frame and for two."""
    stream, _ = cases['multipass']
    jd, td = _decoders(stream, 0)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    assert tplan.has_refine
    out = _out(out, monkeypatch)
    for n in (1, 2):
        r = jp._pack_device([(jd, jplan)] * n)
        assert r is not None
        (jbuf,), _ = r
        tbuf = _pack_raw([(td, tplan)] * n, out)
        assert tbuf.dtype == jbuf.dtype and np.array_equal(tbuf, jbuf)
        want = jp._pack([(jd, jplan)] * n)
        got = tp._pack_dense([(td, tplan)] * n)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
