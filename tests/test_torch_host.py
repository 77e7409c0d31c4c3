"""The port's copied host layer held against the JAX package's on the
same streams: decoder tables, Tier-2's record tables, the planner (key and
per-lane arrays) and both packers (raw-bytes blob + meta, dense words +
meta, and the refine meta of multi-pass streams).  A codec carries no weights; these are the state the port takes
over from the reference.  The JAX planner pads lane groups to multiples
of 8 on the CPU, as the port does everywhere.
"""
import numpy as np
import pytest

from openjph_tpu import encode
from openjph_tpu.coding.tables import get_tables as jax_tables
from openjph_tpu.tpu import pipeline as jp

from openjph_tpu_torch.coding.tables import get_tables
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
    }


@pytest.fixture(scope='module')
def cases():
    return _cases()


def _decoders(stream, skip):
    kw = dict(skipped_res_for_read=skip, skipped_res_for_recon=skip)
    return (jp.TpuDecoder(stream, **kw),
            tp.GpuDecoder(stream, device='cpu', **kw))


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


@pytest.mark.parametrize('name', ['gray53', 'rct_tiles', 'ict97', 'skip1'])
def test_packers_match_jax(cases, name):
    stream, skip = cases[name]
    jd, td = _decoders(stream, skip)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    # raw-bytes blob + meta: equal wherever the JAX packer returns one
    r = jp._pack_device([(jd, jplan)])
    assert r is not None
    (jbuf,), _ = r
    (tbuf,) = tp._pack_device([(td, tplan)])
    assert tbuf.dtype == jbuf.dtype and np.array_equal(tbuf, jbuf)
    # dense words + meta, native and numpy packers
    for a, b in zip(tp._pack_burst_fast([(td, tplan)]),
                    jp._pack_burst_fast([(jd, jplan)])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tp._pack_burst([td._group_arrays(tplan)]),
                    jp._pack_burst([jd._group_arrays(jplan)])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_two_frame_pack_matches_jax(cases):
    stream, _ = cases['gray53']
    jd, td = _decoders(stream, 0)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    (jbuf,), _ = jp._pack_device([(jd, jplan), (jd, jplan)])
    (tbuf,) = tp._pack_device([(td, tplan), (td, tplan)])
    assert np.array_equal(tbuf, jbuf)


def test_multipass_pack_raises(cases):
    """Multi-pass streams no longer raise: both packers give buffers
    byte-identical to the JAX package's, the refine meta plane (rmeta)
    included, for one frame and for two."""
    stream, _ = cases['multipass']
    jd, td = _decoders(stream, 0)
    jplan, tplan = jp._build_plan(jd), tp._build_plan(td)
    assert tplan.has_refine
    for n in (1, 2):
        r = jp._pack_device([(jd, jplan)] * n)
        assert r is not None
        (jbuf,), _ = r
        (tbuf,) = tp._pack_device([(td, tplan)] * n)
        assert tbuf.dtype == jbuf.dtype and np.array_equal(tbuf, jbuf)
        want = jp._pack([(jd, jplan)] * n)
        got = tp._pack_dense([(td, tplan)] * n)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
