"""Tier-2 in one native call a tile-part (codec.Decoder._walk, native
t2_walk_tile_part) held to the JAX package's per-packet parser (the
same record tables filled a packet at a time through
openjph_tpu.core.t2.parse_precinct): after every tile-part, both record
tables and the tile's next packet are equal, and a malformed packet
raises the same exception with the same message, strict and resilient.
Then the planner's native pass (native.plan_lanes) on records edited
into the cases the host decoder's checks reject: the first broken lane
in group-then-lane order names the error, resilience counts them, and
one live lane of 30 or more missing MSBs turns its group to 64 bits.
Streams come from the JAX package's encoder on the CPU."""
import numpy as np
import pytest

from openjph_tpu import codec as jcodec
from openjph_tpu import encode
from openjph_tpu.core import markers as jmk
from openjph_tpu.core.t2 import parse_precinct
from openjph_tpu.tpu import pipeline as jp

from openjph_tpu_torch import codec
from openjph_tpu_torch.core.t2 import precinct_iterator
from openjph_tpu_torch.gpu import pipeline as tp


def _img(seed, h, w, bd=8):
    rng = np.random.RandomState(seed)
    ramp = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None]) % 256
    noise = rng.randint(-60, 61, (h, w)) * ((np.arange(h)[:, None] // 4) % 2)
    img = np.clip(ramp + noise, 0, 255).astype(np.int64)
    return img << (bd - 8)


def _rgb(seed, h, w):
    return [_img(seed + c, h, w) for c in range(3)]


def _sop_eph(seed):
    """SOP before and EPH after every packet header (Scod bits 1, 2)."""
    enc = jcodec.build_encoder((40, 44), 3, reversible=True, num_decomps=2,
                               block_size=(16, 16), tile_size=(24, 24),
                               tileparts='R')
    enc.cod.scod |= 6
    return enc.encode(_rgb(seed, 40, 44))


def _dfs(seed):
    """Part-2 DFS: a horizontal-only, a vertical-only and a two-way
    level."""
    siz = jmk.Siz()
    siz.xsiz, siz.ysiz = 32, 32
    siz.comps = [jmk.CompInfo(8, False, 1, 1)]
    dfs = jmk.Dfs.from_types(0, [jmk.Dfs.HORZ_DWT, jmk.Dfs.VERT_DWT,
                                 jmk.Dfs.BIDIR_DWT])
    cod = jmk.Cod(num_decomps=3, wavelet_kern=jmk.DWT_REV53)
    cocs = {0: jmk.Cod(num_decomps=3, wavelet_kern=jmk.DWT_REV53,
                       comp_idx=0, dfs_idx=0)}
    return jcodec.Encoder(siz, cod, cocs=cocs, dfs_list=[dfs]).encode(
        [_img(seed, 32, 32).astype(np.int32)])


PRECINCTS = [(16, 16)]
# name -> (stream builder, skip_res)
STREAMS = {
    **{f'po_{po}': (lambda po=po: encode(
        _rgb(1, 40, 52), reversible=True, num_decomps=2,
        block_size=(16, 16), prog_order=po, precincts=PRECINCTS), 0)
       for po in ('LRCP', 'RLCP', 'RPCL', 'PCRL', 'CPRL')},
    'tiles_r': (lambda: encode(_rgb(2, 40, 52), reversible=True,
                               num_decomps=2, tile_size=(32, 24),
                               block_size=(16, 16), tileparts='R'), 0),
    'tiles_rc': (lambda: encode(_rgb(3, 40, 52), reversible=False,
                                num_decomps=2, tile_size=(24, 32),
                                block_size=(16, 16), prog_order='LRCP',
                                tileparts='RC'), 0),
    'tiles_c': (lambda: encode(_rgb(4, 40, 52), reversible=True,
                               num_decomps=2, tile_size=(32, 32),
                               block_size=(16, 16), prog_order='CPRL',
                               tileparts='C'), 0),
    'sop_eph': (lambda: _sop_eph(5), 0),
    'skip1': (lambda: encode([_img(6, 72, 90)], reversible=True,
                             num_decomps=3, block_size=(16, 16)), 1),
    'skip2': (lambda: encode(_rgb(7, 40, 52), reversible=True,
                             num_decomps=3, block_size=(16, 16),
                             precincts=PRECINCTS, prog_order='PCRL'), 2),
    'dfs': (lambda: _dfs(8), 0),
    'passes3': (lambda: encode([_img(9, 48, 40)], reversible=True,
                               num_decomps=2, ht_passes=3), 0),
    'kmax31': (lambda: encode([_img(10, 24, 32, bd=32)], reversible=True,
                              num_decomps=1, bit_depth=32,
                              block_size=(16, 16)), 0),
    # small enough to cut at every byte: two tiles of three tile-parts
    'small': (lambda: encode([_img(13, 20, 24)], reversible=True,
                             num_decomps=2, block_size=(8, 8),
                             tile_size=(16, 12), tileparts='R'), 0),
}


@pytest.fixture(scope='module')
def streams():
    return {k: (build(), skip) for k, (build, skip) in STREAMS.items()}


class _Logged(codec.Decoder):
    """A decoder that logs each tile-part's outcome: (tile, next packet,
    exception type and message, both record tables)."""

    def __init__(self, data, **kw):
        self.log = []
        super().__init__(data, **kw)

    def _parse_one_tile_part(self, st, pos, data_left):
        err = None
        try:
            super()._parse_one_tile_part(st, pos, data_left)
        except (ValueError, EOFError) as e:
            err = e
            raise
        finally:
            self.log.append((st.geom.idx, st.next_packet,
                             None if err is None else type(err),
                             None if err is None else str(err),
                             st.rec_table.copy(), st.rec_pos.copy()))


class _PerPacket(_Logged):
    """The same tables filled a packet at a time by the JAX package's
    parser."""

    def _walk(self, st, pos, data_left):
        seq, _ = st.walk.packets(self.hdr, self.skip_read)
        while data_left > 0 and st.next_packet < len(seq):
            c, r, pidx, skip = seq[st.next_packet]
            st.next_packet += 1
            cod = self.hdr.get_cod(c)
            pos, data_left = parse_precinct(
                st.geom.comps[c].resolutions[r], pidx, None, self.data,
                pos, data_left, cod.uses_sop, cod.uses_eph,
                skip_data=skip, records=st.rec[(c, r)])


def _parse(cls, data, **kw):
    """(log, error) of a parse: the decoder's tile-part log and the
    (type, message) it raised, if any."""
    dec = cls.__new__(cls)
    try:
        cls.__init__(dec, data, **kw)
    except (ValueError, EOFError) as e:
        return dec.log, (type(e), str(e))
    return dec.log, None


def _assert_same_parse(data, **kw):
    """The walker and the per-packet path agree on ``data``; returns the
    number of tile-parts compared."""
    (wlog, werr), (plog, perr) = (_parse(cls, data, **kw)
                                  for cls in (_Logged, _PerPacket))
    assert werr == perr
    assert len(wlog) == len(plog)
    for w, p in zip(wlog, plog):
        assert w[:4] == p[:4]
        assert w[4].dtype == p[4].dtype and np.array_equal(w[4], p[4])
        assert w[5].dtype == p[5].dtype and np.array_equal(w[5], p[5])
    return len(wlog)


@pytest.mark.parametrize('name', sorted(STREAMS))
def test_walker_equals_the_per_packet_parse(streams, name):
    data, skip = streams[name]
    n = 0
    for resilient in (False, True):
        n += _assert_same_parse(data, resilient=resilient,
                                skipped_res_for_read=skip,
                                skipped_res_for_recon=skip)
    dec = codec.Decoder(data, skipped_res_for_read=skip)
    assert n >= 2 * len(dec.tiles)
    # every packet of every tile was walked, and the walk's records are
    # the view the readers take
    for st in dec.tiles:
        seq, table = st.walk.packets(dec.hdr, skip)
        assert st.next_packet == len(seq) == table.shape[0]
        assert [q[:3] for q in seq] == list(
            precinct_iterator(st.geom, dec.hdr.cod.prog_order))
        for (c, r), bands in st.rec.items():
            for b, (rows, poss) in bands.items():
                o = st.walk.layout[(c, r, b)]
                assert np.shares_memory(rows, st.rec_table)
                assert np.array_equal(rows, st.rec_table[o:o + len(rows)])
                assert np.array_equal(poss, st.rec_pos[o:o + len(poss)])


def test_walker_equals_the_per_packet_parse_on_every_cut(streams):
    data, _ = streams['small']
    n = 0
    for cut in range(len(data) + 1):
        for resilient in (False, True):
            n += _assert_same_parse(data[:cut], resilient=resilient)
    assert n > len(data)


def test_walker_raises_the_per_packet_errors_on_flipped_bytes(streams):
    data, _ = streams['sop_eph']
    rng = np.random.RandomState(11)
    errors = set()
    for _ in range(200):
        bad = bytearray(data)
        at = rng.randint(len(data) // 4, len(data))
        bad[at] ^= 1 << rng.randint(8)
        for resilient in (False, True):
            _assert_same_parse(bytes(bad), resilient=resilient)
        errors.add(_parse(_Logged, bytes(bad))[1])
    assert len(errors) > 2   # no error, and some of the packet errors


# ---------------------------------------------------------------------------
# The planner's native pass
# ---------------------------------------------------------------------------

@pytest.fixture
def groups():
    """A frame of three lane groups (10-, 16- and 4-wide codeblocks): its
    decoder and each group's member lanes' (tile, record)."""
    s = encode([_img(12, 40, 40)], reversible=True, num_decomps=2,
               block_size=(16, 16))
    d = tp.GpuDecoder(s, device='cpu')
    skel = tp._plan_skeleton(d, None)
    assert len(skel.groups) == 3
    lt, li = skel.lane_map[:2]
    lanes, at = [], 0
    for g in skel.groups:
        lanes.append(list(zip(lt[at:at + g.nm], li[at:at + g.nm])))
        at += g.nm
    return d, lanes


def _live(d, lanes):
    """A group's member lanes whose records are live."""
    return [(t, i) for t, i in lanes
            if all(d.tiles[t].rec_table[i, k] for k in (1, 2, 4, 5))]


def test_first_broken_lane_in_group_then_lane_order(groups):
    d, (g0, g1, _) = groups
    (t0, i0), (t1, i1) = _live(d, g0)[-1], _live(d, g1)[0]
    # group 0's last live lane: 4 passes with refinement bytes
    r = d.tiles[t0].rec_table[i0]
    r[1], r[3], r[5] = 4, 1, r[2] + 1
    # group 1's first live lane: a cleanup segment of one byte
    d.tiles[t1].rec_table[i1, 2] = 1
    with pytest.raises(ValueError) as e:
        tp._build_plan(d)
    assert str(e.value) == 'more than 3 coding passes not supported'
    r[1], r[3], r[5] = 1, 0, r[2]
    with pytest.raises(ValueError) as e:
        tp._build_plan(d)
    assert str(e.value) == 'wrong codeblock length'


def test_resilient_plan_counts_and_kills_broken_lanes(groups):
    d, (g0, g1, _) = groups
    want = tp._build_plan(d)
    d.resilient = True
    broken = [_live(d, g0)[0], _live(d, g0)[2], _live(d, g1)[1]]
    for t, i in broken:
        d.tiles[t].rec_table[i, 2] = 1
    plan = tp._build_plan(d)
    assert plan.broken == 3 and want.broken == 0
    assert plan.key == want.key
    dead = (want.lanes[0] >= 0) & (plan.lanes[0] < 0)
    assert int(dead.sum()) == 3
    for a, b in zip(plan.lanes, want.lanes):
        assert np.array_equal(a[~dead], b[~dead])


def test_one_live_lane_past_29_missing_msbs_widens_its_group(groups):
    d, (g0, g1, _) = groups
    want = tp._build_plan(d)
    assert [g.bits for g in want.groups] == [32, 32, 32]
    t, i = _live(d, g1)[0]
    mm = int(d.tiles[t].rec_table[i, 0])
    d.tiles[t].rec_table[i, 0] = 30
    plan = tp._build_plan(d)
    assert [g.bits for g in plan.groups] == [32, 64, 32]
    n0, n1 = plan.groups[0].n_pad, plan.groups[1].n_pad
    # every lane of the group moves up by 32, the raised one to 62 - 30
    p = want.lanes[3].copy()
    p[n0:n0 + n1] += 32
    lane = n0 + [k for k, m in enumerate(g1) if (t, i) == m][0]
    p[lane] = 62 - 30
    assert np.array_equal(plan.lanes[3], p)
    assert want.lanes[3][lane] == 30 - mm
    # the same lane broken under resilience is dead: the group stays 32
    d.resilient = True
    d.tiles[t].rec_table[i, 2] = 1
    plan = tp._build_plan(d)
    assert [g.bits for g in plan.groups] == [32, 32, 32]
    assert plan.broken == 1


def test_a_frame_without_codeblocks_is_refused_as_before():
    """A header whose image offset lies past its width (a fuzzer's
    mutation) plans no lane: the planner refuses it with the JAX
    planner's error, in both runner modes, strict and resilient."""
    s = bytearray(encode([_img(14, 24, 20)], reversible=True,
                         num_decomps=2))
    at = s.index(b'\xff\x51') + 6   # SIZ: marker, Lsiz, Rsiz, then Xsiz
    s[at + 8:at + 12] = s[at:at + 4]  # XOsiz = Xsiz
    s = bytes(s)
    with pytest.raises(ValueError) as want:
        jp._build_plan(jp.TpuDecoder(s))
    for raw in (True, False):
        for resilient in (False, True):
            with pytest.raises(ValueError) as e:
                tp.decode_gpu(s, device='cpu', raw=raw,
                              resilient=resilient)
            assert str(e.value) == str(want.value)
