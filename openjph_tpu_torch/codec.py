"""Host halves of the HTJ2K codec.

Decode: markers -> geometry -> Tier-2 (each tile-part's packets walked
into flat record tables in one native call), and the final placement
of tile planes on the canvas.  Encode: marker segments and
quantization parameters, tile-part division and codestream assembly.

A copy of the JAX package's ``codec.py`` without its scalar Tier-1
paths and its packet-at-a-time Tier-2 parse (the structural flow of
ojph_codestream_local.cpp / ojph_tile.cpp).  The device halves live in
``gpu/pipeline.py`` (decode, multi-pass codeblocks included) and
``gpu/encode_pipeline.py`` (encode, cleanup pass only).
"""
from __future__ import annotations

import contextlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import native
from .core import markers as mk
from .core.message import error as _err, warn as _wrn
from .core.geometry import TileGeom, build_tile, build_tile_grid
from .core.profiles import check_broadcast, check_imf
from .core.quant import (COMP_Y, default_irrev_delta, make_irrev_qcd,
                         make_qfactor_qcd, make_rev_qcd)
from .core.t2 import _T2_ERRORS, CodedBlock, precinct_iterator
from .utils import trace
from .utils.cache import Cache


@dataclass
class _TileState:
    geom: TileGeom
    # Tier-2's tables of the tile, from the header alone (_TileWalk)
    walk: '_TileWalk' = None
    # coded[comp][res][band] -> list over the band codeblock grid, built
    # from the records by Decoder._materialize_coded
    coded: List[List[List[Optional[List[Optional[CodedBlock]]]]]] = \
        field(default_factory=list)
    # the tile's records, int32 [ncb, 6] of (mmsbs, num_passes, len0,
    # len1, included, nbytes) and int64 [ncb] data pos, bands in (comp,
    # res, band) order (walk.layout); rec[(c, r)][band] -> (rows, pos),
    # views of the band's part of the two
    rec_table: np.ndarray = None
    rec_pos: np.ndarray = None
    rec: dict = field(default_factory=dict)
    next_packet: int = 0     # the tile's next packet in codestream order


class _TileWalk:
    """What Tier-2 reads of one tile from the header alone: ``layout``,
    each band's first record in the tile's record tables ((comp, res,
    band) -> row, bands in that order), ``ncb`` records in all, and per
    ``skip_read`` the tile's packets in codestream order (``packets``)."""

    def __init__(self, geom: TileGeom):
        self.geom = geom
        self.layout: Dict[tuple, int] = {}
        self.res_bands = []   # ((c, r), ((band, first row, rows), ...))
        n = 0
        for c, comp in enumerate(geom.comps):
            for r, res in enumerate(comp.resolutions):
                bands = []
                for b in range(4):
                    sb = res.bands[b]
                    if sb is not None and not sb.empty:
                        k = sb.num_cb_x * sb.num_cb_y
                        self.layout[(c, r, b)] = n
                        bands.append((b, n, k))
                        n += k
                self.res_bands.append(((c, r), tuple(bands)))
        self.ncb = n
        self._packets = {}

    def packets(self, hdr, skip_read: int):
        """(sequence, table) of the tile's packets in codestream order
        (precinct_iterator): a (comp, res, precinct, skip_data) tuple a
        packet, and the native walker's int32 [npk, 36] rows
        (t2_walk_tile_part: the packet's band table, skip_data, SOP, EPH,
        its bands' first records, its codeblock count)."""
        ent = self._packets.get(skip_read)
        if ent is not None:
            return ent
        geom = self.geom
        seq = []
        for c, r, pidx in precinct_iterator(geom, hdr.cod.prog_order):
            comp = geom.comps[c]
            seq.append((c, r, pidx, r > comp.num_decomps
                        - min(skip_read, comp.num_decomps)))
        table = np.zeros((len(seq), 36), np.int32)
        for row, (c, r, pidx, skip) in zip(table, seq):
            res = geom.comps[c].resolutions[r]
            prec = res.precincts[pidx]
            cod = hdr.get_cod(c)
            n = 0
            for s in range(4):
                sb = res.bands[s]
                if sb is None or sb.empty:
                    continue
                bi = prec.bands[s]
                if bi.num_x == 0 or bi.num_y == 0:
                    continue
                row[7 * s:7 * s + 7] = (1, bi.num_x, bi.num_y, bi.org_x,
                                        bi.org_y, sb.num_cb_x, sb.kmax)
                row[31 + s] = self.layout[(c, r, s)]
                n += bi.num_x * bi.num_y
            row[28:31] = (skip, cod.uses_sop, cod.uses_eph)
            row[35] = n
        ent = self._packets[skip_read] = (seq, table)
        return ent


# Parsed-header + tile-geometry cache.  Geometry is a pure, immutable
# function of the main header bytes; steady-state video re-parses the
# same header every frame (the restart() reuse pattern,
# ojph_codestream.h:109-122), so share one geometry, and the tiles'
# Tier-2 tables (_TileWalk), across decoders.
_GEOM_CACHE = Cache(32)


def _cached_geometry(data, hdr):
    """(tile rects, tile geometries, their _TileWalks) of a header."""
    def make():
        tile_rects = build_tile_grid(hdr.siz)
        geoms = tuple(build_tile(hdr, i, tr)
                      for i, tr in enumerate(tile_rects))
        return tile_rects, geoms, tuple(_TileWalk(g) for g in geoms)

    return _GEOM_CACHE.get(bytes(data[:hdr.header_size]), make)


class _LazyTiles:
    """The tiles of a ``Decoder(..., lazy_tiles=True)``: the tile-parts
    are indexed once (a few ints a tile-part); ``tiles[i]`` builds tile
    i's geometry and parses its tile-parts each time it is asked for,
    except while ``held`` keeps the state.  A mosaic decoder holds one
    sub-batch of tiles at a time, so its memory is bounded by that
    sub-batch, not by the stream's tile count."""

    def __init__(self, dec: 'Decoder'):
        self._dec = dec
        self._spans: List[list] = [[] for _ in dec.tile_rects]
        for idx, pos, end in dec._tile_part_spans():
            self._spans[idx].append((pos, end))
        self._held: Dict[int, _TileState] = {}

    def __len__(self) -> int:
        return len(self._spans)

    def __getitem__(self, idx: int) -> _TileState:
        st = self._held.get(idx)
        if st is None:
            st = self._dec._load_tile(idx, self._spans[idx])
        return st

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @contextlib.contextmanager
    def held(self, tiles):
        """Keep the states of ``tiles`` while the block runs."""
        self._held = {i: self[i] for i in tiles}
        try:
            yield
        finally:
            self._held = {}


class Decoder:
    def __init__(self, data: bytes, resilient: bool = False,
                 skipped_res_for_read: int = 0,
                 skipped_res_for_recon: int = 0,
                 lazy_tiles: bool = False):
        """``lazy_tiles``: index the tile-parts, and build and parse a
        tile only when ``self.tiles[i]`` asks for it (_LazyTiles), so
        that the decoder's memory does not grow with the tile count."""
        self.data = data
        self.resilient = resilient
        self.hdr = mk.read_main_header(data)
        self.skip_read = skipped_res_for_read
        self.skip_recon = min(skipped_res_for_recon, skipped_res_for_read) \
            if skipped_res_for_recon else skipped_res_for_read
        # restrict_input_resolution semantics
        # (ojph_codestream.h:288-306): skip_res_for_read >= for_recon
        # Tier-2 fills each tile's flat numpy record tables, a tile-part
        # in one native call (_walk; the fused device path consumes the
        # tables; CodedBlocks materialize on demand).  Under resilience
        # the native parser writes a packet's records only once the
        # whole packet parsed, and turns a codeblock cut off by the end
        # of data into a dead record.
        if lazy_tiles:
            self.tile_rects = build_tile_grid(self.hdr.siz)
            self.tiles = _LazyTiles(self)
            return
        self.tile_rects, _, walks = _cached_geometry(data, self.hdr)
        self.tiles: List[_TileState] = [self._new_tile(w) for w in walks]
        self._parse_tile_parts()

    def _new_tile(self, walk: _TileWalk) -> _TileState:
        """An empty state of the tile whose Tier-2 tables are ``walk``."""
        st = _TileState(walk.geom, walk)
        st.rec_table = rows = np.zeros((walk.ncb, 6), np.int32)
        st.rec_pos = poss = np.zeros(walk.ncb, np.int64)
        for cr, bands in walk.res_bands:
            st.rec[cr] = {b: (rows[o:o + k], poss[o:o + k])
                          for b, o, k in bands}
        return st

    def _load_tile(self, idx: int, spans) -> _TileState:
        """Tile ``idx``'s state, its geometry built and its tile-parts
        ``spans`` ((start, end) of each payload, in stream order) parsed:
        a lazy decoder's tile (_LazyTiles)."""
        st = self._new_tile(_TileWalk(
            build_tile(self.hdr, idx, self.tile_rects[idx])))
        for pos, end in spans:
            self._parse_span(st, pos, end)
        return st

    # -- Tier-2 ------------------------------------------------------------
    def _parse_tile_parts(self):
        """SOT/tile-part loop (local::codestream::read,
        ojph_codestream_local.cpp:912-1115)."""
        for idx, pos, end in self._tile_part_spans():
            self._parse_span(self.tiles[idx], pos, end)

    def _tile_part_spans(self):
        """Yield (tile index, payload start, payload end) of each
        tile-part, in stream order."""
        buf = self.data
        pos = self.hdr.header_size
        n = len(buf)
        while pos + 4 <= n:
            mrk = struct.unpack_from('>H', buf, pos)[0]
            if mrk == mk.Marker.EOC:
                break
            if mrk != mk.Marker.SOT:
                if self.resilient:
                    pos += 1
                    continue
                _err(0x00030051, f'expected a tile segment (SOT), found '
                     f'marker {mrk:#06x}')
            if pos + 14 > n:
                if self.resilient:
                    break
                raise EOFError('codestream truncated inside SOT')
            sot = mk.Sot.from_bytes(buf[pos + 4: pos + 14])
            tp_start = pos
            pos += 12
            # tile-part header: markers until SOD
            while pos + 2 <= n:
                m2 = struct.unpack_from('>H', buf, pos)[0]
                if m2 == mk.Marker.SOD:
                    pos += 2
                    break
                if pos + 4 > n:
                    pos = n
                    break
                ln = struct.unpack_from('>H', buf, pos + 2)[0]
                pos += 2 + ln
            payload_end = tp_start + (sot.psot if sot.psot else n - tp_start)
            if payload_end > n and not self.resilient:
                # the reference throws when the file ends before Psot
                # (bb_read, ojph_bitbuffer_read.h:79-99)
                raise EOFError('codestream truncated inside a tile-part')
            payload_end = min(payload_end, n)
            # wrong tile index: the reference skips the tile-part when
            # resilient and errors otherwise
            # (ojph_codestream_local.cpp:925-950)
            if sot.isot < len(self.tile_rects):
                yield sot.isot, pos, payload_end
            elif not self.resilient:
                _err(0x00030061, f'wrong tile index {sot.isot}')
            pos = payload_end

    def _parse_span(self, st: _TileState, pos: int, end: int):
        """Parse one tile-part payload into ``st``.  A malformed one is
        skipped when resilient and raises otherwise."""
        try:
            if end < pos:
                _err(0x00030067, 'tile-part header runs past Psot')
            # end == pos is a legal EMPTY tile-part (a tile-part division
            # boundary with no packets, e.g. a 1-sample-wide tile whose
            # r0 emits nothing; the reference's own -tileparts R output
            # contains these with Psot=14 and ojph_expand accepts them)
            self._parse_one_tile_part(st, pos, end - pos)
        except (ValueError, EOFError):
            if not self.resilient:
                raise

    def _parse_one_tile_part(self, st: _TileState, pos: int,
                             data_left: int):
        with trace.stage('decode.t2.walk'):
            self._walk(st, pos, data_left)

    def _walk(self, st: _TileState, pos: int, data_left: int):
        """The tile-part's packets in one native call, from
        the tile's next packet until the data or the packets end."""
        _, table = st.walk.packets(self.hdr, self.skip_read)
        buf = self.data
        data = buf if isinstance(buf, np.ndarray) \
            else np.frombuffer(buf, np.uint8)
        out = np.empty(3, np.int64)
        rc = native.t2_walk_tile_part(data, pos, data_left, table,
                                      st.next_packet, st.rec_table,
                                      st.rec_pos, out)
        st.next_packet = int(out[0])
        if rc:
            exc, msg = _T2_ERRORS.get(rc, (ValueError, 'malformed packet'))
            raise exc(msg)

    def _materialize_coded(self):
        """The records -> CodedBlock objects in ``st.coded``, for callers
        that walk them; idempotent."""
        buf = self.data
        for st in self.tiles:
            if st.coded:
                continue
            st.coded = _empty_coded(st.geom)
            for (c, r), recs in st.rec.items():
                for b, (rb, pb) in recs.items():
                    coded = st.coded[c][r][b]
                    for i in range(rb.shape[0]):
                        mm, npss, l0, l1, inc, nb = (int(v)
                                                     for v in rb[i])
                        if not inc and npss == 0 and l0 == 0:
                            continue
                        cb = CodedBlock()
                        cb.missing_msbs = mm
                        cb.num_passes = npss
                        cb.pass_length = [l0, l1]
                        if nb:
                            o = int(pb[i])
                            cb.data = bytes(buf[o:o + nb])
                        coded[i] = cb

    def _assemble(self, tile_planes) -> List[np.ndarray]:
        """Place per-tile component planes onto the full canvas."""
        siz = self.hdr.siz
        nc = siz.num_comps
        full = []
        for c in range(nc):
            # reconstruction size accounts for skipped resolutions
            dx, dy = siz.comps[c].dx, siz.comps[c].dy
            ccod = self.hdr.get_cod(c)
            sk = min(self.skip_recon, ccod.num_decomps)
            cdfs = self.hdr.get_dfs(ccod.dfs_idx) \
                if ccod.dfs_idx is not None else None
            # per-axis downsampling: a DFS may skip levels that split
            # in only one direction (param_dfs::get_res_downsamp)
            sx, sy = cdfs.get_res_downsamp(sk) if cdfs is not None \
                else (1 << sk, 1 << sk)
            fx, fy = dx * sx, dy * sy
            w = -(-siz.xsiz // fx) - (-(-siz.xosiz // fx))
            h = -(-siz.ysiz // fy) - (-(-siz.yosiz // fy))
            bd_c = siz.comps[c].bit_depth
            sgn_c = siz.comps[c].is_signed
            full.append(np.zeros(
                (h, w),
                dtype=np.int64 if (bd_c >= 32 and not sgn_c)
                else np.int32))
        for st in self.tiles:
            planes = tile_planes[st.geom.idx]
            for c in range(nc):
                comp = st.geom.comps[c]
                skip = min(self.skip_recon, comp.num_decomps)
                res = comp.resolutions[comp.num_decomps - skip]
                dx, dy = siz.comps[c].dx, siz.comps[c].dy
                sx, sy = comp.res_downsamp(skip)
                fx, fy = dx * sx, dy * sy
                ox = res.rect.x0 - (-(-siz.xosiz // fx))
                oy = res.rect.y0 - (-(-siz.yosiz // fy))
                full[c][oy:oy + planes[c].shape[0],
                        ox:ox + planes[c].shape[1]] = planes[c]
        return full


def _empty_coded(geom: TileGeom):
    """coded[comp][res][band]: a None a codeblock of each present band,
    None for an absent one."""
    return [[[None if sb is None or sb.empty
              else [None] * (sb.num_cb_x * sb.num_cb_y)
              for sb in res.bands]
             for res in comp.resolutions]
            for comp in geom.comps]


# ---------------------------------------------------------------------------
# Encode: the host half (a copy of the JAX package's Encoder without its
# scalar per-codeblock path; GpuEncoder supplies the tiles' packets)
# ---------------------------------------------------------------------------

class Encoder:
    """Host half of the HTJ2K encoder: marker segments, quantization
    parameters, tile-part division and codestream assembly.  A
    subclass supplies ``_encode_tile(idx, tile_rect, planes)``, which
    returns one tile's packets annotated ``(comp, res, bytes)``."""

    def __init__(self, siz: mk.Siz, cod: mk.Cod,
                 qcd: Optional[mk.Qcd] = None,
                 base_delta: Optional[float] = None,
                 cocs: Dict[int, mk.Cod] = None,
                 qccs: Dict[int, mk.Qcd] = None,
                 nlts: List[mk.NltSegment] = (),
                 comments: List[mk.Com] = (),
                 tlm_marker: bool = False,
                 tilepart_div: int = 0,
                 qfactor: Optional[int] = None,
                 profile: Optional[str] = None,
                 atks: List = (),
                 dfs_list: List[mk.Dfs] = (),
                 ht_passes: int = 1):
        if siz.xtsiz == 0 and siz.ytsiz == 0:
            siz.xtsiz = siz.xsiz + siz.xosiz
            siz.ytsiz = siz.ysiz + siz.yosiz
        self.siz = siz
        self.cod = cod
        self.cocs = cocs or {}
        self.qccs = qccs or {}
        self.atks = list(atks)
        self.dfs_list = list(dfs_list)
        # resolve Part-2 wavelet kernels / decomposition structures up
        # front so is_reversible and geometry see them (the read path
        # does the same in read_main_header)
        atk_map = {a.index: a for a in self.atks}
        for c in [cod] + list(self.cocs.values()):
            if c.wavelet_kern >= 2 and c.atk is None:
                if c.wavelet_kern not in atk_map:
                    _err(0x00050131 if c.comp_idx is None else 0x00050132,
                         f'COD/COC uses ATK kernel {c.wavelet_kern} but '
                         'no such kernel was supplied')
                c.atk = atk_map[c.wavelet_kern]
            if c.dfs_idx is not None:
                if c.comp_idx is None:
                    _err(0x000500DB, 'DFS can only be signaled in a COC '
                         '(the main COD carries the decomposition count)')
                if not any(d.sdfs == c.dfs_idx for d in self.dfs_list):
                    _err(0x000500DA, f'COC references DFS index '
                         f'{c.dfs_idx} but no such marker was supplied')
        self.nlts = list(nlts)
        self.comments = list(comments)
        self.tlm_marker = tlm_marker
        self.tilepart_div = tilepart_div
        if ht_passes not in (1, 2, 3):
            _err(0x000500F3, 'ht_passes must be 1, 2 or 3')
        self.ht_passes = ht_passes
        if profile:
            # IMF/BROADCAST validation; both force TLM + component-level
            # tile parts (ojph_codestream_local.cpp:446-453, 544-551)
            pf = profile.upper()
            # validation happens on the finalized tile size
            vsiz = siz
            if pf == 'IMF':
                check_imf(vsiz, cod)
            elif pf == 'BROADCAST':
                check_broadcast(vsiz, cod)
            else:
                _err(0x000300A1, f'unknown or unsupported profile '
                     f'{profile!r}')
            if self.tilepart_div & self.TILEPART_R:
                # 0x000300C1 (IMF) / 0x000300B1 (BROADCAST) warnings
                _wrn(0x000300C1 if pf == 'IMF' else 0x000300B1,
                     f'in the {pf} profile, tile part divisions at the '
                     'component level must be employed, while at the '
                     'resolution level they are not allowed')
            self.tlm_marker = True
            self.tilepart_div = self.TILEPART_C
        if qfactor is not None:
            # Qfactor visual weighting: QCD carries the luma weights and
            # every component gets an explicit QCC
            # (param_qcd check_validity, ojph_params.cpp:1375-1407)
            if cod.is_reversible:
                _err(0x00050182, 'qfactor requires the irreversible path')
            if not (1 <= qfactor <= 100):
                _err(0x00050181, f'Qfactor must be between 1 and 100, '
                     f'but was set to {qfactor}')
            if base_delta is not None:
                # param_qcd::set_irrev_quant (0x00040002)
                _wrn(0x00040002, 'base_delta (qstep) is ignored, because '
                     'qfactor is set')
            nc = siz.num_comps
            qcd = make_qfactor_qcd(cod.num_decomps,
                                   siz.comps[0].bit_depth, qfactor,
                                   COMP_Y, (1, 1))
            for c in range(nc):
                ct = c if (nc >= 3 and c < 3) else COMP_Y
                ccod = self.cocs.get(c, cod)
                self.qccs[c] = make_qfactor_qcd(
                    ccod.num_decomps, siz.comps[c].bit_depth, qfactor,
                    ct, (siz.comps[c].dx, siz.comps[c].dy), comp_idx=c)
        if qcd is None:
            bd = siz.comps[0].bit_depth
            if cod.is_reversible:
                qcd = make_rev_qcd(cod.num_decomps, bd, cod.mc_trans == 1,
                                   kernel=cod.kernel)
            else:
                qcd = make_irrev_qcd(cod.num_decomps,
                                     base_delta or default_irrev_delta(bd),
                                     kernel=cod.kernel)
        self.qcd = qcd
        # components whose parameters differ need a QCC
        for c in range(siz.num_comps):
            ccod = self.cocs.get(c, cod)
            if c in self.qccs:
                continue
            need = (ccod.num_decomps != cod.num_decomps
                    or siz.comps[c].bit_depth != siz.comps[0].bit_depth
                    or siz.comps[c].is_signed != siz.comps[0].is_signed
                    or ccod.wavelet_kern != cod.wavelet_kern
                    or ccod.uses_dfs)
            if need:
                bd = siz.comps[c].bit_depth
                cdfs = None
                if ccod.dfs_idx is not None:
                    cdfs = next(d for d in self.dfs_list
                                if d.sdfs == ccod.dfs_idx)
                if ccod.is_reversible:
                    self.qccs[c] = make_rev_qcd(
                        ccod.num_decomps, bd,
                        cod.mc_trans == 1 and c < 3, comp_idx=c,
                        dfs=cdfs, kernel=ccod.kernel)
                else:
                    self.qccs[c] = make_irrev_qcd(
                        ccod.num_decomps,
                        base_delta or default_irrev_delta(bd),
                        comp_idx=c, dfs=cdfs, kernel=ccod.kernel)
        self.hdr = mk.MainHeader()
        self.hdr.siz = siz
        self.hdr.cod = cod
        self.hdr.dfs = self.dfs_list
        self.hdr.atks = atk_map
        self.hdr.cocs = self.cocs
        self.hdr.qcd = self.qcd
        self.hdr.qccs = self.qccs
        for seg in self.nlts:
            self.hdr.nlt.add(seg)

    def _get_cod(self, c):
        return self.cocs.get(c, self.cod)

    def _get_qcd(self, c):
        return self.qccs.get(c, self.qcd)

    # tile-part division flags (ojph_codestream.h OJPH_TILEPART_*)
    TILEPART_R = 1
    TILEPART_C = 2

    def _corrected_tilepart_div(self) -> int:
        """Per-progression-order correction of the requested tile-part
        divisions (codestream::write_headers,
        ojph_codestream_local.cpp:582-622)."""
        div = self.tilepart_div
        po = self.cod.prog_order
        if po in (mk.ProgOrder.LRCP, mk.ProgOrder.RLCP) \
                and div == self.TILEPART_C:
            div |= self.TILEPART_R
        if po == mk.ProgOrder.RPCL and (div & self.TILEPART_C):
            _wrn(0x00030021,
                 'for RPCL progression, having tilepart divisions at the '
                 'component level means a tilepart for every precinct, '
                 'which is not supported; component divisions dropped')
            div &= ~self.TILEPART_C
        if po == mk.ProgOrder.PCRL:
            if div:
                _wrn(0x00030022,
                     'for PCRL progression, tilepart divisions at the '
                     'component or resolution level mean a tile part for '
                     'every precinct, which is not supported; divisions '
                     'dropped')
            div = 0
        if po == mk.ProgOrder.CPRL and (div & self.TILEPART_R):
            _wrn(0x00030023,
                 'for CPRL progression, having tilepart divisions at the '
                 'resolution level means a tile part for every precinct, '
                 'which is not supported; resolution divisions dropped')
            div &= ~self.TILEPART_R
        return div

    def _split_tileparts(self, packets):
        """Group annotated packets [(c, r, bytes)] into tile-parts
        [(tpsot, tnsot, payload)] (tile::flush,
        ojph_tile.cpp:584-774)."""
        div = self._corrected_tilepart_div()
        nc = self.siz.num_comps
        maxd = max(self._get_cod(c).num_decomps for c in range(nc))
        if div == 0:
            return [(0, 1, b''.join(p for _, _, p in packets))]
        if div == self.TILEPART_C:  # CPRL only
            parts = []
            for c in range(nc):
                payload = b''.join(p for pc, _, p in packets if pc == c)
                parts.append((c, nc, payload))
            return parts
        if div == self.TILEPART_R:
            parts = []
            for r in range(maxd + 1):
                payload = b''.join(p for _, pr, p in packets if pr == r)
                parts.append((r, maxd + 1, payload))
            return parts
        # R | C: LRCP/RLCP only — one part per (r, c)
        parts = []
        tn = nc * (maxd + 1)
        for r in range(maxd + 1):
            for c in range(nc):
                if r > self._get_cod(c).num_decomps:
                    continue
                payload = b''.join(p for pc, pr, p in packets
                                   if pc == c and pr == r)
                parts.append((c + r * nc, tn, payload))
        return parts

    def encode(self, planes: List[np.ndarray]) -> bytes:
        """Encode per-component sample planes into a .j2c codestream."""
        tile_rects = build_tile_grid(self.siz)
        return self.assemble([self._encode_tile(idx, tr, planes)
                              for idx, tr in enumerate(tile_rects)])

    # -- streaming (file-backed) assembly: config-5 output ------------
    # The reference writes to FILE* (j2c_outfile); the bytes API's
    # in-memory stream is O(image) for gigapixel mosaics, so these
    # three calls let MosaicEncoder.encode_chunked stream tile-parts
    # straight to disk (tile-parts may appear in any order per T.800
    # A.4.2 — the SOT Isot routes them).
    def stream_begin(self, f) -> None:
        if self.tlm_marker:
            _err(0x000300A1, 'TLM requires the in-memory assemble '
                 '(the marker precedes tile-parts of unknown sizes)')
        f.write(mk.write_main_header(
            self.siz, self.cod, self.qcd,
            cocs=list(self.cocs.values()),
            qccs=list(self.qccs.values()),
            nlts=self.nlts, comments=self.comments,
            version_comment=b'OpenJPH-TPU Ver 0.1.0.',
            atks=self.atks, dfs_list=self.dfs_list))

    def stream_tile(self, f, idx: int, packets) -> None:
        for (tpsot, tnsot, payload) in self._split_tileparts(packets):
            f.write(mk.Sot(idx, len(payload) + 14, tpsot,
                           tnsot).to_bytes())
            f.write(struct.pack('>H', mk.Marker.SOD))
            f.write(payload)

    def stream_end(self, f) -> None:
        f.write(struct.pack('>H', mk.Marker.EOC))

    def assemble(self, tiles_packets) -> bytes:
        """Assemble per-tile packet lists (in tile index order) into
        the codestream: main header, SOT/SOD tile-parts (with the
        configured tile-part divisions), optional TLM, EOC."""
        header = mk.write_main_header(
            self.siz, self.cod, self.qcd,
            cocs=list(self.cocs.values()), qccs=list(self.qccs.values()),
            nlts=self.nlts, comments=self.comments,
            version_comment=b'OpenJPH-TPU Ver 0.1.0.',
            atks=self.atks, dfs_list=self.dfs_list)
        body = bytearray()
        tlm_pairs = []
        for idx, packets in enumerate(tiles_packets):
            for (tpsot, tnsot, payload) in self._split_tileparts(packets):
                sot = mk.Sot(idx, len(payload) + 14, tpsot, tnsot)
                body += sot.to_bytes()
                body += struct.pack('>H', mk.Marker.SOD)
                body += payload
                tlm_pairs.append((idx, len(payload) + 14))
        out = header
        if self.tlm_marker:
            out += mk.Tlm(tlm_pairs).to_bytes()
        out += bytes(body)
        out += struct.pack('>H', mk.Marker.EOC)
        return out


def normalize_planes(planes) -> List[np.ndarray]:
    """(H,W) / (H,W,C) array or list of planes -> list of planes."""
    if isinstance(planes, np.ndarray):
        return [planes[..., i] for i in range(planes.shape[-1])] \
            if planes.ndim == 3 else [planes]
    return list(planes)


def build_encoder(shape, nc: int, encoder_cls, bit_depth: int = 8,
                  is_signed: bool = False,
                  reversible: bool = True, num_decomps: int = 5,
                  prog_order: int = mk.ProgOrder.RPCL,
                  color_transform: Optional[bool] = None,
                  base_delta: Optional[float] = None,
                  block_size=(64, 64), tlm_marker: bool = False,
                  tile_size=None, tile_offset=(0, 0),
                  image_offset=(0, 0),
                  precincts=None, downsamplings=None,
                  qfactor: Optional[int] = None, tileparts: str = None,
                  profile: Optional[str] = None,
                  comments=None, ht_passes: int = 1,
                  vert_causal: bool = False) -> 'Encoder':
    """Build an Encoder from the convenience-kwarg surface; ``shape``
    is the (H, W) of component 0.  ``encoder_cls`` is the encoder
    class (or a callable taking the Encoder arguments), e.g.
    gpu.encode_pipeline.GpuEncoder."""
    siz = mk.Siz()
    siz.xosiz, siz.yosiz = image_offset
    siz.xsiz = shape[1] + siz.xosiz
    siz.ysiz = shape[0] + siz.yosiz
    if tile_size is not None:
        siz.xtsiz, siz.ytsiz = tile_size
        siz.xtosiz, siz.ytosiz = tile_offset
    for c in range(nc):
        ds = downsamplings[c] if downsamplings else (1, 1)
        siz.comps.append(mk.CompInfo(bit_depth, is_signed, ds[0], ds[1]))
    cod = mk.Cod()
    if isinstance(prog_order, str):  # "RPCL" etc., as in ojph_compress
        prog_order = mk.ProgOrder[prog_order.upper()]
    cod.prog_order = prog_order
    cod.num_decomps = num_decomps
    cod.log_block_w = block_size[0].bit_length() - 1
    cod.log_block_h = block_size[1].bit_length() - 1
    cod.wavelet_kern = mk.DWT_REV53 if reversible else mk.DWT_IRV97
    if vert_causal:
        cod.block_style |= mk.VERT_CAUSAL_MODE
    if color_transform is None:
        color_transform = (nc >= 3 and not any(
            (siz.comps[c].dx != 1 or siz.comps[c].dy != 1)
            for c in range(3))) if nc >= 3 else False
    cod.mc_trans = 1 if color_transform else 0
    if precincts is not None:
        cod.scod |= 1
        ps = []
        for r in range(num_decomps + 1):
            pw, ph = precincts[min(r, len(precincts) - 1)]
            ps.append((pw.bit_length() - 1) | ((ph.bit_length() - 1) << 4))
        # reference stores precincts from res 0 upward
        cod.precinct_sizes = ps
    if qfactor is not None:
        cod.wavelet_kern = mk.DWT_IRV97
    tp_div = 0
    if tileparts:
        tp = tileparts.upper()
        if tp not in ('R', 'C', 'RC', 'CR'):
            _err(0x000300F1, "tileparts must be 'R', 'C', or 'RC'")
        tp_div = (Encoder.TILEPART_R if 'R' in tp else 0) \
            | (Encoder.TILEPART_C if 'C' in tp else 0)
    coms = []
    for com in comments or ():
        if isinstance(com, mk.Com):
            coms.append(com)
        else:
            data = com.encode('latin-1') if isinstance(com, str) else com
            coms.append(mk.Com(1, bytes(data)))
    return encoder_cls(siz, cod, base_delta=base_delta,
                       tlm_marker=tlm_marker, qfactor=qfactor,
                       tilepart_div=tp_div, profile=profile,
                       comments=coms, ht_passes=ht_passes)
