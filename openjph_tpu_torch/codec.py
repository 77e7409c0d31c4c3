"""Host half of the HTJ2K decoder: markers -> geometry -> Tier-2 packet
parse, and the final placement of tile planes on the canvas.

A copy of the decode half of the JAX package's ``codec.py`` (the
structural flow of ojph_codestream_local.cpp / ojph_tile.cpp).  The
device half — Tier-1, dequantization, inverse DWT, colour and sample
conversion — lives in ``gpu/pipeline.py``.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import native
from .core import markers as mk
from .core.message import error as _err
from .core.geometry import TileGeom, build_tile, build_tile_grid
from .core.t2 import CodedBlock, parse_precinct, precinct_iterator


@dataclass
class _TileState:
    geom: TileGeom
    # coded[comp][res][band] -> list over the band codeblock grid
    coded: List[List[List[Optional[List[Optional[CodedBlock]]]]]] = \
        field(default_factory=list)
    # record mode: rec[(c, r)][band] -> (int32 [ncb, 6] of (mmsbs,
    # num_passes, len0, len1, included, nbytes), int64 [ncb] data pos)
    rec: dict = field(default_factory=dict)
    next_tile_part: int = 0
    prec_iter: object = None
    pending: object = None  # next (comp, res, prec) not yet parsed


# Parsed-header + tile-geometry cache.  Geometry is a pure, immutable
# function of the main header bytes; steady-state video re-parses the
# same header every frame (the restart() reuse pattern,
# ojph_codestream.h:109-122), so share one geometry across decoders.
_GEOM_CACHE: 'OrderedDict[bytes, tuple]' = OrderedDict()
_GEOM_CACHE_MAX = 32
_GEOM_LOCK = threading.Lock()


def _cached_geometry(data, hdr):
    key = bytes(data[:hdr.header_size])
    with _GEOM_LOCK:
        ent = _GEOM_CACHE.get(key)
        if ent is not None:
            _GEOM_CACHE.move_to_end(key)
            return ent
    tile_rects = build_tile_grid(hdr.siz)
    geoms = tuple(build_tile(hdr, i, tr)
                  for i, tr in enumerate(tile_rects))
    with _GEOM_LOCK:
        _GEOM_CACHE[key] = (tile_rects, geoms)
        while len(_GEOM_CACHE) > _GEOM_CACHE_MAX:
            _GEOM_CACHE.popitem(last=False)
    return tile_rects, geoms


class Decoder:
    def __init__(self, data: bytes, resilient: bool = False,
                 skipped_res_for_read: int = 0,
                 skipped_res_for_recon: int = 0,
                 record_t2: bool = False):
        self.data = data
        self.resilient = resilient
        self.hdr = mk.read_main_header(data)
        self.skip_read = skipped_res_for_read
        self.skip_recon = min(skipped_res_for_recon, skipped_res_for_read) \
            if skipped_res_for_recon else skipped_res_for_read
        # restrict_input_resolution semantics
        # (ojph_codestream.h:288-306): skip_res_for_read >= for_recon
        # record_t2: Tier-2 fills flat numpy record arrays instead of
        # CodedBlock objects (the fused device path consumes arrays;
        # CodedBlocks materialize lazily).  Needs the native parser;
        # resilience uses objects throughout.
        self.record_t2 = (record_t2 and not resilient
                          and native.have_native())
        self.tile_rects, geoms = _cached_geometry(data, self.hdr)
        self.tiles: List[_TileState] = []
        for i, geom in enumerate(geoms):
            st = _TileState(geom)
            for c, comp in enumerate(geom.comps):
                per_res = []
                for r, res in enumerate(comp.resolutions):
                    per_band = []
                    recs = {}
                    for b in range(4):
                        sb = res.bands[b]
                        if sb is None or sb.empty:
                            per_band.append(None)
                        else:
                            ncb = sb.num_cb_x * sb.num_cb_y
                            per_band.append([None] * ncb)
                            if self.record_t2:
                                recs[b] = (np.zeros((ncb, 6), np.int32),
                                           np.zeros(ncb, np.int64))
                    per_res.append(per_band)
                    if self.record_t2:
                        st.rec[(c, r)] = recs
                st.coded.append(per_res)
            self.tiles.append(st)
        self._parse_tile_parts()

    # -- Tier-2 ------------------------------------------------------------
    def _parse_tile_parts(self):
        """SOT/tile-part loop (local::codestream::read,
        ojph_codestream_local.cpp:912-1115)."""
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
            try:
                # wrong tile index / malformed tile-part header: the
                # reference skips the tile-part when resilient and
                # errors otherwise (ojph_codestream_local.cpp:925-950)
                if sot.isot >= len(self.tiles):
                    _err(0x00030061, f'wrong tile index {sot.isot}')
                if payload_end < pos:
                    _err(0x00030067, 'tile-part header runs past Psot')
                # payload_end == pos is a legal EMPTY tile-part (a
                # tile-part division boundary with no packets, e.g. a
                # 1-sample-wide tile whose r0 emits nothing; the
                # reference's own -tileparts R output contains these
                # with Psot=14 and ojph_expand accepts them)
                self._parse_one_tile_part(sot, pos, payload_end - pos)
            except (ValueError, EOFError):
                if not self.resilient:
                    raise
            pos = payload_end

    def _parse_one_tile_part(self, sot: mk.Sot, pos: int, data_left: int):
        st = self.tiles[sot.isot]
        if st.prec_iter is None:
            st.prec_iter = precinct_iterator(st.geom,
                                             self.hdr.cod.prog_order)
        buf = self.data
        it = st.prec_iter
        while data_left > 0:
            if st.pending is not None:
                cri = st.pending
                st.pending = None
            else:
                try:
                    cri = next(it)
                except StopIteration:
                    break
            c, r, pidx = cri
            comp = st.geom.comps[c]
            if r > comp.num_decomps - min(self.skip_read, comp.num_decomps):
                # skipped resolution: parse but discard data
                skip = True
            else:
                skip = False
            res = comp.resolutions[r]
            cod = self.hdr.get_cod(c)
            pos, data_left = parse_precinct(
                res, pidx, st.coded[c][r], buf, pos, data_left,
                cod.uses_sop, cod.uses_eph, skip_data=skip,
                records=st.rec.get((c, r)) if self.record_t2 else None)

    def _materialize_coded(self):
        """Record mode -> CodedBlock objects (lazily, for callers that
        walk st.coded); idempotent."""
        if not self.record_t2:
            return
        buf = self.data
        for st in self.tiles:
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
        self.record_t2 = False

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
