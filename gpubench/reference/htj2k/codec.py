"""Top-level HTJ2K codec: full encode/decode pipelines.

Decode: markers -> geometry -> Tier-2 packet parse -> Tier-1 block
decode (batched) -> dequantization -> inverse DWT -> inverse color
transform -> bit-depth conversion.
Encode is the exact reverse.

The structural flow mirrors ojph_codestream_local.cpp /
ojph_tile.cpp but operates on whole planes (TPU-first design) instead
of streaming lines.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import native
from .coding.decoder import decode_codeblock
from .coding.encoder import encode_codeblock, encode_spp_mrp


def _encode_cb(sub, missing_msbs, width, height, bits=32):
    """Cleanup-segment encode: C++ fast path (incl. the encoder64
    regime, native/ojtpu_native.cpp::encode_codeblock) with the Python
    scalar reference as fallback."""
    out = native.encode_codeblock(sub, missing_msbs, width, height,
                                  bits=bits)
    if out is None:
        out = encode_codeblock(sub, missing_msbs, width, height,
                               bits=bits)
    return out
from .core import markers as mk
from .core.message import error as _err, warn as _wrn
from .core.geometry import (ResolutionGeom, SubbandGeom, TileGeom,
                            build_tile, build_tile_grid)
from .core.quant import default_irrev_delta, make_irrev_qcd, make_rev_qcd
from .core.t2 import CodedBlock, encode_precinct, parse_precinct, \
    precinct_iterator
from .ops import color as clr
from .ops import dwt


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@dataclass
class _TileState:
    geom: TileGeom
    # coded[comp][res][band] -> list over the band codeblock grid
    coded: List[List[List[Optional[List[Optional[CodedBlock]]]]]] = \
        field(default_factory=list)
    next_tile_part: int = 0
    prec_iter: object = None
    pending: object = None  # next (comp, res, prec) not yet parsed


def _tx_from_cb(block: np.ndarray, kmax: int, delta: float,
                reversible: bool) -> np.ndarray:
    """Sign-magnitude -> subband samples (gen_rev/irv_tx_from_cb32/64,
    ojph_codestream_gen.cpp:124-168)."""
    if reversible and kmax >= 31:
        # 64-bit path (>30 bit planes)
        blk = block.astype(np.uint64)
        mag = blk & np.uint64((1 << 63) - 1)
        neg = (blk >> np.uint64(63)).astype(bool)
        val = (mag >> np.uint64(63 - kmax)).astype(np.int64)
        return np.where(neg, -val, val)
    mag = (block & 0x7FFFFFFF).astype(np.uint32)
    neg = (block >> 31).astype(bool)
    if reversible:
        val = (mag >> np.uint32(31 - kmax)).astype(np.int32)
        return np.where(neg, -val, val)
    val = mag.astype(np.float32) * np.float32(delta)
    return np.where(neg, -val, val)


def _tx_to_cb(plane: np.ndarray, kmax: int, delta_inv: float,
              reversible: bool):
    """Subband samples -> sign-magnitude (gen_rev/irv_tx_to_cb32,
    ojph_codestream_gen.cpp:59-121).  Returns (samples, val_array) where
    val_array is the magnitude term used for the reference's max_val
    accounting (it may overflow into bit 31, which the reference keeps)."""
    if reversible and kmax >= 31:
        # 64-bit path (gen_rev_tx_to_cb64)
        sign = np.where(plane < 0, np.uint64(1) << np.uint64(63),
                        np.uint64(0))
        mag = np.abs(plane.astype(np.int64)).astype(np.uint64)
        val = mag << np.uint64(63 - kmax)
        return sign | val, val
    if reversible:
        sign = np.where(plane < 0, np.uint32(0x80000000), np.uint32(0))
        mag = np.abs(plane.astype(np.int64)).astype(np.uint32)
        val = mag << np.uint32(31 - kmax)  # wraps mod 2^32 like the C code
        return sign | val, val
    t = np.trunc(plane.astype(np.float32) * np.float32(delta_inv))
    t = t.astype(np.int64)
    sign = np.where(t < 0, np.uint32(0x80000000), np.uint32(0))
    val = np.abs(t).astype(np.uint32)
    return sign | val, val


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
                 skipped_res_for_recon: int = 0):
        self.data = data
        self.resilient = resilient
        self.hdr = mk.read_main_header(data)
        self.skip_read = skipped_res_for_read
        self.skip_recon = min(skipped_res_for_recon, skipped_res_for_read) \
            if skipped_res_for_recon else skipped_res_for_read
        # restrict_input_resolution semantics
        # (ojph_codestream.h:288-306): skip_res_for_read >= for_recon
        self.tile_rects, geoms = _cached_geometry(data, self.hdr)
        self.tiles: List[_TileState] = []
        for i, geom in enumerate(geoms):
            st = _TileState(geom)
            for c, comp in enumerate(geom.comps):
                per_res = []
                for r, res in enumerate(comp.resolutions):
                    per_band = []
                    for b in range(4):
                        sb = res.bands[b]
                        if sb is None or sb.empty:
                            per_band.append(None)
                        else:
                            ncb = sb.num_cb_x * sb.num_cb_y
                            per_band.append([None] * ncb)
                    per_res.append(per_band)
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
                cod.uses_sop, cod.uses_eph, skip_data=skip)

    # -- Tier-1 + reconstruction -------------------------------------------
    def _decode_band(self, sb: SubbandGeom,
                     coded: List[Optional[CodedBlock]],
                     reversible: bool, vert_causal: bool,
                     dtype) -> np.ndarray:
        if reversible and sb.kmax >= 31:
            dtype = np.int64  # 64-bit sample path
        plane = np.zeros((sb.rect.h, sb.rect.w), dtype=dtype)
        for cb_geom in sb.blocks:
            i = cb_geom.cb_y * sb.num_cb_x + cb_geom.cb_x
            cb = coded[i]
            r = cb_geom.rect
            w, h = r.w, r.h
            if cb is None or not cb.data or cb.num_passes == 0 \
                    or cb.pass_length[0] == 0:
                continue  # zero block
            try:
                dec = decode_codeblock(cb.data, cb.missing_msbs,
                                       cb.num_passes, cb.pass_length[0],
                                       cb.pass_length[1], w, h, vert_causal)
            except ValueError:
                if self.resilient:
                    continue
                raise
            samples = _tx_from_cb(dec, sb.kmax, sb.delta, reversible)
            plane[r.y0 - sb.rect.y0: r.y1 - sb.rect.y0,
                  r.x0 - sb.rect.x0: r.x1 - sb.rect.x0] = samples
        return plane

    def _reconstruct_comp(self, st: _TileState, c: int) -> np.ndarray:
        comp = st.geom.comps[c]
        cod = self.hdr.get_cod(c)
        reversible = cod.is_reversible
        dtype = np.int32 if reversible else np.float32
        skip = min(self.skip_recon, comp.num_decomps)
        top = comp.num_decomps - skip

        kern = cod.kernel

        # start from LL of resolution 0
        res0 = comp.resolutions[0]
        plane = self._decode_band(res0.bands[0], st.coded[c][0][0],
                                  reversible, cod.vert_causal, dtype)
        for r in range(1, top + 1):
            res = comp.resolutions[r]

            def band(b):
                return self._decode_band(res.bands[b], st.coded[c][r][b],
                                         reversible, cod.vert_causal,
                                         dtype)

            # Part-2 DFS: a level may split both ways, one way, or not
            # at all (resolution::pull_line, ojph_resolution.cpp:713-949)
            t = res.dwt_type
            if t == mk.Dfs.BIDIR_DWT:
                plane = dwt.inv_dwt2d(plane, band(1), band(2), band(3),
                                      res.rect.x0, res.rect.y0,
                                      reversible, kern)
            elif t == mk.Dfs.HORZ_DWT:
                plane = dwt.inv_atk_1d(plane, band(1),
                                       (res.rect.x0 & 1) == 0, 1, kern)
            elif t == mk.Dfs.VERT_DWT:
                plane = dwt.inv_atk_1d(plane, band(2),
                                       (res.rect.y0 & 1) == 0, 0, kern)
            # NO_DWT: pass-through level
        return plane

    def decode_tile(self, tile_idx: int) -> List[np.ndarray]:
        """Returns per-component integer sample planes."""
        st = self.tiles[tile_idx]
        siz = self.hdr.siz
        nc = siz.num_comps
        planes = [self._reconstruct_comp(st, c) for c in range(nc)]
        out = []
        mct = self.hdr.cod.mc_trans == 1 and nc >= 3
        if mct:
            rev = self.hdr.get_cod(0).is_reversible
            if rev:
                r, g, b = clr.rct_backward(planes[0].astype(np.int64),
                                           planes[1].astype(np.int64),
                                           planes[2].astype(np.int64))
            else:
                r, g, b = clr.ict_backward(planes[0], planes[1], planes[2])
            planes[0], planes[1], planes[2] = r, g, b
        for c in range(nc):
            bd = siz.comps[c].bit_depth
            sgn = siz.comps[c].is_signed
            nlt3 = self.hdr.nlt.type3_for(c)
            odt = np.int64 if (bd >= 32 and not sgn) else np.int32
            if self.hdr.get_cod(c).is_reversible:
                out.append(clr.rev_convert_out(planes[c].astype(np.int64),
                                               bd, sgn, nlt3).astype(odt))
            else:
                out.append(clr.irv_convert_to_integer(
                    planes[c], bd, sgn, nlt3).astype(np.int32))
        return out

    def decode(self) -> List[np.ndarray]:
        """Decode the full image; returns per-component planes."""
        return self._assemble(
            {st.geom.idx: self.decode_tile(st.geom.idx)
             for st in self.tiles})

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


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

class Encoder:
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
            from .core.profiles import check_broadcast, check_imf
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
            from .core.quant import COMP_Y, make_qfactor_qcd
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
    # A.4.2 — the SOT Isot routes them; our decoder and ojph_expand
    # both accept it).
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

    def _encode_tile(self, idx: int, tr, planes: List[np.ndarray]) \
            -> List[bytes]:
        siz = self.siz
        geom = build_tile(self.hdr, idx, tr)
        nc = siz.num_comps

        # extract tile planes, convert, color transform
        tplanes = []
        for c in range(nc):
            comp = geom.comps[c]
            dx, dy = siz.comps[c].dx, siz.comps[c].dy
            ox = comp.rect.x0 - (-(-siz.xosiz // dx))
            oy = comp.rect.y0 - (-(-siz.yosiz // dy))
            sub = planes[c][oy:oy + comp.rect.h, ox:ox + comp.rect.w]
            bd = siz.comps[c].bit_depth
            sgn = siz.comps[c].is_signed
            nlt3 = self.hdr.nlt.type3_for(c)
            if self._get_cod(c).is_reversible:
                dt = np.int64 if bd > 28 else np.int32
                tplanes.append(clr.rev_convert_in(sub, bd, sgn, nlt3,
                                                  dtype=dt))
            else:
                tplanes.append(clr.irv_convert_to_float(sub, bd, sgn, nlt3))
        if self.cod.mc_trans == 1 and nc >= 3:
            if self._get_cod(0).is_reversible:
                y, cb, cr = clr.rct_forward(tplanes[0].astype(np.int64),
                                            tplanes[1].astype(np.int64),
                                            tplanes[2].astype(np.int64))
                wide = any(self.siz.comps[c].bit_depth > 28
                           for c in range(3))
                odt = np.int64 if wide else np.int32
                tplanes[0] = y.astype(odt)
                tplanes[1] = cb.astype(odt)
                tplanes[2] = cr.astype(odt)
            else:
                y, cb, cr = clr.ict_forward(tplanes[0], tplanes[1],
                                            tplanes[2])
                tplanes[0], tplanes[1], tplanes[2] = y, cb, cr

        # forward DWT + block coding per component
        coded = []
        for c in range(nc):
            coded.append(self._encode_comp(geom, c, tplanes[c]))

        # emit packets in progression order, annotated (comp, res)
        packets = []
        cod = self.cod
        for (c, r, pidx) in precinct_iterator(geom, cod.prog_order):
            res = geom.comps[c].resolutions[r]
            packets.append((c, r, encode_precinct(
                res, pidx, coded[c][r], cod.uses_eph, cod.uses_sop)))
        return packets

    def _encode_comp(self, geom: TileGeom, c: int, plane: np.ndarray):
        cod = self._get_cod(c)
        reversible = cod.is_reversible
        comp = geom.comps[c]
        kern = cod.kernel
        # analysis pyramid
        band_planes = {}  # (res, band) -> plane
        cur = plane
        for r in range(comp.num_decomps, 0, -1):
            res = comp.resolutions[r]
            t = res.dwt_type
            if t == mk.Dfs.BIDIR_DWT:
                ll, hl, lh, hh = dwt.fwd_dwt2d(cur, res.rect.x0,
                                               res.rect.y0, reversible,
                                               kern)
                band_planes[(r, 1)] = hl
                band_planes[(r, 2)] = lh
                band_planes[(r, 3)] = hh
                cur = ll
            elif t == mk.Dfs.HORZ_DWT:
                cur, band_planes[(r, 1)] = dwt.fwd_atk_1d(
                    cur, (res.rect.x0 & 1) == 0, 1, kern)
            elif t == mk.Dfs.VERT_DWT:
                cur, band_planes[(r, 2)] = dwt.fwd_atk_1d(
                    cur, (res.rect.y0 & 1) == 0, 0, kern)
            # NO_DWT: level contributes no bands
        band_planes[(0, 0)] = cur

        per_res = []
        for r in range(comp.num_decomps + 1):
            res = comp.resolutions[r]
            per_band = []
            for b in range(4):
                sb = res.bands[b]
                if sb is None or sb.empty:
                    per_band.append(None)
                    continue
                bp = band_planes[(r, b)]
                delta_inv = 1.0 / sb.delta if not reversible else 0.0
                smag, vals = _tx_to_cb(bp, sb.kmax, delta_inv, reversible)
                blocks: List[Optional[CodedBlock]] = []
                pend = []  # (block idx, sub, bits) for the C++ batch
                for g in sb.blocks:
                    sy = slice(g.rect.y0 - sb.rect.y0,
                               g.rect.y1 - sb.rect.y0)
                    sx = slice(g.rect.x0 - sb.rect.x0,
                               g.rect.x1 - sb.rect.x0)
                    sub = smag[sy, sx]
                    cb = CodedBlock()
                    mv = int(np.bitwise_or.reduce(vals[sy, sx].ravel())) \
                        if sub.size else 0
                    wide = reversible and sb.kmax >= 31
                    thresh = 1 << ((63 if wide else 31) - sb.kmax)
                    if mv >= thresh:
                        multi = (self.ht_passes > 1 and not wide
                                 and sb.kmax >= 2)
                        if multi:
                            # cleanup codes planes >= 1, SigProp/MagRef
                            # code plane 0 (finer truncation point than
                            # a whole cleanup bitplane)
                            seg1 = _encode_cb(sub, sb.kmax - 2,
                                              g.rect.w, g.rect.h)
                            seg2 = encode_spp_mrp(
                                sub, sb.kmax - 2, g.rect.w, g.rect.h,
                                num_passes=self.ht_passes,
                                stripe_causal=self.cod.vert_causal)
                            # reference parse limit: refinement
                            # segment < 2047 bytes (ojph_precinct.cpp:
                            # 496-514); fall back to cleanup-only
                            multi = 0 < len(seg2) < 2047
                        if multi:
                            cb.missing_msbs = sb.kmax - 2
                            cb.num_passes = self.ht_passes
                            cb.data = seg1 + seg2
                            cb.pass_length[0] = len(seg1)
                            cb.pass_length[1] = len(seg2)
                        else:
                            cb.missing_msbs = sb.kmax - 1
                            cb.num_passes = 1
                            pend.append((len(blocks), sub,
                                         64 if wide else 32))
                    blocks.append(cb)
                if pend:
                    # thread-parallel C++ batch over the band's
                    # cleanup-only blocks (shared kmax/bits)
                    bits = pend[0][2]
                    segs = native.encode_codeblock_batch(
                        [s for _, s, _ in pend], sb.kmax - 1,
                        bits=bits) or [None] * len(pend)
                    for (bi, sub, bts), seg in zip(pend, segs):
                        if seg is None:  # no native / overflow
                            seg = encode_codeblock(
                                sub, sb.kmax - 1, sub.shape[1],
                                sub.shape[0], bits=bts)
                        blocks[bi].data = seg
                        blocks[bi].pass_length[0] = len(seg)
                per_band.append(blocks)
            per_res.append(per_band)
        return per_res


# ---------------------------------------------------------------------------
# Convenience API
# ---------------------------------------------------------------------------

def decode(data: bytes, resilient: bool = False,
           skip_res: int = 0) -> List[np.ndarray]:
    """Decode a .j2c codestream to per-component numpy planes."""
    return Decoder(data, resilient=resilient,
                   skipped_res_for_read=skip_res,
                   skipped_res_for_recon=skip_res).decode()


def normalize_planes(planes) -> List[np.ndarray]:
    """(H,W) / (H,W,C) array or list of planes -> list of planes."""
    if isinstance(planes, np.ndarray):
        return [planes[..., i] for i in range(planes.shape[-1])] \
            if planes.ndim == 3 else [planes]
    return list(planes)


def build_encoder(shape, nc: int, bit_depth: int = 8,
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
                  vert_causal: bool = False,
                  encoder_cls=None) -> 'Encoder':
    """Build an Encoder from the convenience-kwarg surface; ``shape``
    is the (H, W) of component 0.  ``encoder_cls`` overrides the
    encoder class (e.g. tpu.encode_pipeline.TpuEncoder)."""
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
    cls = encoder_cls or Encoder
    return cls(siz, cod, base_delta=base_delta,
               tlm_marker=tlm_marker, qfactor=qfactor,
               tilepart_div=tp_div, profile=profile, comments=coms,
               ht_passes=ht_passes)


def encode(planes, **kwargs) -> bytes:
    """Encode per-component numpy planes into a .j2c codestream on the
    host (numpy lifting, the C++ scalar cleanup coder).

    Keywords: bit_depth, is_signed, reversible, num_decomps,
    prog_order, color_transform, base_delta, block_size, tlm_marker,
    tile_size, tile_offset, image_offset, precincts, downsamplings,
    qfactor, tileparts, profile, comments, ht_passes, vert_causal
    (see build_encoder)."""
    planes = normalize_planes(planes)
    enc = build_encoder(planes[0].shape, len(planes), **kwargs)
    return enc.encode([np.asarray(p) for p in planes])
