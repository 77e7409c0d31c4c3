"""Tier-2 packet codec: tag trees, packet-header encode, the parse's
error table, and progression-order sequencing.

Mirrors the packet syntax of T.800 B.10 restricted to HTJ2K single-layer
streams, with the same dialect as the reference encoder/parser
(ojph_precinct.cpp:58-573) including the placeholder-pass convention and
HT segment-length limits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bitio import BitWriter
from .message import error as _err
from .geometry import ResolutionGeom, TileGeom
from .types import ceil_div


@dataclass(slots=True)
class CodedBlock:
    """Per-codeblock Tier-1 <-> Tier-2 exchange record
    (coded_cb_header, ojph_codeblock.h:115-125)."""
    missing_msbs: int = 0
    num_passes: int = 0
    pass_length: List[int] = field(default_factory=lambda: [0, 0])
    data: bytes = b''        # cleanup (+refinement) bytes


class TagTree:
    """Quad-tree of minima over a codeblock grid (T.800 B.10.2)."""

    def __init__(self, w: int, h: int, init_val: int):
        self.w, self.h = w, h
        self.num_levels = 1 + max(_log2ceil(w), _log2ceil(h)) if (w or h) \
            else 1
        self.levs = []
        lw, lh = w, h
        for _ in range(self.num_levels):
            self.levs.append(np.full((lh, lw), init_val, dtype=np.int32))
            lw, lh = ceil_div(lw, 2), ceil_div(lh, 2)
        self.levs.append(np.zeros((1, 1), dtype=np.int32))  # sentinel root
        self.flags = [np.zeros_like(l) for l in self.levs]

    def set_leaf(self, x: int, y: int, v: int) -> None:
        self.levs[0][y, x] = v

    def reduce_min(self) -> None:
        """Fill levels 1.. with minima of 2x2 children."""
        for lev in range(1, self.num_levels):
            child = self.levs[lev - 1]
            h, w = self.levs[lev].shape
            for y in range(h):
                for x in range(w):
                    vals = child[2 * y:2 * y + 2, 2 * x:2 * x + 2]
                    self.levs[lev][y, x] = vals.min()

    def get(self, x: int, y: int, lev: int) -> int:
        return int(self.levs[lev][y >> lev, x >> lev]) if lev <= \
            self.num_levels - 1 else int(self.levs[self.num_levels][0, 0])

    # note: level index num_levels refers to the sentinel 0 root


def _log2ceil(x: int) -> int:
    if x <= 1:
        return 0
    return (x - 1).bit_length()


def _tt_flag(tree: TagTree, x: int, y: int, lev: int):
    if lev >= tree.num_levels:
        return tree.flags[tree.num_levels], 0, 0
    return tree.flags[lev], y >> lev, x >> lev


# ---------------------------------------------------------------------------
# Packet header encoding (precinct::prepare_precinct + write,
# ojph_precinct.cpp:94-324)
# ---------------------------------------------------------------------------

def encode_precinct(res: ResolutionGeom, prec_idx: int,
                    coded: List[List[Optional[CodedBlock]]],
                    uses_eph: bool = False,
                    uses_sop: bool = False) -> bytes:
    """Build one packet (header + body) for a precinct.

    ``coded[band_num]`` is the per-band list (row-major over the band's
    codeblock grid) of CodedBlock or None for bands without blocks.
    Returns the full packet bytes.  The native C++ emitter (the hot
    host loop of VideoEncoder Tier-2) writes it; the Python body runs
    when the header outgrows the emitter's buffer.
    """
    r = _encode_precinct_native(res, prec_idx, coded, uses_eph, uses_sop)
    if r is not None:
        return r
    return _encode_precinct_py(res, prec_idx, coded, uses_eph,
                               uses_sop)


def _encode_precinct_native(res, prec_idx, coded, uses_eph, uses_sop):
    from .. import native
    prec = res.precincts[prec_idx]
    bands = np.zeros((4, 7), np.int32)
    rec_rows = []
    datas = []
    maxcb = 0
    for s in range(4):
        sb = res.bands[s]
        if sb is None or sb.empty:
            continue
        bi = prec.bands[s]
        if bi.num_x == 0 or bi.num_y == 0:
            continue
        bands[s, :3] = (1, bi.num_x, bi.num_y)
        maxcb += bi.num_x * bi.num_y
        cbs = coded[s]
        for y in range(bi.num_y):
            row0 = (bi.org_y + y) * sb.num_cb_x + bi.org_x
            for x in range(bi.num_x):
                cb = cbs[row0 + x]
                if cb is None or not cb.data:
                    rec_rows.append((0, 0, 0, 0, 0))
                else:
                    np_ = cb.num_passes
                    if np_ < 1 or np_ > 3:
                        _err(0x000300F2, 'unsupported num_passes')
                    rec_rows.append((1, cb.missing_msbs, np_,
                                     cb.pass_length[0],
                                     cb.pass_length[1]))
                    datas.append(cb.data)
    if not datas:
        return b'\x00'  # empty packet: single 0 bit in one byte
    recs = np.asarray(rec_rows, np.int32)
    out = np.empty(32 * maxcb + 64, np.uint8)
    n = native.t2_emit_packet(bands, recs, out)
    if n < 0:
        return None  # overflow: Python fallback
    header = out[:n].tobytes()
    if uses_eph:
        header += b'\xff\x92'
    packet = header + b''.join(datas)
    if uses_sop:
        packet = b'\xff\x91\x00\x04\x00\x00' + packet
    return packet


def _encode_precinct_py(res: ResolutionGeom, prec_idx: int,
                        coded: List[List[Optional[CodedBlock]]],
                        uses_eph: bool = False,
                        uses_sop: bool = False) -> bytes:
    prec = res.precincts[prec_idx]
    bw = BitWriter()
    started = False
    num_skipped_subbands = 0
    body = bytearray()

    for s in range(4):
        sb = res.bands[s]
        if sb is None or sb.empty:
            continue
        bi = prec.bands[s]
        if bi.num_x == 0 or bi.num_y == 0:
            continue

        inc_tag = TagTree(bi.num_x, bi.num_y, 255)
        mmsb_tag = TagTree(bi.num_x, bi.num_y, 255)
        cbs = coded[s]
        for y in range(bi.num_y):
            for x in range(bi.num_x):
                cb = cbs[(bi.org_y + y) * sb.num_cb_x + bi.org_x + x]
                inc_tag.set_leaf(x, y, 1 if (cb is None or not cb.data)
                                 else 0)
                mmsb_tag.set_leaf(x, y, cb.missing_msbs if cb else 0)
        inc_tag.reduce_min()
        mmsb_tag.reduce_min()
        inc_flags = TagTree(bi.num_x, bi.num_y, 0)
        mmsb_flags = TagTree(bi.num_x, bi.num_y, 0)

        nl = inc_tag.num_levels
        if inc_tag.get(0, 0, nl - 1) != 0:  # empty subband
            if started:
                bw.put_bit(0)
            else:
                num_skipped_subbands += 1
            continue

        if not started:
            started = True
            bw.put_bit(1)  # non-empty packet
            for _ in range(num_skipped_subbands):
                bw.put_bit(0)

        for y in range(bi.num_y):
            for x in range(bi.num_x):
                cb = cbs[(bi.org_y + y) * sb.num_cb_x + bi.org_x + x]
                # inclusion bits down the tag tree
                for cur_lev in range(nl, 0, -1):
                    levm1 = cur_lev - 1
                    fl, fy, fx = _tt_flag(inc_flags, x, y, levm1)
                    if fl[fy, fx] == 0:
                        skipped = inc_tag.get(x, y, levm1) \
                            - inc_tag.get(x, y, cur_lev)
                        assert skipped <= 1
                        bw.put_bit(1 - skipped)
                        fl[fy, fx] = 1
                    if inc_tag.get(x, y, levm1) > 0:
                        break

                if cb is None or cb.num_passes == 0:
                    continue

                # missing msbs (unary over the tag tree)
                for cur_lev in range(nl, 0, -1):
                    levm1 = cur_lev - 1
                    fl, fy, fx = _tt_flag(mmsb_flags, x, y, levm1)
                    if fl[fy, fx] == 0:
                        num_zeros = mmsb_tag.get(x, y, levm1) \
                            - mmsb_tag.get(x, y, cur_lev)
                        bw.put_bits(0, num_zeros)
                        bw.put_bit(1)
                        fl[fy, fx] = 1

                # number of passes (T.800 Table B.4)
                if cb.num_passes == 3:
                    bw.put_bits(12, 4)
                elif cb.num_passes == 2:
                    bw.put_bits(2, 2)
                elif cb.num_passes == 1:
                    bw.put_bit(0)
                else:
                    _err(0x000300F2, 'unsupported num_passes')

                # pass lengths: Lblock escape then lengths
                bits1 = cb.pass_length[0].bit_length()
                extra_bit = 1 if cb.num_passes > 2 else 0
                bits2 = cb.pass_length[1].bit_length() \
                    if cb.num_passes > 1 else 0
                bits = max(max(bits1, bits2 - extra_bit) - 3, 0)
                bw.put_bits(0xFFFFFFFE & ((1 << (bits + 1)) - 1), bits + 1)
                bw.put_bits(cb.pass_length[0], bits + 3)
                if cb.num_passes > 1:
                    bw.put_bits(cb.pass_length[1], bits + 3 + extra_bit)

                body += cb.data

    if not started:
        return b'\x00'  # empty packet: single 0 bit in one byte

    bw.terminate()
    header = bytes(bw.out)
    if uses_eph:
        header += b'\xff\x92'
    packet = header + bytes(body)
    if uses_sop:
        packet = b'\xff\x91\x00\x04\x00\x00' + packet
    return packet


# ---------------------------------------------------------------------------
# Packet header parsing (precinct::parse, ojph_precinct.cpp:328-573): the
# native walker (codec.Decoder._walk) parses; its return codes name these
# errors
# ---------------------------------------------------------------------------

_T2_ERRORS = {
    1: (EOFError, 'packet header truncated'),
    3: (ValueError, 'wrong SOP length'),
    4: (ValueError, 'expected EPH marker'),
    5: (ValueError, 'missing msbs larger than Kmax; likely bitstream '
        'corruption'),
    6: (ValueError, 'HT cleanup segment < 2 bytes'),
    7: (ValueError, 'HT cleanup segment >= 65535 bytes'),
    8: (ValueError, 'HT refinement segment >= 2047 bytes'),
}


# ---------------------------------------------------------------------------
# Progression-order iteration (tile::flush / parse_tile_header,
# ojph_tile.cpp:584-774, 777-938)
# ---------------------------------------------------------------------------

def precinct_iterator(tile: TileGeom, prog_order: int):
    """Yield (comp, res_num, prec_idx) in codestream order.

    Replicates the reference's sequencing state machines for all five
    progression orders.
    """
    comps = tile.comps
    num_comps = len(comps)
    max_decs = max(c.num_decomps for c in comps)

    # per (comp, res) raster cursor
    cursor = {(c, r): 0 for c in range(num_comps)
              for r in range(comps[c].num_decomps + 1)}

    def top_left(c, r):
        res = comps[c].resolutions[r]
        i = cursor[(c, r)]
        if i < res.num_precincts:
            return res.precincts[i].img_point
        return None

    if prog_order in (0, 1):  # LRCP, RLCP: single layer -> same order
        for r in range(max_decs + 1):
            for c in range(num_comps):
                if r <= comps[c].num_decomps:
                    res = comps[c].resolutions[r]
                    for i in range(res.num_precincts):
                        yield (c, r, i)
    elif prog_order == 2:  # RPCL
        for r in range(max_decs + 1):
            while True:
                best, bc = None, 0
                for c in range(num_comps):
                    if r > comps[c].num_decomps:
                        continue
                    cur = top_left(c, r)
                    if cur is None:
                        continue
                    if best is None or (cur[1], cur[0]) < (best[1], best[0]):
                        best, bc = cur, c
                if best is None:
                    break
                yield (bc, r, cursor[(bc, r)])
                cursor[(bc, r)] += 1
    elif prog_order == 3:  # PCRL
        while True:
            best, bc, brr = None, 0, 0
            for c in range(num_comps):
                for r in range(comps[c].num_decomps + 1):
                    cur = top_left(c, r)
                    if cur is None:
                        continue
                    if best is None or (cur[1], cur[0], c, r) < \
                            (best[1], best[0], bc, brr):
                        best, bc, brr = cur, c, r
            if best is None:
                break
            yield (bc, brr, cursor[(bc, brr)])
            cursor[(bc, brr)] += 1
    elif prog_order == 4:  # CPRL
        for c in range(num_comps):
            while True:
                best, brr = None, 0
                for r in range(comps[c].num_decomps + 1):
                    cur = top_left(c, r)
                    if cur is None:
                        continue
                    if best is None or (cur[1], cur[0]) < (best[1], best[0]):
                        best, brr = cur, r
                if best is None:
                    break
                yield (c, brr, cursor[(c, brr)])
                cursor[(c, brr)] += 1
    else:
        _err(0x00050032, f'improper progression order {prog_order}')
