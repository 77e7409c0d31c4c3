"""IMF and BROADCAST profile validation.

Ports codestream::check_imf_validity / check_broadcast_validity
(OpenJPH src/core/codestream/ojph_codestream_local.cpp:293-553).
Both profiles force a TLM marker and component-level tile-part
divisions on success.  Error codes match the reference check by check
(0x000300C1..CD for IMF, 0x000300B1..BB for BROADCAST).
"""
from __future__ import annotations

import math

from . import markers as mk
from .message import error


def _ceil_div(a, b):
    return -(-a // b)


# per-profile code tables for the checks shared by both profiles:
# (image offset, tile offset, num comps, downsampling, bit depth,
#  precincts, progression order)
_IMF_CODES = (0x000300C3, 0x000300C4, 0x000300C5, 0x000300C6,
              0x000300C7, 0x000300C9, 0x000300CA)
_BC_CODES = (0x000300B1, 0x000300B2, 0x000300B3, 0x000300B4,
             0x000300B5, 0x000300B9, 0x000300BA)


def _common_checks(siz: mk.Siz, cod: mk.Cod, profile: str, max_comps: int,
                   bd_hi: int, codes):
    c_off, c_toff, c_nc, c_ds, c_bd, c_prec, c_prog = codes
    if siz.xosiz != 0 or siz.yosiz != 0:
        error(c_off, f'{profile}: image offset must be 0')
    if siz.xtosiz != 0 or siz.ytosiz != 0:
        error(c_toff, f'{profile}: tile offset must be 0')
    nc = siz.num_comps
    if nc > max_comps:
        error(c_nc, f'{profile}: at most {max_comps} components')
    ds1 = ds2 = True
    for i in range(nc):
        dx, dy = siz.comps[i].dx, siz.comps[i].dy
        ds1 &= dy == 1 and dx == 1
        ds2 &= dy == 1 and (dx == 2 if i in (1, 2) else dx == 1)
    if not ds1 and not ds2:
        error(c_ds, f'{profile}: downsampling must be 4:4:4 or 4:2:2')
    for i in range(nc):
        bd = siz.comps[i].bit_depth
        if not (8 <= bd <= bd_hi) or siz.comps[i].is_signed:
            error(c_bd, f'{profile}: bit depth must be 8..{bd_hi} unsigned')
    # precincts: {128,128} then {256,256} (log sizes 7 then 8)
    ps = cod.precinct_sizes if (cod.scod & 1) else None
    ok = ps is not None and len(ps) >= 1 and ps[0] == (7 | (7 << 4))
    if ps is not None:
        for i in range(1, cod.num_decomps + 1):
            p = ps[min(i, len(ps) - 1)]
            ok = p == (8 | (8 << 4))
    if not ok:
        error(c_prec,
              f'{profile}: precincts must be {{128,128}},{{256,256}}')
    if cod.prog_order != mk.ProgOrder.CPRL:
        error(c_prog, f'{profile}: progression order must be CPRL')


def check_imf(siz: mk.Siz, cod: mk.Cod) -> None:
    """check_imf_validity (ojph_codestream_local.cpp:293-453)."""
    reversible = cod.is_reversible
    w = siz.xsiz - siz.xosiz
    h = siz.ysiz - siz.yosiz
    p2k = w <= 2048 and h <= 1556
    p4k = w <= 4096 and h <= 3112
    p8k = w <= 8192 and h <= 6224
    if not (p2k or p4k or p8k):
        error(0x000300C1 if reversible else 0x000300C2,
              'IMF: image dimensions exceed all IMF profiles')
    _common_checks(siz, cod, 'IMF', 3, 16, _IMF_CODES)
    if cod.log_block_w != 5 or cod.log_block_h != 5:
        error(0x000300C8, 'IMF: codeblock must be 32x32')
    nd = cod.num_decomps
    p2k &= nd <= 5
    p4k &= nd <= 6
    p8k &= nd <= 7
    if nd == 0 or not (p2k or p4k or p8k):
        error(0x000300CB, 'IMF: number of decompositions does not match '
              'the profile for these dimensions')
    tiles = (_ceil_div(w, siz.xtsiz or w) * _ceil_div(h, siz.ytsiz or h))
    if tiles > 1:
        if not reversible:
            error(0x000300CC, 'IMF: lossy IMF must be single-tile')
        tw, th = siz.xtsiz, siz.ytsiz
        ok2 = (tw == 1024 and th == 1024) and \
            ((tw >= 1024 and nd <= 4) or (tw >= 2048 and nd <= 5))
        ok4 = ((tw == 1024 and th == 1024) or
               (tw == 2048 and th == 2048)) and \
            ((tw >= 1024 and nd <= 4) or (tw >= 2048 and nd <= 5)
             or (tw >= 4096 and nd <= 6))
        ok8 = ((tw == 1024 and th == 1024) or (tw == 2048 and th == 2048)
               or (tw == 4096 and th == 4096)) and \
            ((tw >= 1024 and nd <= 4) or (tw >= 2048 and nd <= 5)
             or (tw >= 4096 and nd <= 6) or (tw >= 8192 and nd <= 7))
        if not (ok2 or ok4 or ok8):
            error(0x000300CD, 'IMF: tile size / decomposition combination '
                  'not allowed')


def check_broadcast(siz: mk.Siz, cod: mk.Cod) -> None:
    """check_broadcast_validity (ojph_codestream_local.cpp:456-553)."""
    _common_checks(siz, cod, 'BROADCAST', 4, 12, _BC_CODES)
    nd = cod.num_decomps
    if nd == 0 or nd > 5:
        error(0x000300B6, 'BROADCAST: decompositions must be 1..5')
    if not (5 <= cod.log_block_w <= 7) or not (5 <= cod.log_block_h <= 7):
        error(0x000300B7, 'BROADCAST: codeblock must be 32, 64 or 128')
    w = siz.xsiz - siz.xosiz
    h = siz.ysiz - siz.yosiz
    tiles = (_ceil_div(w, siz.xtsiz or w) * _ceil_div(h, siz.ytsiz or h))
    if tiles not in (1, 4):
        error(0x000300BB, 'BROADCAST: must have 1 or 4 tiles')
