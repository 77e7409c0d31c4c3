"""Canvas partition geometry: tiles, resolutions, subbands, codeblocks,
precincts.

This computes, eagerly and host-side, the full coding layout that the
reference builds as a pointer-linked tree during its two-phase arena
allocation (ojph_codestream_local.cpp:113-289, ojph_resolution.cpp:59-459,
ojph_subband.cpp:57-276).  The layout drives both the Tier-2 packet codec
and the batched (TPU) Tier-1 block coding.

All rectangles are half-open on the canvas (reference) coordinate
system of T.800 Annex B.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .markers import Dfs, MainHeader, Cod, Qcd, Siz
from .types import Rect, ceil_div


@dataclass(slots=True)
class CodeblockGeom:
    """One codeblock: position within its subband."""
    rect: Rect               # in subband coordinates
    cb_x: int                # column index in the subband codeblock grid
    cb_y: int                # row index


class CodeblockGrid:
    """Lazy codeblock grid: the grid is regular (T.800 B.7 anchoring),
    so CodeblockGeom objects generate on demand instead of
    materializing O(blocks) Python objects per tile — at config-5
    scale (10 GP, ~2.5M codeblocks) the materialized lists alone cost
    hundreds of MB."""
    __slots__ = ('rect', 'log_w', 'log_h', 'x_lb', 'y_lb', 'nx', 'ny')

    def __init__(self, rect: Rect, log_w: int, log_h: int,
                 x_lb: int, y_lb: int, nx: int, ny: int):
        self.rect = rect
        self.log_w = log_w
        self.log_h = log_h
        self.x_lb = x_lb
        self.y_lb = y_lb
        self.nx = nx
        self.ny = ny

    def __len__(self) -> int:
        return self.nx * self.ny

    def _make(self, i: int, j: int) -> CodeblockGeom:
        r = self.rect
        nw, nh = 1 << self.log_w, 1 << self.log_h
        return CodeblockGeom(Rect(
            max(r.x0, self.x_lb + i * nw),
            max(r.y0, self.y_lb + j * nh),
            min(r.x1, self.x_lb + (i + 1) * nw),
            min(r.y1, self.y_lb + (j + 1) * nh)), i, j)

    def __iter__(self):
        for j in range(self.ny):
            for i in range(self.nx):
                yield self._make(i, j)

    def __getitem__(self, k: int) -> CodeblockGeom:
        if k < 0 or k >= self.nx * self.ny:
            raise IndexError(k)
        return self._make(k % self.nx, k // self.nx)


@dataclass(slots=True)
class PrecinctBandInfo:
    """Codeblock index range of one subband inside one precinct
    (subband::get_cb_indices, ojph_subband.cpp:224-276)."""
    org_x: int = 0  # first codeblock column (grid index)
    org_y: int = 0
    num_x: int = 0
    num_y: int = 0


@dataclass(slots=True)
class PrecinctGeom:
    x: int                   # precinct column in the resolution grid
    y: int
    img_point: Tuple[int, int]   # top-left on the canvas (for R/P/C orders)
    bands: List[PrecinctBandInfo] = field(default_factory=list)  # 4 entries


@dataclass(slots=True)
class SubbandGeom:
    band_num: int            # 0=LL, 1=HL, 2=LH, 3=HH
    rect: Rect               # band coordinates (T.800 eq. B-15)
    kmax: int = 0
    delta: float = 0.0       # quantization delta (irreversible only)
    num_cb_x: int = 0
    num_cb_y: int = 0
    log_cb_w: int = 0        # xcb' (precinct-clamped)
    log_cb_h: int = 0
    blocks: List[CodeblockGeom] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return self.rect.empty


@dataclass(slots=True)
class ResolutionGeom:
    res_num: int
    rect: Rect               # resolution coordinates (T.800 eq. B-14)
    bands: List[Optional[SubbandGeom]]   # [LL, HL, LH, HH]; LL only at r=0
    log_pp_w: int
    log_pp_h: int
    num_prec_x: int = 0
    num_prec_y: int = 0
    precincts: List[PrecinctGeom] = field(default_factory=list)
    horz_even: bool = True   # (rect.x0 & 1) == 0
    vert_even: bool = True
    # Part-2 DFS decomposition of this level (Dfs.BIDIR_DWT for the
    # conventional transform; resolution::finalize_alloc transform_flags)
    dwt_type: int = Dfs.BIDIR_DWT
    horz_trx: bool = True    # HORZ_TRX: this level splits horizontally
    vert_trx: bool = True    # VERT_TRX

    @property
    def num_precincts(self) -> int:
        return self.num_prec_x * self.num_prec_y


@dataclass(slots=True)
class TileCompGeom:
    comp_num: int
    rect: Rect               # component-tile rect
    num_decomps: int
    resolutions: List[ResolutionGeom]  # index r = resolution number
    dfs: Optional[Dfs] = None          # Part-2 DFS in effect, if any

    def res_downsamp(self, skipped: int) -> Tuple[int, int]:
        """Extra (x, y) downsampling after skipping resolutions
        (param_dfs::get_res_downsamp; (2^skip, 2^skip) without DFS)."""
        if self.dfs is not None:
            return self.dfs.get_res_downsamp(skipped)
        return 1 << skipped, 1 << skipped


@dataclass(slots=True)
class TileGeom:
    idx: int
    rect: Rect
    comps: List[TileCompGeom]


def band_rect(res: Rect, band_num: int) -> Rect:
    """Subband rectangle from resolution rect (T.800 eq. B-15;
    ojph_resolution.cpp:113-124)."""
    xo, yo = band_num & 1, band_num >> 1
    return Rect((res.x0 - xo + 1) >> 1, (res.y0 - yo + 1) >> 1,
                (res.x1 - xo + 1) >> 1, (res.y1 - yo + 1) >> 1)


def _build_subband(rect: Rect, band_num: int, cod: Cod, qcd: Qcd,
                   res_num: int, reversible: bool,
                   horz_trx: bool, vert_trx: bool,
                   dfs: Optional[Dfs] = None,
                   num_decomps: int = 0) -> SubbandGeom:
    """ojph_subband.cpp:117-221."""
    sb = SubbandGeom(band_num, rect)
    log_ppx, log_ppy = cod.log_precinct_size(res_num)
    x_off = 1 if horz_trx else 0
    y_off = 1 if vert_trx else 0
    sb.log_cb_w = min(cod.log_block_w, log_ppx - x_off)
    sb.log_cb_h = min(cod.log_block_h, log_ppy - y_off)
    band_idx = dfs.get_subband_idx(num_decomps, res_num, band_num) \
        if dfs is not None else None
    sb.kmax = qcd.get_kmax(res_num, band_num, idx=band_idx)
    if not reversible:
        d = qcd.get_irrev_delta(res_num, band_num, idx=band_idx)
        sb.delta = d / float(1 << (31 - sb.kmax))
    if sb.empty:
        return sb
    nb_w, nb_h = 1 << sb.log_cb_w, 1 << sb.log_cb_h
    x_lb = (rect.x0 >> sb.log_cb_w) << sb.log_cb_w
    y_lb = (rect.y0 >> sb.log_cb_h) << sb.log_cb_h
    sb.num_cb_x = ceil_div(rect.x1, nb_w) - (rect.x0 >> sb.log_cb_w)
    sb.num_cb_y = ceil_div(rect.y1, nb_h) - (rect.y0 >> sb.log_cb_h)
    sb.blocks = CodeblockGrid(rect, sb.log_cb_w, sb.log_cb_h,
                              x_lb, y_lb, sb.num_cb_x, sb.num_cb_y)
    return sb


def _band_precinct_info(sb: SubbandGeom, res: ResolutionGeom) -> None:
    """Map codeblocks to precincts (ojph_subband.cpp:224-276)."""
    if sb.empty:
        return
    rr = res.rect
    pc_lft = (rr.x0 >> res.log_pp_w) << res.log_pp_w
    pc_top = (rr.y0 >> res.log_pp_h) << res.log_pp_h
    x_shift = 1 if res.horz_trx else 0
    y_shift = 1 if res.vert_trx else 0
    bx, by = sb.band_num & 1, sb.band_num >> 1
    coly = 0
    for y in range(res.num_prec_y):
        pcy0 = max(rr.y0, pc_top + (y << res.log_pp_h))
        pcy1 = min(rr.y1, pc_top + ((y + 1) << res.log_pp_h))
        pcy0 = (pcy0 - by + (1 << y_shift) - 1) >> y_shift
        pcy1 = (pcy1 - by + (1 << y_shift) - 1) >> y_shift
        yb = ceil_div(pcy1, 1 << sb.log_cb_h) - (pcy0 >> sb.log_cb_h)
        colx = 0
        for x in range(res.num_prec_x):
            pcx0 = max(rr.x0, pc_lft + (x << res.log_pp_w))
            pcx1 = min(rr.x1, pc_lft + ((x + 1) << res.log_pp_w))
            pcx0 = (pcx0 - bx + (1 << x_shift) - 1) >> x_shift
            pcx1 = (pcx1 - bx + (1 << x_shift) - 1) >> x_shift
            xb = ceil_div(pcx1, 1 << sb.log_cb_w) - (pcx0 >> sb.log_cb_w)
            p = res.precincts[y * res.num_prec_x + x]
            p.bands[sb.band_num] = PrecinctBandInfo(colx, coly, xb, yb)
            colx += xb
        coly += yb
    assert colx == sb.num_cb_x and coly == sb.num_cb_y


def _build_resolution(res_rect: Rect, res_num: int, cod: Cod, qcd: Qcd,
                      tile_rect: Rect, comp_dx: int, comp_dy: int,
                      reversible: bool,
                      out: List[Optional[ResolutionGeom]],
                      dfs: Optional[Dfs] = None,
                      num_decomps: int = 0) -> None:
    """Recursive construction (ojph_resolution.cpp:240-459).  With a
    Part-2 DFS marker, each level may split both ways (4-way band
    split), horizontally only (child = low columns, one HL band),
    vertically only (child = low rows, one LH band), or not at all
    (child = same rect, no bands)."""
    log_ppx, log_ppy = cod.log_precinct_size(res_num)
    res = ResolutionGeom(res_num, res_rect, [None] * 4, log_ppx, log_ppy)
    res.horz_even = (res_rect.x0 & 1) == 0
    res.vert_even = (res_rect.y0 & 1) == 0
    ds = Dfs.BIDIR_DWT
    if dfs is not None and res_num > 0:
        ds = dfs.get_dwt_type(num_decomps - res_num + 1)
    res.dwt_type = ds
    res.horz_trx = res_num > 0 and ds in (Dfs.BIDIR_DWT, Dfs.HORZ_DWT)
    res.vert_trx = res_num > 0 and ds in (Dfs.BIDIR_DWT, Dfs.VERT_DWT)
    out[res_num] = res

    def recurse(child: Rect, dx: int, dy: int):
        _build_resolution(child, res_num - 1, cod, qcd, tile_rect,
                          dx, dy, reversible, out, dfs, num_decomps)

    def subband(rect: Rect, b: int) -> SubbandGeom:
        return _build_subband(rect, b, cod, qcd, res_num, reversible,
                              res.horz_trx, res.vert_trx, dfs, num_decomps)

    if res_num > 0:
        if ds == Dfs.BIDIR_DWT:
            recurse(band_rect(res_rect, 0), comp_dx * 2, comp_dy * 2)
            for b in (1, 2, 3):
                res.bands[b] = subband(band_rect(res_rect, b), b)
        elif ds == Dfs.VERT_DWT:
            # child keeps the full width; one LH-position band (index 2)
            # (ojph_resolution.cpp:339-362)
            child = Rect(res_rect.x0, (res_rect.y0 + 1) >> 1,
                         res_rect.x1, (res_rect.y1 + 1) >> 1)
            recurse(child, comp_dx, comp_dy * 2)
            res.bands[2] = subband(
                Rect(res_rect.x0, res_rect.y0 >> 1,
                     res_rect.x1, res_rect.y1 >> 1), 2)
        elif ds == Dfs.HORZ_DWT:
            # child keeps the full height; one HL-position band (index 1)
            child = Rect((res_rect.x0 + 1) >> 1, res_rect.y0,
                         (res_rect.x1 + 1) >> 1, res_rect.y1)
            recurse(child, comp_dx * 2, comp_dy)
            res.bands[1] = subband(
                Rect(res_rect.x0 >> 1, res_rect.y0,
                     res_rect.x1 >> 1, res_rect.y1), 1)
        else:  # NO_DWT: pass-through level with no subbands
            recurse(res_rect, comp_dx, comp_dy)
    else:
        res.bands[0] = subband(res_rect, 0)

    if not res_rect.empty:
        res.num_prec_x = ceil_div(res_rect.x1, 1 << log_ppx) \
            - (res_rect.x0 >> log_ppx)
        res.num_prec_y = ceil_div(res_rect.y1, 1 << log_ppy) \
            - (res_rect.y0 >> log_ppy)
        x_lb = (res_rect.x0 >> log_ppx) << log_ppx
        y_lb = (res_rect.y0 >> log_ppy) << log_ppy
        for y in range(res.num_prec_y):
            ppy0 = y_lb + (y << log_ppy)
            for x in range(res.num_prec_x):
                ppx0 = x_lb + (x << log_ppx)
                # image point for progression ordering
                # (ojph_resolution.cpp:421-439): canvas point of the
                # precinct origin clamped to the tile top-left
                tx = max(comp_dx * ppx0, tile_rect.x0)
                ty = max(comp_dy * ppy0, tile_rect.y0)
                res.precincts.append(
                    PrecinctGeom(x, y, (tx, ty),
                                 [PrecinctBandInfo() for _ in range(4)]))
        for b in range(4):
            if res.bands[b] is not None and not res.bands[b].empty:
                _band_precinct_info(res.bands[b], res)


def build_tile_grid(siz: Siz) -> List[Rect]:
    """Tile rectangles in raster order (ojph_codestream_local.cpp:120-218)."""
    from .message import error as _err
    num_x = ceil_div(siz.xsiz - siz.xtosiz, siz.xtsiz)
    num_y = ceil_div(siz.ysiz - siz.ytosiz, siz.ytsiz)
    # work-explosion guard, same codes as the reference
    # (ojph_codestream_local.cpp:120-123); a fuzzed SIZ can otherwise
    # declare a billion-tile grid and hang the grid walk
    if num_x * num_y > 65535:
        _err(0x00030011, 'the number of tiles cannot exceed 65535')
    if num_x * num_y <= 0:
        _err(0x00030012, 'the number of tiles cannot be 0')
    tiles = []
    for ty in range(num_y):
        y0 = max(siz.yosiz, siz.ytosiz + ty * siz.ytsiz)
        y1 = min(siz.ysiz, siz.ytosiz + (ty + 1) * siz.ytsiz)
        for tx in range(num_x):
            x0 = max(siz.xosiz, siz.xtosiz + tx * siz.xtsiz)
            x1 = min(siz.xsiz, siz.xtosiz + (tx + 1) * siz.xtsiz)
            tiles.append(Rect(x0, y0, x1, y1))
    return tiles


def build_tile(hdr: MainHeader, tile_idx: int, tile_rect: Rect) -> TileGeom:
    """Full coding layout of one tile (ojph_tile.cpp:190-305)."""
    siz = hdr.siz
    comps = []
    for c in range(siz.num_comps):
        cod = hdr.get_cod(c)
        qcd = hdr.get_qcd(c)
        dx, dy = siz.comps[c].dx, siz.comps[c].dy
        crect = Rect(ceil_div(tile_rect.x0, dx), ceil_div(tile_rect.y0, dy),
                     ceil_div(tile_rect.x1, dx), ceil_div(tile_rect.y1, dy))
        nd = cod.num_decomps
        dfs = hdr.get_dfs(cod.dfs_idx) if cod.dfs_idx is not None else None
        res_list: List[Optional[ResolutionGeom]] = [None] * (nd + 1)
        _build_resolution(crect, nd, cod, qcd, tile_rect, dx, dy,
                          cod.is_reversible, res_list, dfs, nd)
        comps.append(TileCompGeom(c, crect, nd, res_list, dfs))
    return TileGeom(tile_idx, tile_rect, comps)
