"""Fused frame decode on one GPU: host Tier-2 parse -> plan -> pack ->
one upload -> Tier-1 (the CUDA HT cleanup decoder, then the CUDA
refinement-pass decoder on lane groups with SigProp / MagRef) -> placement ->
dequantization -> inverse DWT -> inverse colour -> sample conversion,
with the frames left in device memory until the caller takes them.

The planner and packers are the JAX package's (tpu/pipeline.py) with
three changes: lane groups are padded to multiples of 8 (the 128-lane
padding was a TPU register constraint), the raw-bytes packer has
no stuffing-density ceiling, because the kernel unstuffs each lane's
bytes itself, and the planner's per-frame part is one native pass over
the lanes (native.plan_lanes) through a lane map cached with the
geometry, with the same output.  Codeblocks are the batch axis: all blocks of
one width form a lane group, heights padded to the group maximum, and
a burst of same-geometry frames is batched along the lanes (frame f of
group g occupies lanes [f*n_pad, (f+1)*n_pad)).

Two runner modes: ``raw=True`` ships one buffer (the stuffed segment
bytes plus per-lane meta) and the kernels unstuff them;
``raw=False`` ships host-unstuffed dense words plus meta.  A plan with
multi-pass codeblocks adds a second meta plane (rmeta) per lane.

Codeblocks of more than 30 bit planes (ROADMAP 7c) run on the kernels'
64-bit instantiations.  A reversible band of kmax >= 31 (a wide band)
has lane groups of its own, decoded in 64 bits; so is a narrow band's
group for a frame in which one of its live lanes has missing_msbs >= 30,
which only a corrupt packet header gives.  Each lane then ends as the
JAX package's host decoder leaves it (coding/decoder.py decodes
missing_msbs >= 30 in 64 bits, fewer in 32; codec.py's _tx_from_cb
reads a pattern by its band's width): in int64 band planes for wide
bands, int32 ones for the others.  A frame with a wide band reconstructs
as that host decoder does (codec.py:302-303, 376-390): the DWT in the
bands' own widths, the RCT and the sample conversion in int64, and the
output unclamped, int64 for unsigned 32-bit components and int32 for
the rest.
"""
from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import native
from ..codec import Decoder
from ..core.message import warn as _wrn
from ..core.markers import Dfs
from ..utils import trace
from ..utils.cache import Cache
from . import block_decode_cuda, block_refine_cuda
from . import color as clr
from . import dwt
from .block_decode import srl
from .block_decode_cuda import decode_cleanup, decode_cleanup_raw
from .block_refine_cuda import refine, refine_raw
from .quant import tx_from_cb
from .staging import Stager

# Blob and dense-buffer margins keep the JAX package's layout
# (its device window fetch read rows of this many words), so the two
# packers produce identical buffers.
_ROW = 512


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device``; RuntimeError when
    CUDA is asked for and none is present (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'openjph_tpu_torch: device %r requested but CUDA is not '
                'available; pass device="cpu" to run the plain PyTorch '
                'versions on the CPU' % str(device))
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r}')
    return dev


def _narrow_dtype(bd: int, sgn: bool):
    """Smallest dtype holding bd-bit samples."""
    if bd <= 8:
        return torch.int8 if sgn else torch.uint8
    if bd <= 16:
        return torch.int16 if sgn else torch.uint16
    return torch.int32


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a small set of sizes (pow2 below 256, then multiples
    of 256) so padding waste stays low."""
    b = lo
    while b < n and b < 256:
        b *= 2
    if n <= b:
        return b
    return -(-n // 256) * 256


# ---------------------------------------------------------------------------
# Decode plan: static description of one stream geometry
# ---------------------------------------------------------------------------

@dataclass
class _Group:
    gid: int
    w: int
    h: int = 0                      # max true height (padded target)
    members: list = field(default_factory=list)
    n_pad: int = 0
    words: Tuple[int, int, int] = (0, 0, 0)
    # refine-stream word widths (0, 0) when no lane has SigProp/MagRef
    rwords: Tuple[int, int] = (0, 0)
    # sample width of the group's decode: 64 for a wide band's group, or
    # where a live lane has missing_msbs >= 30
    bits: int = 32


@dataclass
class _Plan:
    key: tuple
    groups: List[_Group]
    # (gid, lane0, nrows, ncols, h_true, y0, band_id, x0)
    placements: List[tuple]
    # band_id -> (H, W, kmax, delta, reversible)
    bands: List[tuple]
    # per tile: (mct, (comp struct, ...), narrow_ok), and True after them
    # where the frame has a wide band and reconstructs as the host decoder
    # does; a frame without one has the JAX package's key
    tiles: List[tuple]
    # per-lane arrays in meta order (pos, lcup, scup, p, qhl, npasses,
    # len2, h_true, causal); pos == -1 marks a dead/padding lane
    lanes: object = None
    has_refine: bool = False
    # live lanes deadened at plan time under resilience
    broken: int = 0


def _res_band_list(res, r: int):
    """Bands present at a resolution level under its (possibly
    Part-2 DFS) decomposition type (ojph_resolution.cpp:104-187):
    BIDIR -> HL/LH/HH, H-only -> band 1, V-only -> band 2, NO_DWT ->
    none (pass-through level)."""
    if r == 0:
        return [0]
    dt = res.dwt_type
    if dt == Dfs.BIDIR_DWT:
        return [1, 2, 3]
    if dt == Dfs.HORZ_DWT:
        return [1]
    if dt == Dfs.VERT_DWT:
        return [2]
    return []


# ---------------------------------------------------------------------------
# Planner: the geometry walk is cached per stream header (it is
# identical for every frame of a video), with a lane map that names each
# lane's record; per frame, one native pass over the lanes
# (native.plan_lanes) reads the Tier-2 record tables through it.
# ---------------------------------------------------------------------------

class _Skel:
    __slots__ = ('groups', 'merged', 'bands', 'tiles', 'gtab', 'lane_map')


class _SkelGroup:
    __slots__ = ('gid', 'w', 'h', 'n_pad', 'nm', 'lanes', 'wide')


_SKELS = Cache(32)


def _plan_skeleton(dec, tile_indices):
    """Geometry-only plan parts (groups' lane layout, placements,
    bands, tiles), cached per (header bytes, skip, tiles).  A subset of
    tiles is keyed by its tiles' signatures (_tile_signature), not their
    indices: the skeleton names a tile by its place in ``tile_indices``,
    so tiles of one geometry share it (a mosaic's tiles, planned one or
    one sub-batch at a time)."""
    tiles = None if tile_indices is None else tuple(
        _tile_signature(dec.tiles[ti]) for ti in tile_indices)
    ck = (bytes(dec.data[:dec.hdr.header_size]), dec.skip_recon, tiles)
    return _SKELS.get(ck, lambda: _build_skeleton(dec, tile_indices))


def _tile_signature(st) -> tuple:
    """What a tile's plan skeleton takes from the tile's own geometry
    (the rest is the header's): per resolution its parities and
    transform, per band its size, its offset in the codeblock grid, the
    grid's cell and its kmax and delta."""
    return tuple(
        (comp.num_decomps,) + tuple(
            (res.rect.x0 & 1, res.rect.y0 & 1, res.dwt_type) + tuple(
                (b, sb.rect.w, sb.rect.h,
                 sb.rect.x0 & ((1 << sb.log_cb_w) - 1),
                 sb.rect.y0 & ((1 << sb.log_cb_h) - 1),
                 sb.log_cb_w, sb.log_cb_h, sb.kmax, sb.delta)
                for b in _res_band_list(res, r)
                for sb in (res.bands[b],))
            for r, res in enumerate(comp.resolutions))
        for comp in st.geom.comps)


def _build_skeleton(dec, tile_indices):
    placements = []
    bands = []
    tiles = []
    # lane groups by (block width, wide band)
    groups: Dict[tuple, _SkelGroup] = {}
    sel_idx = (range(len(dec.tiles)) if tile_indices is None
               else tile_indices)
    host_out = any(dec._wide_band(dec.tiles[idx]) for idx in sel_idx)
    # ti: the tile's place in sel_idx (_plan_skeleton)
    for ti, idx in enumerate(sel_idx):
        st = dec.tiles[idx]
        tile_comps = []
        for c, comp in enumerate(st.geom.comps):
            cod = dec.hdr.get_cod(c)
            rev = cod.is_reversible
            skip = min(dec.skip_recon, comp.num_decomps)
            top = comp.num_decomps - skip
            res_specs = []
            for r in range(top + 1):
                res = comp.resolutions[r]
                bids = []
                for b in _res_band_list(res, r):
                    sb = res.bands[b]
                    bid = len(bands)
                    bands.append((sb.rect.h, sb.rect.w, sb.kmax,
                                  float(sb.delta), rev))
                    bids.append(bid)
                    wide = _wide(sb.kmax, rev)
                    # an empty band has no record, and no lane
                    first = st.walk.layout.get((c, r, b), 0)
                    causal = cod.vert_causal
                    run = None  # (gid, lane0, ncols, h_true, y0, x0)
                    for g in sb.blocks:
                        grp = groups.get((g.rect.w, wide))
                        if grp is None:
                            grp = _SkelGroup()
                            grp.gid = len(groups)
                            grp.w = g.rect.w
                            grp.h = 0
                            grp.nm = 0
                            grp.lanes = []
                            grp.wide = wide
                            groups[(g.rect.w, wide)] = grp
                        lane = grp.nm
                        grp.nm += 1
                        grp.h = max(grp.h, g.rect.h)
                        # the lane map: tile, record, qh, h, causal
                        grp.lanes.append(
                            (ti, first + g.cb_y * sb.num_cb_x + g.cb_x,
                             (g.rect.h + 1) >> 1, g.rect.h, causal))
                        y0 = g.rect.y0 - sb.rect.y0
                        x0 = g.rect.x0 - sb.rect.x0
                        if run is not None and run[0] == grp.gid \
                                and run[3] == g.rect.h \
                                and run[4] == y0 \
                                and run[5] + run[2] * g.rect.w == x0 \
                                and lane == run[1] + run[2]:
                            run = (run[0], run[1], run[2] + 1, run[3],
                                   run[4], run[5])
                        else:
                            if run is not None:
                                placements.append(run + (bid,))
                            run = (grp.gid, lane, 1, g.rect.h, y0, x0)
                    if run is not None:
                        placements.append(run + (bid,))
                h_even = (res.rect.x0 & 1) == 0
                v_even = (res.rect.y0 & 1) == 0
                res_specs.append((tuple(bids), h_even, v_even,
                                  int(res.dwt_type)))
            tile_comps.append((tuple(res_specs), rev,
                               dec.hdr.siz.comps[c].bit_depth,
                               dec.hdr.siz.comps[c].is_signed,
                               dec.hdr.nlt.type3_for(c),
                               cod.kernel))
        nc = dec.hdr.siz.num_comps
        mct = dec.hdr.cod.mc_trans == 1 and nc >= 3
        # narrowing to 8/16-bit is only valid at full reconstruction:
        # skipped-resolution output is LL coefficients with DWT gain,
        # which legitimately exceed the nominal sample range
        tiles.append((mct, tuple(tile_comps), dec.skip_recon == 0)
                     + ((True,) if host_out else ()))

    glist = sorted(groups.values(), key=lambda g: g.gid)
    gtab = np.zeros((len(glist), 4), np.int32)
    at = 0
    for i, grp in enumerate(glist):
        grp.n_pad = _bucket(grp.nm)
        gtab[i] = (grp.nm, grp.n_pad, grp.wide, at)
        at += grp.nm
    cols = list(zip(*(ln for grp in glist for ln in grp.lanes))) \
        or [()] * 5
    lane_map = tuple(np.ascontiguousarray(col, dt) for col, dt in zip(
        cols, (np.int32, np.int32, np.int32, np.int32, np.uint8)))

    # vertical merge of compatible row strips
    merged = []
    for (gid, lane0, ncols, h_t, y0, x0, bid) in placements:
        if merged:
            m = merged[-1]
            if m[0] == gid and m[6] == bid and m[3] == ncols \
                    and m[4] == h_t and m[7] == x0 \
                    and m[5] + m[2] * h_t == y0 \
                    and m[1] + m[2] * ncols == lane0:
                merged[-1] = (m[0], m[1], m[2] + 1, m[3], m[4], m[5],
                              m[6], m[7])
                continue
        merged.append((gid, lane0, 1, ncols, h_t, y0, bid, x0))

    skel = _Skel()
    skel.groups = glist
    skel.merged = merged
    skel.bands = bands
    skel.tiles = tiles
    skel.gtab = gtab
    skel.lane_map = lane_map
    return skel


def _wide(kmax: int, reversible: bool) -> bool:
    """A band the host decoder reconstructs in 64 bits (codec.py:302)."""
    return reversible and kmax >= 31


def _key_group(g: _Group) -> tuple:
    """A group's part of the plan key: the JAX package's (gid, w, h,
    n_pad, words, rwords), and 64 after it for a 64-bit group, so that a
    stream the JAX fused path takes has the JAX package's key."""
    return (g.gid, g.w, g.h, g.n_pad, g.words, g.rwords) \
        + ((64,) if g.bits == 64 else ())


# the host decoder's per-codeblock checks (decode_codeblock,
# coding/decoder.py:163-213), in its order: its ValueError messages, by
# native.plan_lanes' code - 1 (short coded bytes, more than 3 passes,
# missing_msbs >= 62, lcup < 2, a bad scup)
_BROKEN = ('ojph error 0x00080002: wrong codeblock length',
           'more than 3 coding passes not supported',
           '64 bits insufficient for this codeblock',
           'wrong codeblock length',
           'invalid scup')


def _build_plan(dec, tile_indices=None) -> _Plan:
    """Per-frame plan from the Tier-2 record arrays.  A live lane that
    the host decoder would refuse (short coded bytes, more than 3
    passes, missing_msbs >= 62, lcup < 2, a bad scup) raises its
    ValueError, or under ``dec.resilient`` is planned as a dead lane (a
    zero block) and counted in ``plan.broken``.  A group decodes in 64
    bits (p = 62 - missing_msbs) when it is a wide band's, or when one of
    its live lanes has missing_msbs >= 30.  ``tile_indices`` restricts
    the plan to a subset of tiles."""
    skel = _plan_skeleton(dec, tile_indices)
    if not skel.groups:
        # a frame without a codeblock (a corrupt header's empty image):
        # refused, with the JAX package's planner's error
        raise ValueError('need at least one array to concatenate')
    sel_idx = (range(len(dec.tiles)) if tile_indices is None
               else tile_indices)
    tiles = [dec.tiles[i] for i in sel_idx]
    n = sum(g.n_pad for g in skel.groups)
    lanes = (np.empty(n, np.int64), np.empty(n, np.int64),
             np.empty(n, np.int64), np.empty(n, np.int32),
             np.empty(n, np.int32), np.empty(n, np.int32),
             np.empty(n, np.int64), np.empty(n, np.int32),
             np.empty(n, bool))
    code = np.empty(n, np.int32)
    gstat = np.empty((len(skel.groups), 4), np.int64)
    buf = dec.data if isinstance(dec.data, np.ndarray) \
        else np.frombuffer(dec.data, np.uint8)
    native.plan_lanes(buf, [st.rec_table for st in tiles],
                      [st.rec_pos for st in tiles], skel.gtab,
                      skel.lane_map, lanes, code, gstat)
    broken = np.flatnonzero(code)
    if broken.size and not dec.resilient:
        raise ValueError(_BROKEN[int(code[broken[0]]) - 1])
    # under resilience the reference zeroes a broken codeblock and goes
    # on (ojph_codeblock.cpp:214-225, ojph_precinct.cpp:558-568): the
    # pass planned it as a dead lane
    glist = []
    key_groups = []
    for g, (bits, smax, msmax, l2max) in zip(skel.groups, gstat.tolist()):
        if smax >= 0:
            wm = _bucket(((smax - 1) * 8 + 31) // 32 + 2)
            wv = _bucket((4 + (smax - 2) * 8 + 31) // 32 + 2)
            ws = _bucket((msmax * 8 + 31) // 32 + 2)
            words = (wm, wv, ws)
        else:
            words = (8, 8, 8)
        rwords = (0, 0)
        if l2max > 0:
            wr = _bucket((l2max * 8 + 31) // 32 + 3)
            rwords = (wr, wr)
        grp = _Group(g.gid, g.w, g.h, members=[None] * g.nm,
                     n_pad=g.n_pad, words=words, rwords=rwords, bits=bits)
        glist.append(grp)
        key_groups.append(_key_group(grp))
    key = (tuple(key_groups), tuple(skel.merged), tuple(skel.bands),
           tuple(skel.tiles))
    plan = _Plan(key, glist, skel.merged, skel.bands, skel.tiles)
    plan.lanes = lanes
    plan.has_refine = any(g.rwords[0] > 0 for g in glist)
    plan.broken = int(broken.size)
    return plan


# ---------------------------------------------------------------------------
# Device runner
# ---------------------------------------------------------------------------

class _Runner:
    """The fused decode of ``nframes`` same-geometry frames on
    ``device``.  ``tier1(*args)`` runs, per lane group, the HT cleanup
    decoder, then the refinement-pass decoder where the group has
    SigProp / MagRef, and zeroes dead and broken lanes; ``rest(decs)``
    places the codeblocks into band planes and reconstructs; calling the
    runner does both and returns (err [lanes] bool, outputs), outputs
    being per tile a tuple of per-component [nframes, h, w] tensors.

    ``rest`` launches its ops eagerly, unless ``graphs`` is set and the
    device is a CUDA device: then it runs them through ``_REST_GRAPHS``,
    which captures them into a CUDA graph at the second sighting of the
    runner's ``rest_key`` and replays that graph from then on.  The ops'
    control flow reads only that key (the plan's geometry, its groups'
    sample widths, the frames and the device), so one graph serves every
    runner of the key, whatever its word buckets or input layout.  The
    burst runners set ``graphs``; a runner made for a single call
    leaves it off."""

    def __init__(self, plan: _Plan, nframes: int, device, raw: bool,
                 graphs: bool = False):
        self.plan = plan
        self.F = nframes
        self.device = torch.device(device)
        self.raw = raw
        self.lane_starts = []
        tl = 0
        for g in plan.groups:
            self.lane_starts.append(tl)
            tl += g.n_pad
        self.tl = tl
        self.graphs = graphs
        self.rest_key = (_geometry_key(plan.key),
                         tuple(g.bits for g in plan.groups), nframes,
                         self.device)

    def __call__(self, *args):
        with trace.stage('decode.dispatch.tier1'):
            decs, errs = self.tier1(*args)
            errs = torch.cat(errs)
        with trace.stage('decode.dispatch.rest'):
            return errs, self.rest(decs)

    def tier1(self, *args):
        src, views = self.views(*args)
        outs = self.refine(src, views, self.cleanup(src, views))
        return self.mask(views, outs)

    def views(self, *args):
        """(src, per group (group, meta columns, rmeta columns or None)):
        src is the uint8 blob (raw) or the words buffer (dense); the
        columns are int32 [F * n_pad] tensors."""
        F, tl = self.F, self.tl
        n = F * tl * 8
        rmeta = None
        if self.raw:
            buf, = args
            src = buf.view(torch.uint8)
            tail = buf[buf.shape[0] - n * (2 if self.plan.has_refine
                                           else 1):]
            meta = tail[:n]
            if self.plan.has_refine:
                rmeta = tail[n:]
        elif self.plan.has_refine:
            src, meta, rmeta = args
        else:
            src, meta = args

        def cols(m, g, s0):
            mg = m.reshape(F, tl, 8)[:, s0:s0 + g.n_pad] \
                .reshape(F * g.n_pad, 8)
            return [mg[:, k].contiguous() for k in range(8)]

        return src, [(g, cols(meta, g, s0),
                      cols(rmeta, g, s0) if g.rwords[0] > 0 else None)
                     for g, s0 in zip(self.plan.groups, self.lane_starts)]

    def cleanup(self, src, views):
        """The HT cleanup decoder per group: [(dec, err)]."""
        outs = []
        for g, col, _ in views:
            p, qhl = col[6], col[7]
            if self.raw:
                # meta: lane_off, ms_n, sh_n, 0, 0, 0, p, qhl
                outs.append(decode_cleanup_raw(src, col[0], col[1], col[2],
                                               p, g.w, g.h, qhl, g.words,
                                               g.bits))
            else:
                # meta: mel_off, lm, vlc_off, lv, ms_off, ls, p, qhl
                wm, wv, ws = g.words
                mel = _window(src, col[0], col[1], wm, -1)
                vlc = _window(src, col[2], col[3], wv, 0)
                ms = _window(src, col[4], col[5], ws, -1)
                outs.append(decode_cleanup(mel, vlc, ms, p, g.w, g.h, qhl,
                                           g.bits))
        return outs

    def refine(self, src, views, outs):
        """SigProp / MagRef on the groups that have them, before the
        masking of dead and broken lanes (tpu/pipeline.py:791-821)."""
        res = []
        for (g, col, rc), (d, e) in zip(views, outs):
            if rc is not None:
                p = col[6]
                if self.raw:
                    # rmeta: roff, len2, 0, 0, npasses, h_true, causal, 0
                    d = refine_raw(d, src, rc[0], rc[1], p, rc[4], rc[5],
                                   rc[6], g.w, g.h)
                else:
                    # rmeta: spp_off, lsp, mrp_off, lmr, npasses, h_true,
                    # causal, 0
                    spp = _window(src, rc[0], rc[1], g.rwords[0], 0)
                    mrp = _window(src, rc[2], rc[3], g.rwords[1], 0)
                    d = refine(d, spp, mrp, p, rc[4], rc[5], rc[6], g.w,
                               g.h)
            res.append((d, e))
        return res

    def mask(self, views, outs):
        """Dead and broken lanes decode to zero blocks (the caller raises
        on the error flags, or under resilience keeps the zero blocks,
        as the reference does).  In a 64-bit group a lane of missing_msbs
        < 30 (p = 62 - missing_msbs > 32) becomes the uint32 pattern the
        host decoder's 32-bit decode gives: the 64-bit one shifted down by
        32.  Returns (decs [F, n_pad, h, w] per group, errs of the groups'
        members)."""
        F = self.F
        decs, errs = [], []
        for (g, col, _), (d, e) in zip(views, outs):
            ok = (col[7] > 0) & ~e
            d = torch.where(ok[:, None, None], d, torch.zeros_like(d))
            if g.bits == 64:
                d = torch.where((col[6] <= 32)[:, None, None], d,
                                srl(d, 32))
            decs.append(d.reshape(F, g.n_pad, g.h, g.w))
            errs.append(e.reshape(F, g.n_pad)[:, :len(g.members)]
                        .reshape(-1))
        return decs, errs

    def rest(self, decs):
        """Per tile, the tuple of its components' [F, h, w] outputs of
        ``decs``, fresh tensors on every call: replayed from the key's
        CUDA graph where there is one, else launched eagerly."""
        if self.graphs and _RestGraph.supported(self.device):
            outs = _REST_GRAPHS.run(self.rest_key, self._ops, decs)
            if outs is not None:
                return outs
        with trace.stage('decode.rest_graph.eager'):
            return self._ops(decs)

    def _ops(self, decs):
        F = self.F
        plan = self.plan
        planes = [torch.zeros((F, H, W), dtype=torch.int64
                              if _wide(kmax, rev) else torch.int32,
                              device=self.device)
                  for (H, W, kmax, _, rev) in plan.bands]
        for (gid, lane0, nrows, ncols, h_t, y0, bid, x0) in \
                plan.placements:
            w_t = plan.groups[gid].w
            d = _as_band(decs[gid][:, lane0:lane0 + nrows * ncols, :h_t, :w_t],
                         planes[bid].dtype)
            strip = d.reshape(F, nrows, ncols, h_t, w_t) \
                .permute(0, 1, 3, 2, 4) \
                .reshape(F, nrows * h_t, ncols * w_t)
            planes[bid][:, y0:y0 + nrows * h_t,
                        x0:x0 + ncols * w_t] = strip
        deq = [tx_from_cb(planes[i], kmax, delta, rev)
               for i, (_, _, kmax, delta, rev) in enumerate(plan.bands)]

        outs = []
        for (mct, comps, narrow_ok, *host_out) in plan.tiles:
            rec = []
            for (res_specs, rev, bd, sgn, nlt3, kern) in comps:
                plane = deq[res_specs[0][0][0]]
                for (bids, h_even, v_even, dt) in res_specs[1:]:
                    # Part-2 DFS: a level may split both ways, one
                    # way, or not at all (ojph_resolution.cpp:713-949)
                    if dt == Dfs.BIDIR_DWT:
                        plane = dwt.inv_dwt2d(
                            plane, deq[bids[0]], deq[bids[1]],
                            deq[bids[2]], h_even, v_even, rev, kern)
                    elif dt == Dfs.HORZ_DWT:
                        plane = dwt.inv_atk_1d(plane, deq[bids[0]],
                                               h_even, plane.ndim - 1,
                                               kern)
                    elif dt == Dfs.VERT_DWT:
                        plane = dwt.inv_atk_1d(plane, deq[bids[0]],
                                               v_even, plane.ndim - 2,
                                               kern)
                    # NO_DWT: pass-through level
                rec.append(plane)
            if mct:
                if comps[0][1]:
                    if host_out:
                        rec[:3] = [r.to(torch.int64) for r in rec[:3]]
                    rec[0], rec[1], rec[2] = clr.rct_backward(
                        rec[0], rec[1], rec[2])
                else:
                    rec[0], rec[1], rec[2] = clr.ict_backward(
                        rec[0], rec[1], rec[2])
            conv = []
            for ci, (res_specs, rev, bd, sgn, nlt3, _) in enumerate(comps):
                if host_out:
                    # as the host decoder: int64 conversion, unclamped
                    # (codec.py:376-390)
                    if rev:
                        c = clr.rev_convert_out(rec[ci].to(torch.int64),
                                                bd, sgn, nlt3)
                    else:
                        c = clr.irv_convert_to_integer(rec[ci], bd, sgn,
                                                       nlt3)
                    conv.append(c.to(torch.int64 if rev and bd >= 32
                                     and not sgn else torch.int32))
                    continue
                if rev:
                    c = clr.rev_convert_out(rec[ci], bd, sgn, nlt3)
                else:
                    c = clr.irv_convert_to_integer(rec[ci], bd, sgn, nlt3)
                # clipped to the nominal range and narrowed, as the
                # JAX fused path does (skipped-resolution output keeps
                # int32: it is LL coefficients with DWT gain)
                dtype = _narrow_dtype(bd, sgn) if narrow_ok else torch.int32
                if dtype != torch.int32:
                    lo, hi = ((-(1 << (bd - 1)), (1 << (bd - 1)) - 1)
                              if sgn else (0, (1 << bd) - 1))
                    c = c.clamp(lo, hi)
                conv.append(c.to(dtype))
            outs.append(tuple(conv))
        return tuple(outs)


class _RestGraph:
    """The rest of graph of one key captured into a CUDA graph: static
    inputs (a group's decoded lanes each), the graph, and its outputs in
    the graph's own memory pool, ``nbytes`` large.

    ``replay(decs)`` copies ``decs`` into the inputs, replays and clones
    the outputs, all on the caller's current stream, so callers get
    fresh tensors they may keep past the next replay.  A graph is shared
    by every runner of its key, across decoders, streams and threads:
    its entry's lock serialises replays, and each replay's stream waits
    for the previous replay's clones before it overwrites the inputs."""

    @staticmethod
    def supported(device) -> bool:
        return device.type == 'cuda'

    @staticmethod
    def budget(device) -> int:
        """The pool bytes the graphs of ``device`` may hold together:
        an eighth of the card."""
        return torch.cuda.get_device_properties(device).total_memory // 8

    def __init__(self, ops, decs, device):
        self.device = device
        # plain tensors, whether or not the capturing call runs in
        # inference mode, so any later caller may copy into them
        with torch.inference_mode(False):
            self.ins = [torch.empty_like(d) for d in decs]
        self.graph = torch.cuda.CUDAGraph()
        # a stream of the capture's own: two threads may capture at once
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(device),
                                  capture_error_mode='thread_local'):
                self.outs = ops(self.ins)
            index = torch.cuda.current_device()
        self.done = None   # an event after the last replay's clones
        pool = tuple(self.graph.pool())
        self.nbytes = sum(
            s['total_size'] for s in torch.cuda.memory_snapshot()
            if s['device'] == index
            and tuple(s.get('segment_pool_id', ())) == pool)

    def replay(self, decs):
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            if self.done is not None:
                stream.wait_event(self.done)
            for s, d in zip(self.ins, decs):
                s.copy_(d)
                # a dropped graph's inputs are not reused before the
                # replays of every stream that read them have run
                s.record_stream(stream)
            self.graph.replay()
            outs = tuple(tuple(c.clone() for c in t) for t in self.outs)
            self.done = torch.cuda.Event()
            self.done.record(stream)
        return outs

    def close(self) -> None:
        """Frees the graph and its pool once its last replay has run."""
        if self.done is not None:
            self.done.synchronize()
        self.graph = self.outs = self.ins = None


class _RestEntry:
    """A key's sightings (``calls``), its captured ``graph`` and what a
    failed capture raised (``error``), under ``lock``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls = 0
        self.graph = None
        self.error = None


class _RestGraphs:
    """The rest of graph's CUDA graphs by runner ``rest_key``.

    ``run(key, ops, decs)`` counts a sighting of ``key``: the first
    returns None (the caller launches ``ops`` eagerly), the second
    captures ``ops`` into a ``_RestGraph``, and that sighting and every
    later one return its replay.  A capture that raises leaves the key
    eager for good, with a warning and the error kept.  Entries go out
    least recently used first, past ``size`` keys or, for those holding
    a graph, past ``_RestGraph.budget`` pool bytes on a device (the
    newest graph stays); a key that went out starts again at its first
    sighting."""

    def __init__(self, size: int):
        self.size = size
        self._entries: 'OrderedDict' = OrderedDict()
        self._lock = threading.Lock()

    def entry(self, key) -> _RestEntry:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _RestEntry()
            else:
                self._entries.move_to_end(key)
        return e

    def run(self, key, ops, decs):
        e = self.entry(key)
        with e.lock:
            e.calls += 1
            captured = e.calls == 2 and self._capture(e, key, ops, decs)
            outs = None
            if e.graph is not None:
                with trace.stage('decode.rest_graph.replay'):
                    outs = e.graph.replay(decs)
        self._trim(key if captured else None)
        return outs

    def _capture(self, e, key, ops, decs) -> bool:
        with trace.stage('decode.rest_graph.capture'):
            try:
                e.graph = _RestGraph(ops, decs, key[-1])
            except Exception as err:  # any failure: the eager path stays
                e.error = err
                warnings.warn(f'the rest of graph stays eager: its CUDA '
                              f'graph capture raised {err!r}',
                              RuntimeWarning)
        return e.graph is not None

    def _trim(self, newest) -> None:
        """Drops the least recently used entries past ``size`` and, on
        ``newest``'s device, the graphs past its budget."""
        out = []
        with self._lock:
            while len(self._entries) > self.size:
                out.append(self._entries.popitem(last=False)[1])
            if newest is not None and newest in self._entries:
                device = newest[-1]
                held = [(k, e) for k, e in self._entries.items()
                        if k[-1] == device and e.graph is not None]
                total = sum(e.graph.nbytes for _, e in held)
                budget = _RestGraph.budget(device)
                for k, e in held:
                    if total <= budget:
                        break
                    if k != newest:
                        total -= e.graph.nbytes
                        out.append(self._entries.pop(k))
        for e in out:
            with e.lock:
                if e.graph is not None:
                    e.graph.close()
                    e.graph = None


def _as_band(d, dtype):
    """A group's decoded lanes as a band's samples: int64 patterns
    (64-bit groups) into an int32 (narrow) plane as the host decoder's
    32-bit reading takes them (codec.py _tx_from_cb: the low 31 bits, and
    the sign where any bit from 31 up is set), int32 patterns into an
    int64 (wide) plane zero-extended."""
    if d.dtype == dtype:
        return d
    if dtype == torch.int64:
        return d.to(torch.int64) & 0xFFFFFFFF
    neg = srl(d, 31) != 0
    low = (d & 0x7FFFFFFF).to(torch.int32)
    return torch.where(neg, low | torch.iinfo(torch.int32).min, low)


def _window(words, off, ln, width: int, guard: int):
    """[L, width] rows words[off : off + width] per lane, with
    ``guard`` (int32 bit pattern) at and past each lane's length."""
    j = torch.arange(width, dtype=torch.int64, device=words.device)
    idx = (off.to(torch.int64)[:, None] + j).clamp(0, words.shape[0] - 1)
    rows = words[idx]
    return torch.where(j[None, :] < ln[:, None], rows,
                       torch.full_like(rows, guard)).contiguous()


def _make_runner(plan: _Plan, nframes: int = 1, device='cuda',
                 raw: bool = True, graphs: bool = False) -> _Runner:
    """The fused decode of ``nframes`` frames of ``plan``'s geometry on
    ``device``; ``raw`` selects the raw-bytes (True) or dense-words
    (False) input layout; ``graphs`` replays the rest of graph from the
    shared CUDA graphs (``_Runner``).  On a CUDA device the kernels it
    launches are built here on first use, not at their first launch."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        block_decode_cuda.load()
        if plan.has_refine:
            block_refine_cuda.load()
    return _Runner(plan, nframes, dev, raw, graphs)


# ---------------------------------------------------------------------------
# Packers
# ---------------------------------------------------------------------------

def _bucket_words(n: int) -> int:
    """Dense-buffer size bucket: pow2 to 256Ki words, then 64Ki-word
    multiples."""
    b = 4096
    while b < n and b < (1 << 18):
        b *= 2
    if n <= b:
        return b
    return -(-n // (1 << 16)) * (1 << 16)


def _pack_burst(frames_groups: List[List[dict]]):
    """Pack every stream word of a burst into ONE uint32 buffer and
    the per-lane bookkeeping into ONE int32 buffer.  meta columns per
    lane: mel_off, lm, vlc_off, lv, ms_off, ls, p, qhl (offsets
    absolute into the words buffer; qhl == 0 marks a dead lane).
    Groups with refinement passes pack their SigProp / MagRef streams
    into the same buffer and contribute a second meta plane (rmeta:
    spp_off, lsp, mrp_off, lmr, npasses, h_true, causal, 0); the return
    grows to (words, meta, rmeta)."""
    chunks = []
    metas = []
    rmetas = []
    any_refine = any('spp' in gd for fg in frames_groups for gd in fg)
    maxw = 8  # widest stream window: the buffer's tail margin
    cursor = 0
    for fg in frames_groups:
        for gd in fg:
            cols = []
            keys = [('mel', 'lm'), ('vlc', 'lv'), ('ms', 'ls')]
            if 'spp' in gd:
                keys += [('spp', 'lsp'), ('mrp', 'lmr')]
            for k, lk in keys:
                arr, ln = gd[k], gd[lk]
                w = arr.shape[1]
                maxw = max(maxw, w)
                mask = np.arange(w, dtype=np.int32)[None, :] < ln[:, None]
                chunks.append(arr[mask])
                offs = cursor + np.concatenate(
                    [[0], np.cumsum(ln[:-1], dtype=np.int64)])
                cursor += int(ln.sum())
                cols += [offs.astype(np.int32), ln]
            n = gd['p'].shape[0]
            metas.append(np.stack(cols[:6] + [gd['p'], gd['qhl']], axis=1))
            if any_refine:
                if 'spp' in gd:
                    rmetas.append(np.stack(
                        cols[6:10] + [gd['np'], gd['ht'], gd['causal'],
                                      np.zeros(n, np.int32)], axis=1))
                else:
                    rmetas.append(np.zeros((n, 8), np.int32))
    words = np.concatenate(chunks)
    dpad = _bucket_words(words.size + maxw + _ROW + 2)
    words = np.pad(words, (0, dpad - words.size))
    meta = np.ascontiguousarray(np.concatenate(metas, axis=0), np.int32)
    if any_refine:
        rmeta = np.ascontiguousarray(np.concatenate(rmetas, axis=0),
                                     np.int32)
        return words, meta.reshape(-1), rmeta.reshape(-1)
    return words, meta.reshape(-1)


def _pack_burst_fast(pairs):
    """Native fast path of _pack_burst: per-lane stream words are
    unstuffed by C++ directly at their final dense-buffer positions,
    threaded over lanes."""
    datas: list = []
    lc, sc, pp, qq, caps = [], [], [], [], []
    for dec, plan in pairs:
        d, l, scp, ps, qh = dec._lane_info(plan)
        datas += d
        lc.append(l)
        sc.append(scp)
        pp.append(ps)
        qq.append(qh)
        caps.append(np.concatenate(
            [np.repeat(np.asarray(g.words, np.int64)[None, :],
                       g.n_pad, axis=0) for g in plan.groups]))
    lcups = np.concatenate(lc)
    scups = np.concatenate(sc)
    p = np.concatenate(pp)
    qhl = np.concatenate(qq)
    caps = np.concatenate(caps)  # [lanes, 3] word caps (wm, wv, ws)
    lm = np.minimum(caps[:, 0], (scups - 1) * 8 // 32 + 3)
    lv = np.minimum(caps[:, 1], ((scups - 2) * 8 + 4) // 32 + 3)
    ls = np.minimum(caps[:, 2], (lcups - scups) * 8 // 32 + 3)
    tot = lm + lv + ls
    base = np.zeros_like(tot)
    np.cumsum(tot[:-1], out=base[1:])
    meta = np.stack([base, lm, base + lm, lv, base + lm + lv, ls,
                     p.astype(np.int64), qhl.astype(np.int64)],
                    axis=1).astype(np.int32)
    blob = b''.join(datas)
    offsets = np.zeros(len(datas) + 1, np.int64)
    np.cumsum([len(d) for d in datas], out=offsets[1:])
    dense = np.zeros(_bucket_words(int(tot.sum())
                                   + int(caps.max()) + _ROW + 2),
                     np.uint32)
    native.prep_cleanup_dense(blob, offsets, lcups, scups, meta, dense)
    return dense, meta.reshape(-1)


def _blob_margin(pairs) -> int:
    """Lead/tail margin (bytes) of the raw-bytes blob (the JAX
    package's layout: max stream words + one row + 2, in words)."""
    mw = 8
    for _, p in pairs:
        for g in p.groups:
            mw = max(mw, *g.words, *g.rwords)
            mw = max(mw, g.words[2] + max(g.words[0], g.words[1]) + 2)
    return 4 * (mw + _ROW + 2)


class _HostBuffer:
    """A host buffer that one writer fills again and again: ``take(n)``
    is a uint32 view of its first n bytes, the buffer grown first (with
    an eighth to spare, so bursts of one geometry stop growing it) when
    it holds fewer; inside a traced burst a growth is the stage
    ``decode.pack.grow``."""

    def __init__(self):
        self._buf = np.empty(0, np.uint32)

    def take(self, nbytes: int) -> np.ndarray:
        if self._buf.nbytes < nbytes:
            with trace.burst_stage('decode.pack.grow'):
                self._buf = np.empty((nbytes + nbytes // 8) // 4, np.uint32)
        return self._buf[:nbytes // 4]


def _pack_device(pairs, out: _HostBuffer = None):
    """Raw-bytes layout of a burst of (decoder, plan) pairs, one buffer
    for one upload: each lane's blob range is d[0:lcup-1] (byte lcup-2
    OR'd 0xF), followed by its refinement segment when it has one, then
    the meta plane (range start, lcup - scup, scup - 1, 0, 0, 0, p, qhl)
    and for a refine plan the rmeta plane (range start + lcup - 1, len2,
    0, 0, npasses, h_true, causal, 0).  The kernels read MagSgn from the
    first lcup-scup bytes, MEL / VLC from the rest of the cleanup bytes,
    forward / backward, and SigProp / MagRef from the refinement
    segment, forward / backward.  The layout (margins, padding, planes)
    is sized here from plan.lanes; native.pack_raw_burst writes every
    byte of it in one pass, out of each frame's stream buffer, into
    ``out.take`` when ``out`` is given and a fresh buffer otherwise.
    Returns (buf,)."""
    refine = pairs[0][1].has_refine

    def cat(k):
        return np.concatenate([p.lanes[k] for _, p in pairs])

    # a lane's host address in its frame's stream; 0 marks a dead lane
    ptrs = np.concatenate([
        np.where(p.lanes[0] >= 0,
                 np.frombuffer(d.data, np.uint8).ctypes.data + p.lanes[0], 0)
        for d, p in pairs])
    lcups = cat(1)
    rinfo = (cat(6), cat(5), cat(7), cat(8)) if refine else None
    lead = _blob_margin(pairs)
    total = int(lcups.sum()) - len(lcups) + 2 * lead \
        + (int(rinfo[0].sum()) if refine else 0)
    padded = 4 * _bucket_words(max((total + 3) // 4 + 1, 2))
    nbytes = padded + 32 * len(lcups) * (2 if refine else 1)
    buf = np.empty(nbytes // 4, np.uint32) if out is None \
        else out.take(nbytes)
    native.pack_raw_burst(ptrs, lcups, cat(2), cat(3), cat(4), rinfo, lead,
                          padded, buf)
    return (buf,)


def _pack_dense(pairs):
    """Dense-words layout of a burst: (words, meta), and rmeta for a
    refine plan (packed through the per-group arrays, as the JAX
    package packs them)."""
    if any(p.has_refine for _, p in pairs):
        return _pack_burst([d._group_arrays(p) for d, p in pairs])
    return _pack_burst_fast(pairs)


def upload(args, device) -> tuple:
    """Host buffers (uint32 / int32 numpy) -> int32 tensors on device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 .to(device) for a in args)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class GpuDecoder(Decoder):
    """Decoder whose Tier-1 and reconstruction run on ``device``
    ('cuda' by default; 'cpu' runs the kernels' plain versions).

    Tier-2 fills flat numpy record tables (no per-codeblock Python
    objects); the planner and packers consume the tables.
    ``raw`` selects the raw-bytes runner (True) or the dense-words one.
    Multi-pass codeblocks (SigProp / MagRef) are decoded on the device
    after their cleanup pass.  A broken codeblock raises ValueError, or
    under ``resilient=True`` decodes to a zero block with warning
    0x00080006 (once per decode); ``zeroed`` then holds how many were
    zeroed (plan, kernel error flags).  Codeblocks of more than 30 bit
    planes decode on the kernels' 64-bit instantiations; a frame with a
    reversible band of kmax >= 31 returns what the JAX package's host
    decoder returns for it: unclamped samples, int64 for unsigned 32-bit
    components, int32 otherwise."""

    def __init__(self, data: bytes, device='cuda', raw: bool = True,
                 **kwargs):
        self.device = resolve_device(device)
        self.raw = raw
        self.zeroed = (0, 0)
        super().__init__(data, **kwargs)

    @torch.inference_mode()
    def decode(self) -> List[np.ndarray]:
        with trace.stage('decode.plan'):
            plan = _build_plan(self)
        return self._decode_fast(plan)

    def _any_wide_band(self) -> bool:
        return any(self._wide_band(st) for st in self.tiles)

    def _wide_band(self, st) -> bool:
        """Whether tile ``st`` has a reversible band of 31 or more bit
        planes, at any resolution (the JAX package's
        TpuDecoder._any_wide_band, tpu/pipeline.py:1224-1235)."""
        for c, comp in enumerate(st.geom.comps):
            rev = self.hdr.get_cod(c).is_reversible
            for res in comp.resolutions:
                for b in range(4):
                    sb = res.bands[b]
                    if sb is not None and not sb.empty \
                            and _wide(sb.kmax, rev):
                        return True
        return False

    _DUMMY = b'\x00\x22'  # minimal well-formed segment for dead lanes

    def _group_arrays(self, plan: _Plan) -> List[dict]:
        """Host prep per group: padded word planes + per-lane dense
        lengths (upper bounds; rows carry the guard fill beyond them)
        + p / qhl, and for a group with refinement passes its SigProp /
        MagRef word planes, their lengths and npasses / h_true /
        causal."""
        out = []
        s0 = 0
        posa, lcupa, scupa, pa, qhla = plan.lanes[:5]
        buf = self.data
        for g in plan.groups:
            sl = slice(s0, s0 + g.n_pad)
            s0 += g.n_pad
            refine = g.rwords[0] > 0
            # a refine group's lanes carry their refinement segment too
            ext = plan.lanes[6] if refine else np.zeros_like(lcupa)
            datas = [bytes(buf[posa[i]:posa[i] + lcupa[i] + ext[i]])
                     if posa[i] >= 0 else self._DUMMY
                     for i in range(sl.start, sl.stop)]
            lcups = lcupa[sl].copy()
            scups = scupa[sl].copy()
            streams = native.prep_cleanup_streams(datas, lcups, scups,
                                                  min_words=g.words)
            wm, wv, ws = g.words
            gd = {
                'mel': streams['mel'], 'vlc': streams['vlc'],
                'ms': streams['ms'],
                'lm': np.minimum(wm, (scups - 1) * 8 // 32 + 3)
                      .astype(np.int32),
                'lv': np.minimum(wv, ((scups - 2) * 8 + 4) // 32 + 3)
                      .astype(np.int32),
                'ls': np.minimum(ws, (lcups - scups) * 8 // 32 + 3)
                      .astype(np.int32),
                'p': pa[sl].astype(np.int32),
                'qhl': qhla[sl].copy(),
            }
            if refine:
                len2s = plan.lanes[6][sl].copy()
                ref = native.prep_refine_streams(datas, lcups, len2s,
                                                 min_words=g.rwords)
                lr = np.minimum(g.rwords[0], len2s * 8 // 32 + 3) \
                    .astype(np.int32)
                gd.update({'spp': ref['spp'], 'mrp': ref['mrp'],
                           'lsp': lr, 'lmr': lr.copy(),
                           'np': plan.lanes[5][sl].astype(np.int32),
                           'ht': plan.lanes[7][sl].astype(np.int32),
                           'causal': plan.lanes[8][sl].astype(np.int32)})
            out.append(gd)
        return out

    def _lane_info(self, plan: _Plan):
        """Per-lane raw segment info in meta order (groups in gid
        order, members then padding), for the native dense prep."""
        pos, lcup, scup, ps, qhl = plan.lanes[:5]
        buf = self.data
        datas = [bytes(buf[pos[i]:pos[i] + lcup[i]])
                 if pos[i] >= 0 else self._DUMMY
                 for i in range(len(pos))]
        return (datas, lcup.copy(), scup.copy(), ps.copy(), qhl.copy())

    def _decode_fast(self, plan: _Plan) -> List[np.ndarray]:
        pairs = [(self, plan)]
        with trace.stage('decode.host_prep'):
            args = _pack(pairs, self.raw)
        with trace.stage('decode.compile'):
            runner = _make_runner(plan, 1, self.device, self.raw)
        with trace.stage('decode.device'):
            with trace.stage('decode.upload'):
                dargs = upload(args, self.device)
            errs, outs = runner(*dargs)
            nerr = int(errs.sum())
            _zeroed_blocks(plan.broken, nerr, self.resilient)
            host = [[p.cpu().numpy() for p in t] for t in outs]
        self.zeroed = (plan.broken, nerr)
        with trace.stage('decode.assemble'):
            return _assemble_burst([self], host)[0]


def _pack(pairs, raw: bool, out: _HostBuffer = None) -> tuple:
    """The host buffers of a burst of (decoder, plan) pairs in the
    runner mode ``raw`` selects; the raw layout is written into ``out``
    where one is given (see _pack_device)."""
    return _pack_device(pairs, out) if raw else _pack_dense(pairs)


def _zeroed_blocks(broken: int, nerr: int, resilient: bool) -> None:
    """A strict decode whose kernels flagged ``nerr`` lanes raises; a
    resilient one with zeroed blocks (``broken`` by the planner, ``nerr``
    by the kernels' flags) warns once."""
    if nerr and not resilient:
        raise ValueError('U_q exceeds missing_msbs + 2')
    if broken or nerr:
        # the runner zeroed the flagged lanes (_Runner.mask), as the
        # reference zeroes a broken codeblock (ojph_codeblock.cpp:214-225)
        _wrn(0x00080006, 'broken codeblock(s) zeroed (resilient)')


def _assemble_burst(decs, outs) -> List[List[np.ndarray]]:
    """Per frame of a burst, its decoder's full planes from ``outs``
    (per tile, per component, a host array [frames, h, w])."""
    return [d._assemble({st.geom.idx: [c[fi] for c in outs[ti]]
                         for ti, st in enumerate(d.tiles)})
            for fi, d in enumerate(decs)]


def decode_gpu(data: bytes, device='cuda', skip_res: int = 0,
               resilient: bool = False,
               raw: bool = True) -> List[np.ndarray]:
    """Decode a .j2c codestream on ``device``; returns per-component
    int32 planes (numpy).  Codeblocks with SigProp / MagRef passes are
    refined on the device after their cleanup pass.  ``resilient``
    decodes damaged streams as the reference does (broken codeblocks
    zeroed, a truncated stream full-size); ``raw`` picks the runner's
    input layout."""
    return GpuDecoder(data, device=device, raw=raw, resilient=resilient,
                      skipped_res_for_read=skip_res,
                      skipped_res_for_recon=skip_res).decode()


# ---------------------------------------------------------------------------
# Bursts and video
# ---------------------------------------------------------------------------

_F_BUCKETS = (8, 4, 2, 1)
# burst runners by (plan key, frames, runner mode, device)
_RUNNERS = Cache(32)
# their rest of graph's CUDA graphs by rest_key
_REST_GRAPHS = _RestGraphs(64)


def _burst_runner(plan: _Plan, nframes: int, device, raw: bool,
                  stage: str = 'decode.compile') -> _Runner:
    """The cached runner of ``nframes`` frames of ``plan``'s key, its
    rest of graph replayed from the shared CUDA graphs; a miss makes it
    under the trace stage ``stage``."""
    def make():
        with trace.stage(stage):
            return _make_runner(plan, nframes, device, raw, graphs=True)

    return _RUNNERS.get((plan.key, nframes, raw, device), make)


def _geometry_key(key: tuple) -> tuple:
    """A plan key without its groups' word buckets and sample widths,
    which depend on the frame's coded bytes."""
    return (tuple(g[:4] for g in key[0]),) + key[1:]


def _merge_words(plans: List[_Plan]) -> List[_Plan]:
    """The plans of frames of one geometry under one key: every group
    at the largest word buckets of any frame (a bucket bounds what a
    lane's reader may read, and the stream rows are filled past each
    lane's bytes as past the bucket, so a frame decodes the same under
    a larger one), and in 64 bits where any frame's is (its lanes' p
    move up by 32, and _Runner.mask takes the 32-bit patterns back)."""
    if len({p.key for p in plans}) == 1:
        return plans
    ng = len(plans[0].groups)
    words = [tuple(max(p.groups[i].words[k] for p in plans)
                   for k in range(3)) for i in range(ng)]
    rwords = [tuple(max(p.groups[i].rwords[k] for p in plans)
                    for k in range(2)) for i in range(ng)]
    bits = [max(p.groups[i].bits for p in plans) for i in range(ng)]
    groups = [replace(g, words=w, rwords=rw, bits=b) for g, w, rw, b in
              zip(plans[0].groups, words, rwords, bits)]
    key = (tuple(_key_group(g) for g in groups),) + plans[0].key[1:]
    return [replace(p, key=key,
                    groups=[replace(g, words=w, rwords=rw, bits=b)
                            for g, w, rw, b in
                            zip(p.groups, words, rwords, bits)],
                    lanes=_widen_lanes(p, bits),
                    has_refine=any(rw[0] > 0 for rw in rwords))
            for p in plans]


def _widen_lanes(plan: _Plan, bits) -> tuple:
    """``plan.lanes`` with p = 62 - missing_msbs on the lanes of every
    group that ``bits`` widens to 64."""
    p = plan.lanes[3].copy()
    at = 0
    for g, b in zip(plan.groups, bits):
        if b > g.bits:
            p[at:at + g.n_pad] += 32
        at += g.n_pad
    return plan.lanes[:3] + (p,) + plan.lanes[4:]


def _decoders(streams, device, raw: bool, resilient: bool,
              skip_res: int) -> List[GpuDecoder]:
    return [GpuDecoder(s, device=device, raw=raw, resilient=resilient,
                       skipped_res_for_read=skip_res,
                       skipped_res_for_recon=skip_res) for s in streams]


def _burst_plans(decs) -> List[_Plan]:
    """The plans of a burst that one runner takes, or None when the
    burst decodes frame by frame (its size is not in _F_BUCKETS, or its
    frames differ in geometry)."""
    if len(decs) not in _F_BUCKETS:
        return None
    plans = [_build_plan(d) for d in decs]
    if len({_geometry_key(p.key) for p in plans}) != 1:
        return None
    return _merge_words(plans)


class VideoDecoder:
    """Pipelined burst decoder for sequences of frames of one geometry,
    on ``device`` ('cuda' by default; 'cpu' runs the kernels' plain
    versions).

    ``submit`` hands a burst to two single-thread workers and returns:
    the prep worker parses, plans and packs it on the host, uploads it
    from pinned memory on a side stream and enqueues one runner on the
    decoder's CUDA stream; the fetch worker copies the frames into host
    memory.  With two or more bursts in flight, burst k+1's host prep,
    burst k's device work and burst k-1's fetch overlap.  (The JAX
    package dispatches on a third worker, because its dispatch may block
    until the upload lands; here neither the upload nor the enqueue
    blocks, and the eager dispatch would hold the interpreter lock
    against the prep worker.)  ``collect`` returns the oldest burst's
    frames (per frame, its component planes, as ``decode_gpu``).

    A burst whose frames differ in geometry, or whose size is not one of
    ``_F_BUCKETS``, decodes frame by frame through ``GpuDecoder.decode``
    on the same device.  Frames of one geometry whose word buckets
    differ share one runner at the largest buckets.  ``fused_bursts``
    and ``fallback_bursts`` count the two kinds.

    ``to_device=True`` keeps the frames on the device:
    ``collect_on_device`` returns ``outs[tile][comp]``, a tensor
    [F, H, W] of the narrow dtype, ready on the caller's current stream.
    Its Tier-1 error flags stay on the device until ``drain_errors``, or
    until more than 16 are pending.  A broken codeblock raises
    ValueError (at ``collect``, or there), or under ``resilient=True``
    decodes to a zero block with warning 0x00080006, once a burst;
    ``zeroed`` holds the last collected burst's count (plan, kernel
    flags).  ``stage_uploads=False`` uploads from pageable memory on the
    decoder's stream instead of through pinned staging buffers on a
    side stream.  Errors inside a worker surface at ``collect`` /
    ``collect_on_device``.

    With tracing enabled each burst is a ``decode.burst`` span from its
    submit to its collect, and its stages count under it: the prep
    worker's queue wait, host prep (its Tier-2, plan and pack; inside the
    pack, a growth of the raw packs' host buffer, which the prep worker
    reuses burst after burst), dispatch (upload, Tier-1 and the
    rest of graph: its eager launches, its capture or its replay), the
    caller's collect wait and error checks (PERF.md section 3)."""

    def __init__(self, skip_res: int = 0, to_device: bool = False,
                 stage_uploads: bool = True, resilient: bool = False,
                 device='cuda', raw: bool = True):
        self.device = resolve_device(device)
        self.skip_res = skip_res
        self.to_device = to_device
        self.stage_uploads = stage_uploads
        self.resilient = resilient
        self.raw = raw
        self.fused_bursts = 0
        self.fallback_bursts = 0
        self.zeroed = (0, 0)
        self._inflight = []
        self._pending_errs = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == 'cuda' else None)
        self._stager = Stager(self.device)
        # the one prep worker packs each raw burst into the same host
        # buffer where the upload has copied its bytes out by the time
        # _dispatch returns: a staged upload (pinned copy; a copy on the
        # CPU) or a pageable one to a CUDA device (synchronous).  A
        # pageable upload on the CPU aliases it, so that takes a fresh one.
        self._pack_out = (_HostBuffer() if stage_uploads
                          or self.device.type == 'cuda' else None)
        self._prep_pool = ThreadPoolExecutor(max_workers=1)
        self._fetch_pool = ThreadPoolExecutor(max_workers=1)

    def submit(self, streams: List[bytes]) -> None:
        """Enqueue a burst; parse and plan errors surface at its
        collect."""
        burst = trace.open_burst('decode.burst')
        self._inflight.append((self._prep_pool.submit(
            self._prep, list(streams), burst), burst))

    @torch.inference_mode()
    def _prep(self, streams, burst=None):
        trace.since(burst, 'decode.queue_wait')
        with trace.burst(burst):
            with trace.stage('decode.host_prep'):
                with trace.stage('decode.host_prep.t2'):
                    decs = _decoders(streams, self.device, self.raw,
                                     self.resilient, self.skip_res)
                with trace.stage('decode.host_prep.plan'):
                    plans = _burst_plans(decs)
                if plans is not None:
                    with trace.stage('decode.host_prep.pack'):
                        # int32 views of the buffers, as upload() makes
                        # them
                        args = tuple(np.ascontiguousarray(a).view(np.int32)
                                     for a in _pack(list(zip(decs, plans)),
                                                    self.raw, self._pack_out))
            if plans is None:
                self.fallback_bursts += 1
                return decs, None, [d.decode() for d in decs]
            self.fused_bursts += 1
            runner = _burst_runner(plans[0], len(decs), self.device,
                                   self.raw)
            with trace.stage('decode.dispatch'):
                run = self._dispatch(runner, args)
        broken = sum(p.broken for p in plans)
        if self.to_device:
            return decs, broken, run
        return decs, broken, self._fetch_pool.submit(self._fetch, run, burst)

    def _dispatch(self, runner: _Runner, args):
        """Upload and enqueue the runner on the decoder's stream: (the
        count of flagged lanes, the outputs, the event after them; all on
        the device, and not waited for)."""
        with torch.cuda.stream(self._stream):
            with trace.stage('decode.dispatch.upload'):
                if self.stage_uploads:
                    dargs = self._stager.upload(
                        (runner.plan.key, runner.F), args, self._stream)
                else:
                    dargs = upload(args, self.device)
            errs, outs = runner(*dargs)
            nerr = errs.sum()
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        return nerr, outs, done

    @torch.inference_mode()
    def _fetch(self, run, burst=None):
        """(flagged lanes, per tile and component the [F, h, w] host
        array) of a dispatched burst."""
        nerr, outs, done = run
        with trace.burst(burst):
            host = self._stager.fetch([nerr] + [c for t in outs for c in t],
                                      after=done)
        at = 1
        planes = []
        for t in outs:
            planes.append(host[at:at + len(t)])
            at += len(t)
        return int(host[0]), planes

    def collect(self) -> List[List[np.ndarray]]:
        """Block for and return the oldest burst's frames."""
        fut, burst = self._inflight.pop(0)
        with trace.burst(burst):
            with trace.stage('decode.collect_wait'):
                decs, broken, fut = fut.result()
            if broken is None:  # decoded frame by frame
                self.zeroed = tuple(sum(z) for z in zip(*(d.zeroed
                                                          for d in decs)))
                trace.close_burst(burst)
                return fut
            with trace.stage('decode.fetch'):
                nerr, outs = (self._fetch(fut) if self.to_device
                              else fut.result())
            self.zeroed = (broken, nerr)
            _zeroed_blocks(broken, nerr, self.resilient)
            with trace.stage('decode.assemble'):
                frames = _assemble_burst(decs, outs)
        trace.close_burst(burst)
        return frames

    def collect_on_device(self):
        """The oldest burst's frames left on the device (needs
        ``to_device=True``): ``outs[tile][comp]`` is a tensor [F, H, W]
        of the narrow dtype, ordered after the burst on the caller's
        current stream.  Its error flags are checked later (see
        :meth:`drain_errors`); a corrupt burst's broken codeblocks are
        zero blocks here."""
        if not self.to_device:
            raise ValueError('collect_on_device needs to_device=True')
        fut, burst = self._inflight.pop(0)
        with trace.burst(burst):
            with trace.stage('decode.collect_wait'):
                decs, broken, run = fut.result()
            if broken is None:
                raise ValueError('burst was decoded frame by frame (mixed '
                                 'geometry or burst size); use collect() '
                                 'for this burst')
            nerr, outs, done = run
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in outs:
                    for c in t:
                        c.record_stream(cur)
            self._pending_errs.append((nerr, broken, done))
            # flags kept on the device cost no fetch here; the oldest is
            # checked once more than 16 wait, so a caller that never
            # drains still learns of a corrupt burst
            while len(self._pending_errs) > 16:
                self._check(self._pending_errs.pop(0))
        trace.close_burst(burst)
        return outs

    def _check(self, pending) -> None:
        nerr, broken, done = pending
        with trace.stage('decode.error_check'):
            if done is not None:
                done.synchronize()
            self.zeroed = (broken, int(nerr))
        _zeroed_blocks(broken, self.zeroed[1], self.resilient)

    def drain_errors(self) -> None:
        """Check every pending error flag; raises if a collected burst
        was corrupt (strict mode)."""
        while self._pending_errs:
            self._check(self._pending_errs.pop(0))

    @property
    def depth(self) -> int:
        return len(self._inflight)

    def close(self) -> None:
        """Stop the workers once the submitted bursts are done."""
        for pool in (self._prep_pool, self._fetch_pool):
            pool.shutdown(wait=True)


@torch.inference_mode()
def decode_gpu_batch(streams: List[bytes], device='cuda',
                     skip_res: int = 0, resilient: bool = False,
                     raw: bool = True) -> List[List[np.ndarray]]:
    """Decode many codestreams on ``device``, frames of one geometry
    batched into bursts of _F_BUCKETS sizes, each one runner call;
    returns per stream its component planes, as ``decode_gpu``."""
    dev = resolve_device(device)
    decs = _decoders(streams, dev, raw, resilient, skip_res)
    results: List[list] = [None] * len(decs)
    by_geom: Dict[tuple, list] = {}
    for i, d in enumerate(decs):
        with trace.stage('decode.plan'):
            plan = _build_plan(d)
        by_geom.setdefault(_geometry_key(plan.key), []).append((i, d, plan))
    for items in by_geom.values():
        pos = 0
        while pos < len(items):
            F = next(f for f in _F_BUCKETS if f <= len(items) - pos)
            chunk = items[pos:pos + F]
            pos += F
            cdecs = [d for _, d, _ in chunk]
            plans = _merge_words([p for _, _, p in chunk])
            with trace.stage('decode.host_prep'):
                args = _pack(list(zip(cdecs, plans)), raw)
            runner = _burst_runner(plans[0], F, dev, raw)
            with trace.stage('decode.device'):
                with trace.stage('decode.upload'):
                    dargs = upload(args, dev)
                errs, outs = runner(*dargs)
                _zeroed_blocks(sum(p.broken for p in plans),
                               int(errs.sum()), resilient)
                host = [[c.cpu().numpy() for c in t] for t in outs]
            with trace.stage('decode.assemble'):
                frames = _assemble_burst(cdecs, host)
            for (i, _, _), f in zip(chunk, frames):
                results[i] = f
    return results
