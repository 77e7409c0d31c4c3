"""Fused frame encode on one GPU: sample conversion -> colour transform
-> forward DWT pyramid -> quantization -> the HT cleanup encoder (K3)
and, for multi-pass codeblocks, the refinement-pass encoder (K5), with
byte stuffing and Tier-2 packetization on the host.

Mirror image of the decode plan (pipeline.py) and a port of the JAX
package's tpu/encode_pipeline.py: band planes are carved into
rectangular strips of same-shape codeblocks, batched by block width
with height padding (each lane's quad-row limit ``qhl`` stops its
emission at its own rows), and one kernel launch encodes a lane group.
The kernel emits dense MEL / VLC / MagSgn words per lane; the runner
gathers the used prefix of every lane's streams into one buffer on the
device, the host copies it once and the native stuffer
(pack_from_dense) turns it into cleanup segments
(ojph_block_encoder.cpp:273-533; the OpenJPH encoder emits only the
cleanup pass).  A burst of same-geometry frames is batched along the
lanes: frame f of group g occupies lanes [f*n_pad, (f+1)*n_pad).

Multi-pass (``ht_passes`` 2 or 3, ROADMAP 12) codes each eligible
codeblock as the JAX package's scalar Encoder does (codec.py:826-857):
a band that is not wide and has kmax >= 2 is multi-pass; its non-zero
codeblocks get a cleanup segment one plane coarser (missing_msbs = kmax
- 2, K3 at p = 32 - kmax) and a SigProp [+ MagRef] segment coding the
last plane (K5), kept only where that segment holds 1 to 2,046 bytes;
any other is coded cleanup-only at kmax - 1 (K3 again, at p = 31 -
kmax).  A group with multi-pass lanes runs K3, K5 and K3 on the same
batch; the choice per lane is made on the host from the one aux fetch,
and the compaction gathers the kept lanes' cleanup words of the first
K3 run and K5's bytes, the others' words of the second run.

A reversible band of kmax >= 31 (ROADMAP 7c) is coded as the JAX
package's scalar Encoder codes it (codec.py:742-857): samples of more
than 28 bits converted in int64, the RCT and the forward 5/3 of such a
frame in int64, and the band's codeblocks in lane groups of their own,
quantized to uint64 patterns (p = 63 - kmax) for the HT cleanup
encoder's 64-bit instantiation.  The coded words are uint32 at either
width, so stuffing and Tier-2 do not change.
"""
from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .. import native
from ..codec import Encoder, build_encoder, normalize_planes
from ..core.geometry import build_tile, build_tile_grid
from ..core.markers import Dfs
from ..core.t2 import CodedBlock, encode_precinct, precinct_iterator
from ..utils import trace
from ..utils.cache import Cache
from . import block_encode_cuda
from . import color as clr
from . import dwt
from .block_encode_cuda import encode_cleanup
from .block_refine_encode import cap_words
from .block_refine_encode_cuda import encode_refine
from .pipeline import _res_band_list, _wide, resolve_device
from .quant import tx_to_cb
from .staging import Stager

# the reference's limit on a refinement segment (ojph_precinct.cpp:
# 496-514): a multi-pass codeblock keeps its passes only below it
_MAX_SEG2 = 2047


def _ebucket(n: int) -> int:
    """Word-cap bucket (pow2 then 128-multiples) for the encoder's output
    rows; every cap is a multiple of _CHUNK."""
    b = 32
    while b < n and b < 1024:
        b *= 2
    if n <= b:
        return b
    return -(-n // 128) * 128


_CHUNK = 32  # words


def _compact_chunks(cats, chunk_idx):
    """The used prefix of every (lane, stream) word row, gathered into one
    dense buffer at _CHUNK-word granularity: every stream starts on a
    chunk boundary of its group's rows, and the host computes the source
    chunk of each output chunk, so the gather is one index_select."""
    src = torch.cat([c.reshape(-1) for c in cats]).reshape(-1, _CHUNK)
    return src.index_select(0, chunk_idx).reshape(-1)


@dataclass
class _EncGroup:
    gid: int
    w: int
    h: int = 0
    # strips: (lane0, nrows, ncols, h_true, band_id, y0, x0)
    strips: list = field(default_factory=list)
    # per lane: (band_id, block_index_in_band, h_true)
    lanes: list = field(default_factory=list)
    p: list = field(default_factory=list)        # 31 - kmax per lane
    thresh: list = field(default_factory=list)   # zero-block threshold
    n_pad: int = 0                               # lanes, padded to 8
    caps: tuple = (0, 0, 0)                      # dense word caps
    # 64: a wide band's group (uint64 samples, p = 63 - kmax)
    bits: int = 32
    # multi-pass: per lane whether its band is coded in several passes
    # (K3's first run then takes p + 1 = 32 - kmax there); rcap: K5's
    # words a lane (0: no multi-pass lane in the group)
    multi: list = field(default_factory=list)
    rcap: int = 0


@dataclass
class _EncPlan:
    key: tuple
    groups: List[_EncGroup]
    # band_id -> (comp, res, band, kmax, delta, reversible, H, W)
    bands: List[tuple]
    # per comp: (reversible, bd, sgn, nlt3, res specs, wavelet kernel);
    # a res spec is (band ids, h_even, v_even, DFS level type)
    comps: List[tuple]
    mct: bool
    # multi-pass: the passes of an eligible codeblock, the stripe-causal
    # mode
    passes: int = 1
    causal: bool = False


class _EncRunner:
    """The fused encode of ``nframes`` same-geometry frames on
    ``device``.  ``graph(*planes)`` takes per component a [nframes, h,
    w] tensor of the narrow upload dtype and returns per lane group its
    sample batch (int32 [nframes*n_pad, hp, wp], int64 for a wide band's
    group) and zero-block flags;
    ``tier1(batches)`` runs the HT cleanup encoder per group (K3; on a
    group with multi-pass lanes K3, K5 and K3 again) and returns (cats,
    aux): per group its word rows [nframes*n_pad, wm+wv+ws] (a
    multi-pass group's: the first K3 run's, the second's and K5's
    [nframes*n_pad, rcap]), and one int32 buffer of, per group, its bit
    counts (a multi-pass group's: both runs' and K5's byte counts), then
    every group's non-zero flags [nframes, lanes], then the overflow
    flags.  Calling the runner does both."""

    def __init__(self, plan: _EncPlan, nframes: int, device):
        self.plan = plan
        self.F = nframes
        self.device = torch.device(device)
        self.lane_p, self.lane_qhl, self.thresh = [], [], []
        # per group None, or K5's lanes: (K3's p of the first run, true
        # heights, passes)
        self.lane_refine = []

        def lanes(g, vals, mode='constant'):
            pad = g.n_pad - len(g.lanes)
            v = np.pad(np.array(vals, np.int32), (0, pad), mode=mode)
            return torch.from_numpy(np.tile(v, nframes)).to(self.device)

        for g in plan.groups:
            self.lane_p.append(lanes(g, g.p, 'edge'))
            self.lane_qhl.append(lanes(g, [(h_t + 1) // 2
                                           for (_, _, h_t) in g.lanes]))
            self.thresh.append(torch.tensor(g.thresh, dtype=torch.int64,
                                            device=self.device))
            self.lane_refine.append(None if not g.rcap else (
                lanes(g, [p + m for p, m in zip(g.p, g.multi)], 'edge'),
                lanes(g, [h_t for (_, _, h_t) in g.lanes]),
                lanes(g, [plan.passes if m else 0 for m in g.multi])))

    def __call__(self, *planes):
        return self.tier1(self.graph(*planes))

    def graph(self, *planes):
        plan, F = self.plan, self.F
        conv = []
        for ci, (rev, bd, sgn, nlt3, _, _) in enumerate(plan.comps):
            if rev:
                conv.append(clr.rev_convert_in(
                    planes[ci], bd, sgn, nlt3,
                    torch.int64 if bd > 28 else torch.int32))
            else:
                conv.append(clr.irv_convert_to_float(
                    planes[ci].to(torch.int32), bd, sgn, nlt3))
        if plan.mct:
            if plan.comps[0][0]:
                if any(bd > 28 for (_, bd, _, _, _, _) in plan.comps[:3]):
                    # the RCT of a frame above 28 bits runs in int64
                    # (codec.py:748-756)
                    conv[:3] = [c.to(torch.int64) for c in conv[:3]]
                fwd = clr.rct_forward
            else:
                fwd = clr.ict_forward
            conv[0], conv[1], conv[2] = fwd(conv[0], conv[1], conv[2])

        # DWT pyramids -> per-band sign-magnitude planes and magnitudes
        smag = [None] * len(plan.bands)
        mags = [None] * len(plan.bands)
        for ci, (rev, _, _, _, res_specs, kern) in enumerate(plan.comps):
            cur = conv[ci]
            band_planes = {}
            for r in range(len(res_specs) - 1, 0, -1):
                # Part-2 DFS: a level splits both ways, one way, or not
                # at all (the JAX package's Encoder._encode_comp)
                bids, h_even, v_even, dt = res_specs[r]
                if dt == Dfs.BIDIR_DWT:
                    ll, hl, lh, hh = dwt.fwd_dwt2d(cur, h_even, v_even,
                                                   rev, kern)
                    band_planes[bids[0]] = hl
                    band_planes[bids[1]] = lh
                    band_planes[bids[2]] = hh
                    cur = ll
                elif dt == Dfs.HORZ_DWT:
                    cur, band_planes[bids[0]] = dwt.fwd_atk_1d(
                        cur, h_even, cur.ndim - 1, kern)
                elif dt == Dfs.VERT_DWT:
                    cur, band_planes[bids[0]] = dwt.fwd_atk_1d(
                        cur, v_even, cur.ndim - 2, kern)
            band_planes[res_specs[0][0][0]] = cur
            for bid, bp in band_planes.items():
                (_, _, _, kmax, delta, rev_b, _, _) = plan.bands[bid]
                smag[bid], mags[bid] = tx_to_cb(bp, kmax, delta, rev_b)

        # strips -> group batches, and the zero-block flags
        out = []
        for g, thresh in zip(plan.groups, self.thresh):
            wp = ((g.w + 3) // 4) * 4
            hp = ((g.h + 1) // 2) * 2
            buf = torch.zeros((F, g.n_pad, hp, wp), dtype=torch.int64
                              if g.bits == 64 else torch.int32,
                              device=self.device)
            mx = torch.zeros((F, len(g.lanes)), dtype=torch.int64,
                             device=self.device)
            for (lane0, nrows, ncols, h_t, bid, y0, x0) in g.strips:
                nl = nrows * ncols
                sl = (slice(None), slice(y0, y0 + nrows * h_t),
                      slice(x0, x0 + ncols * g.w))

                def blocks(a):
                    return a[sl].reshape(F, nrows, h_t, ncols, g.w) \
                        .permute(0, 1, 3, 2, 4).reshape(F, nl, h_t, g.w)

                buf[:, lane0:lane0 + nl, :h_t, :g.w] = blocks(smag[bid])
                m = mags[bid]
                if g.bits == 64:
                    # a magnitude is a multiple of the threshold, so it
                    # reaches it when it is not 0 (a uint64 one may read
                    # as negative in int64)
                    m = (m != 0).to(torch.int64) << (63 - plan.bands[bid][3])
                mx[:, lane0:lane0 + nl] = blocks(m).amax((2, 3))
            # the OR of a block's magnitudes reaches the power-of-two
            # threshold exactly when their maximum does
            out.append((buf.reshape(F * g.n_pad, hp, wp), mx >= thresh))
        return out

    def tier1(self, batches):
        cats, bits, nzs, ovfs = [], [], [], []
        for g, (buf, nz), p, qhl, ref in zip(
                self.plan.groups, batches, self.lane_p, self.lane_qhl,
                self.lane_refine):
            if ref is None:
                runs = [encode_cleanup(buf, p, g.w, g.h, g.caps, qhl)]
            else:
                # the multi-pass lanes' cleanup one plane coarser, their
                # refinement passes, then every lane's cleanup-only choice
                pm, h_lim, npasses = ref
                first = encode_cleanup(buf, pm, g.w, g.h, g.caps, qhl)
                seg = encode_refine(buf, pm, h_lim, npasses,
                                    self.plan.causal, g.w, g.h, g.rcap)
                runs = [first, encode_cleanup(buf, p, g.w, g.h, g.caps,
                                              qhl), seg]
            for cat, b, ovf in runs:
                cats.append(cat)
                bits.append(b.reshape(-1))
                ovfs.append(ovf.to(torch.int32))
            nzs.append(nz.reshape(-1).to(torch.int32))
        # one small aux buffer -> one host fetch
        return tuple(cats), torch.cat(bits + nzs + ovfs)


def _make_enc_runner(plan: _EncPlan, nframes: int = 1,
                     device='cuda') -> _EncRunner:
    """The fused encode of ``nframes`` frames of ``plan``'s geometry on
    ``device``.  On a CUDA device the kernel is built here on first use,
    not at its first launch."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        block_encode_cuda.load()
    return _EncRunner(plan, nframes, dev)


def _fetch_outs(plan: _EncPlan, cats, aux, nframes: int):
    """Device outputs -> host: the aux buffer first, then the used word
    prefix of every lane's streams, compacted on the device and copied
    in one transfer.  On a multi-pass group a lane keeps its passes
    where its refinement segment holds 1 to _MAX_SEG2 - 1 bytes: its
    cleanup words then come from the group's first K3 run and its
    segment from K5, else its words from the second run.  Raises
    RuntimeError on any overflow (the caps are worst-case bounds, so an
    overflow is a fault, not a fallback).  Returns (dense uint32 words,
    per group the pack_from_dense meta [nframes*n_pad, 6], its non-zero
    flags [nframes, lanes], and None or, for a multi-pass group, the
    lanes' (kept flags, segment word offsets into ``dense``, SigProp and
    MagRef byte counts [nframes*n_pad, 2]))."""
    F = nframes
    aux = aux.cpu().numpy()  # waits for the runner
    pos = 0

    def take(n, cols):
        nonlocal pos
        pos += n * cols
        return aux[pos - n * cols:pos].reshape(n, cols).astype(np.int64)

    counts = []  # per group (bits of the first run, None | (bits, lens))
    for g in plan.groups:
        nl = F * g.n_pad
        first = take(nl, 3)
        counts.append((first, (take(nl, 3), take(nl, 2)) if g.rcap
                       else None))
    nz_all = []
    for g in plan.groups:
        nz_all.append(take(F, len(g.lanes)) != 0)
    if aux[pos:].any():
        raise RuntimeError('HT encoder: a lane overflowed its word caps')
    # per lane its segments' first words in the concatenated cats and
    # their word counts: the cleanup's three streams, then on a
    # multi-pass group the refinement segment
    sb_l, cnt_l, chosen, keeps = [], [], [], []
    base = 0
    for g, (bits, more) in zip(plan.groups, counts):
        nl = F * g.n_pad
        wm, wv, _ = g.caps
        wtot = sum(g.caps)
        lanes = np.arange(nl, dtype=np.int64)[:, None]
        # stream si of lane l of a run at rbase sits at flat
        # [rbase + l*wtot + off[si], ...)
        off = np.array([0, wm, wm + wv], np.int64)
        segs = base + lanes * wtot + off[None, :]
        base += nl * wtot
        keep = None
        if more is not None:
            bits2, lens = more
            multi = np.tile(np.pad(np.array(g.multi, bool),
                                   (0, g.n_pad - len(g.lanes))), F)
            seg = lens.sum(1)
            keep = multi & (seg > 0) & (seg < _MAX_SEG2)
            # the cleanup-only choice: the second run's words
            second = (multi & ~keep)[:, None]
            segs = np.where(second, segs + nl * wtot, segs)
            bits = np.where(second, bits2, bits)
            base += nl * wtot
            segs = np.concatenate([segs, base + lanes * g.rcap], 1)
            base += nl * g.rcap
            cnt = np.concatenate([(bits + 31) // 32,
                                  np.where(keep, (seg + 3) // 4, 0)[:, None]],
                                 1)
            keeps.append((keep, lens))
        else:
            cnt = (bits + 31) // 32
            keeps.append(None)
        sb_l.append(segs.reshape(-1))
        cnt_l.append(cnt.reshape(-1))
        chosen.append(bits)
    cnts = np.concatenate(cnt_l)
    seg_base = np.concatenate(sb_l)
    # chunk-aligned layout: each segment starts on a chunk boundary
    cnt_ch = (cnts + _CHUNK - 1) // _CHUNK
    ch_ends = np.cumsum(cnt_ch)
    ch_off = np.concatenate([[0], ch_ends[:-1]]).astype(np.int64)
    total_ch = int(ch_ends[-1]) if len(ch_ends) else 0
    chunk_idx = (np.repeat((seg_base // _CHUNK) - ch_off, cnt_ch)
                 + np.arange(total_ch))
    dense = _compact_chunks(cats, torch.from_numpy(chunk_idx)
                            .to(cats[0].device)).cpu().numpy() \
        .view(np.uint32)
    if dense.size == 0:
        dense = np.zeros(1, np.uint32)
    seg_off = ch_off * _CHUNK
    metas, refs = [], []
    at = 0
    for g, bits, kept in zip(plan.groups, chosen, keeps):
        nl = F * g.n_pad
        k = 3 if kept is None else 4
        offs = seg_off[at:at + nl * k].reshape(nl, k)
        at += nl * k
        meta = np.empty((nl, 6), np.int64)
        meta[:, 0::2] = offs[:, :3]
        meta[:, 1::2] = bits
        metas.append(meta)
        refs.append(None if kept is None
                    else (kept[0], offs[:, 3], kept[1]))
    return dense, metas, nz_all, refs


class GpuEncoder(Encoder):
    """Encoder whose sample conversion, colour transform, DWT,
    quantization and HT block encoders run on ``device`` ('cuda' by
    default; 'cpu' runs the kernels' plain versions).  Byte stuffing and
    Tier-2 run on the host.  Part-2 decomposition structures
    (``dfs_list=``) and wavelet kernels (``atks=``) are taken as the JAX
    package's Encoder takes them.  Bands of 31 or more bit planes are
    coded by the HT cleanup encoder's 64-bit instantiation.  With
    ``ht_passes`` 2 or 3 the eligible codeblocks carry SigProp [and
    MagRef] passes coded by the refinement-pass encoder (K5), as the JAX
    package's Encoder codes them (see the module docstring)."""

    def __init__(self, *args, device='cuda', **kwargs):
        self.device = resolve_device(device)
        super().__init__(*args, **kwargs)

    def _build_enc_plan(self, geom) -> _EncPlan:
        groups: Dict[int, _EncGroup] = {}
        bands: List[tuple] = []
        comps = []
        nc = self.siz.num_comps
        for c in range(nc):
            cod = self._get_cod(c)
            rev = cod.is_reversible
            comp = geom.comps[c]
            res_specs = []
            for r in range(comp.num_decomps + 1):
                res = comp.resolutions[r]
                bids = []
                for b in _res_band_list(res, r):
                    sb = res.bands[b]
                    # a wide band's samples are uint64 (codec.py:828-829)
                    wide = _wide(sb.kmax, rev)
                    top = 63 if wide else 31
                    # SigProp / MagRef on this band (codec.py:831)
                    multi = self.ht_passes > 1 and not wide and sb.kmax >= 2
                    bid = len(bands)
                    bands.append((c, r, b, sb.kmax, float(sb.delta),
                                  rev, sb.rect.h, sb.rect.w))
                    bids.append(bid)
                    run = None  # (lane0, ncols, h_true, y0, x0, gid)
                    for bi, g in enumerate(sb.blocks):
                        # lanes group by block width and sample width:
                        # shorter blocks pad with zero rows and stop at
                        # qhl
                        grp = groups.get((g.rect.w, wide))
                        if grp is None:
                            grp = _EncGroup(len(groups), g.rect.w,
                                            bits=64 if wide else 32)
                            groups[(g.rect.w, wide)] = grp
                        lane = len(grp.lanes)
                        grp.lanes.append((bid, bi, g.rect.h))
                        grp.h = max(grp.h, g.rect.h)
                        grp.p.append(top - sb.kmax)
                        grp.multi.append(multi)
                        grp.thresh.append(1 << (top - sb.kmax))
                        y0 = g.rect.y0 - sb.rect.y0
                        x0 = g.rect.x0 - sb.rect.x0
                        if run is not None \
                                and run[5] == grp.gid \
                                and run[2] == g.rect.h and run[3] == y0 \
                                and run[4] + run[1] * g.rect.w == x0 \
                                and lane == run[0] + run[1]:
                            run = (run[0], run[1] + 1, run[2], run[3],
                                   run[4], run[5])
                        else:
                            if run is not None:
                                _group_of(groups, run[5]).strips.append(
                                    (run[0], 1, run[1], run[2], bid,
                                     run[3], run[4]))
                            run = (lane, 1, g.rect.h, y0, x0, grp.gid)
                    if run is not None:
                        _group_of(groups, run[5]).strips.append(
                            (run[0], 1, run[1], run[2], bid, run[3],
                             run[4]))
                # each level's lifting parity comes from its own origin
                res_specs.append((tuple(bids),
                                  (res.rect.x0 & 1) == 0,
                                  (res.rect.y0 & 1) == 0,
                                  int(res.dwt_type)))
            comps.append((rev, self.siz.comps[c].bit_depth,
                          self.siz.comps[c].is_signed,
                          self.hdr.nlt.type3_for(c), tuple(res_specs),
                          cod.kernel))
        glist = sorted(groups.values(), key=lambda g: g.gid)
        # vertical strip merge
        for g in glist:
            merged = []
            for (lane0, nrows, ncols, h_t, bid, y0, x0) in g.strips:
                if merged:
                    m = merged[-1]
                    if m[4] == bid and m[2] == ncols and m[3] == h_t \
                            and m[6] == x0 and m[5] + m[1] * h_t == y0 \
                            and m[0] + m[1] * m[2] == lane0:
                        merged[-1] = (m[0], m[1] + 1, m[2], m[3], m[4],
                                      m[5], m[6])
                        continue
                merged.append((lane0, nrows, ncols, h_t, bid, y0, x0))
            g.strips = merged
        mct = self.cod.mc_trans == 1 and nc >= 3
        for g in glist:
            # worst-case dense output words per lane: overflow cannot
            # happen, and the flag is checked all the same (a pair's VLC
            # bits: at most 30, 38 with the 64-bit u_q extensions)
            qw = (g.w + 1) >> 1
            qh = (g.h + 1) >> 1
            pairs = (qw + 1) >> 1
            kx = g.bits - 1 - min(g.p)
            vlc = 42 if g.bits == 64 else 34
            g.caps = (_ebucket(qh * pairs * 18 // 32 + 2),
                      _ebucket(qh * pairs * vlc // 32 + 2),
                      _ebucket(qw * qh * 4 * (kx + 1) // 32 + 2))
            g.n_pad = -(-len(g.lanes) // 8) * 8
            if any(g.multi):
                g.rcap = -(-cap_words(g.w, g.h) // _CHUNK) * _CHUNK
        passes, causal = self.ht_passes, self.cod.vert_causal
        key = (tuple((g.gid, g.w, g.h, len(g.lanes), tuple(g.strips),
                      tuple(g.p), g.caps, g.bits, tuple(g.multi), g.rcap)
                     for g in glist),
               tuple(bands), tuple(comps), mct, passes, causal)
        return _EncPlan(key, glist, bands, comps, mct, passes, causal)

    @torch.inference_mode()
    def _encode_tile(self, idx: int, tr, planes: List[np.ndarray]) \
            -> List[tuple]:
        geom = build_tile(self.hdr, idx, tr)
        nc = self.siz.num_comps
        with trace.stage('encode.plan'):
            plan = self._build_enc_plan(geom)
        with trace.stage('encode.compile'):
            runner = _make_enc_runner(plan, 1, self.device)
        tplanes = [_narrow_tile_plane(self.siz, geom, c, planes[c])[None]
                   for c in range(nc)]
        # the upload waits for the copy; the runner is only enqueued:
        # its device time lands in encode.pack.fetch
        with trace.stage('encode.device'):
            with trace.stage('encode.upload'):
                tplanes = [torch.from_numpy(t).to(self.device)
                           for t in tplanes]
            cats, aux = runner(*tplanes)
        coded = _empty_coded(geom, nc)
        with trace.stage('encode.segment_pack'):
            self._consume_outs(plan, cats, aux, [coded])
        with trace.stage('encode.t2'):
            return _tile_packets(self, geom, coded)

    def _consume_outs(self, plan, cats, aux, codeds):
        """Fetch a runner's outputs and fill each frame's coded-block
        structure (``codeds``, one per frame of the runner)."""
        with trace.stage('encode.pack.fetch'):
            outs = _fetch_outs(plan, cats, aux, len(codeds))
        self._stuff(plan, *outs, codeds)

    def _stuff(self, plan, dense, metas, nz_all, refs, codeds):
        """Host byte stuffing (pack_from_dense) of every frame's lanes
        into cleanup segments, filling ``codeds``; a kept multi-pass
        lane's refinement segment is K5's bytes as they are."""
        for g, meta, nz, ref in zip(plan.groups, metas, nz_all, refs):
            L = len(g.lanes)
            # stuffing can expand the packed bytes by up to 8/7
            stride = int(meta[:, 1::2].sum(axis=1).max()) // 7 + 64
            # every frame's real lanes (not the padding) in one call
            real = meta.reshape(len(codeds), g.n_pad, 6)[:, :L]
            with trace.stage('encode.pack.stuff'):
                out, lens = native.pack_from_dense(
                    dense, real.reshape(-1, 6), out_stride=stride)
            with trace.stage('encode.pack.fill'):
                for f, coded in enumerate(codeds):
                    lanes = slice(f * g.n_pad, f * g.n_pad + L)
                    self._fill_coded(
                        plan, g, coded, out[f * L:(f + 1) * L],
                        lens[f * L:(f + 1) * L], nz[f], dense,
                        None if ref is None else [r[lanes] for r in ref])

    def _fill_coded(self, plan, g, coded, out, lens, nz, dense, ref):
        for lane, (bid, bi, h_t) in enumerate(g.lanes):
            (c, r, b, kmax, _, _, _, _) = plan.bands[bid]
            cb = coded[c][r][b][bi]
            if not nz[lane]:
                continue  # zero block
            if lens[lane] == 0:
                raise RuntimeError('HT cleanup encoder: a segment '
                                   'overflowed the host stuffer')
            seg1 = bytes(out[lane, :lens[lane]])
            if ref is not None and ref[0][lane]:
                at, n = int(ref[1][lane]), int(ref[2][lane].sum())
                seg2 = dense[at:at + (n + 3) // 4].view(np.uint8)[:n]
                cb.missing_msbs = kmax - 2
                cb.num_passes = plan.passes
                cb.data = seg1 + seg2.tobytes()
                cb.pass_length[0] = len(seg1)
                cb.pass_length[1] = n
                continue
            cb.missing_msbs = kmax - 1
            cb.num_passes = 1
            cb.data = seg1
            cb.pass_length[0] = int(lens[lane])


def _group_of(groups: Dict[int, _EncGroup], gid: int) -> _EncGroup:
    return next(g for g in groups.values() if g.gid == gid)


def encode_gpu(planes, device='cuda', **kwargs) -> bytes:
    """Encode planes ((H, W) / (H, W, C) array or list of planes) into a
    .j2c codestream on ``device``.  Same keyword surface as
    openjph_tpu.encode."""
    planes = normalize_planes(planes)
    enc = build_encoder(planes[0].shape, len(planes),
                        functools.partial(GpuEncoder, device=device),
                        **kwargs)
    return enc.encode([np.asarray(p) for p in planes])


def _narrow_dtype_for(siz, c):
    """Smallest upload dtype for component c's samples; int64 above 28
    bits, which the JAX package's encoder converts in int64."""
    bd = siz.comps[c].bit_depth
    sgn = siz.comps[c].is_signed
    if bd <= 8:
        return np.int8 if sgn else np.uint8
    if bd <= 16:
        return np.int16 if sgn else np.uint16
    return np.int32 if bd <= 28 else np.int64


def _narrow_tile_plane(siz, geom, c, plane):
    """Slice component c's tile plane and narrow it to the smallest
    upload dtype; the runner widens on the device."""
    comp = geom.comps[c]
    dx, dy = siz.comps[c].dx, siz.comps[c].dy
    ox = comp.rect.x0 - (-(-siz.xosiz // dx))
    oy = comp.rect.y0 - (-(-siz.yosiz // dy))
    tp = plane[oy:oy + comp.rect.h, ox:ox + comp.rect.w]
    return np.ascontiguousarray(tp.astype(_narrow_dtype_for(siz, c)))


def _empty_coded(geom, nc):
    """Fresh coded-block structure for one tile."""
    coded = [[[None] * 4
              for _ in range(geom.comps[c].num_decomps + 1)]
             for c in range(nc)]
    for c in range(nc):
        comp = geom.comps[c]
        for r in range(comp.num_decomps + 1):
            for b in ([0] if r == 0 else [1, 2, 3]):
                sb = comp.resolutions[r].bands[b]
                if sb is not None and not sb.empty:
                    coded[c][r][b] = [CodedBlock() for _ in sb.blocks]
    return coded


def _tile_packets(enc, geom, coded):
    """Emit one tile's packets in progression order, annotated
    (comp, res) for tile-part division (tile::flush prog-order state
    machines, ojph_tile.cpp:584-774)."""
    cod = enc.cod
    packets = []
    for (c, r, pidx) in precinct_iterator(geom, cod.prog_order):
        res = geom.comps[c].resolutions[r]
        packets.append((c, r, encode_precinct(
            res, pidx, coded[c][r], cod.uses_eph, cod.uses_sop)))
    return packets


# ---------------------------------------------------------------------------
# Bursts and video
# ---------------------------------------------------------------------------

_EF_BUCKETS = (8, 4, 2, 1)
# burst runners by (plan key, frames, device)
_ENC_RUNNERS = Cache(32)


def _enc_runner(plan: _EncPlan, nframes: int, device,
                stage: str = 'encode.compile') -> _EncRunner:
    """The cached encode runner of ``nframes`` frames of ``plan``'s key;
    a miss makes it under the trace stage ``stage``."""
    def make():
        with trace.stage(stage):
            return _make_enc_runner(plan, nframes, device)

    return _ENC_RUNNERS.get((plan.key, nframes, device), make)


class VideoEncoder:
    """Pipelined burst encoder for sequences of frames of one shape, on
    ``device`` ('cuda' by default; 'cpu' runs the kernel's plain
    version); the keywords are openjph_tpu.encode's.

    ``submit`` hands a burst to the workers and returns: the prep worker
    narrows and stacks the frames; one of two io workers, each with its
    own CUDA stream, uploads them, runs one runner (the device graph and
    the HT cleanup encoder of the whole burst), fetches the coded words
    and stuffs them into segments; the t2 worker packetizes and
    assembles the codestreams.  ``collect`` returns the oldest burst's
    codestreams, each byte-identical to ``encode_gpu`` of its frame.

    A frame of several tiles, or a burst whose size is not one of
    ``_EF_BUCKETS``, encodes frame by frame through ``GpuEncoder.encode``
    on the same device; ``fused_bursts`` and ``fallback_bursts`` count
    the two kinds.  A lane that overflows its word caps raises
    RuntimeError.  Errors inside a worker surface at ``collect``."""

    def __init__(self, device='cuda', **enc_kwargs):
        self.device = resolve_device(device)
        self._kwargs = enc_kwargs
        self._enc = None
        self._inflight = []
        self.fused_bursts = 0
        self.fallback_bursts = 0
        self._stager = Stager(self.device)
        self._io_streams = threading.local()
        self._prep_pool = ThreadPoolExecutor(max_workers=1)
        self._io_pool = ThreadPoolExecutor(max_workers=2)
        self._t2_pool = ThreadPoolExecutor(max_workers=1)

    def _ensure(self, frame) -> None:
        planes0 = normalize_planes(frame)
        self._enc = build_encoder(
            planes0[0].shape, len(planes0),
            functools.partial(GpuEncoder, device=self.device),
            **self._kwargs)
        trs = build_tile_grid(self._enc.siz)
        self._plan = None
        if len(trs) == 1:
            self._geom = build_tile(self._enc.hdr, 0, trs[0])
            self._plan = self._enc._build_enc_plan(self._geom)

    def submit(self, frames) -> None:
        """Enqueue a burst (a list of (H, W) or (H, W, C) arrays, or of
        lists of planes)."""
        self._inflight.append(self._prep_pool.submit(self._encode_burst,
                                                     list(frames)))

    def collect(self) -> List[bytes]:
        """Block for and return the oldest burst's codestreams."""
        item = self._inflight.pop(0).result()
        if isinstance(item, list):
            return item  # encoded frame by frame
        return item.result()

    @property
    def depth(self) -> int:
        return len(self._inflight)

    def close(self) -> None:
        """Stop the workers once the submitted bursts are done."""
        for pool in (self._prep_pool, self._io_pool, self._t2_pool):
            pool.shutdown(wait=True)

    @torch.inference_mode()
    def _encode_burst(self, frames):
        if self._enc is None:
            self._ensure(frames[0])
        enc, plan = self._enc, self._plan
        if plan is None or len(frames) not in _EF_BUCKETS:
            self.fallback_bursts += 1
            return [enc.encode(normalize_planes(f)) for f in frames]
        self.fused_bursts += 1
        runner = _enc_runner(plan, len(frames), self.device)
        with trace.stage('encode.host_prep'):
            planes = [normalize_planes(f) for f in frames]
            stacks = [np.stack([_narrow_tile_plane(enc.siz, self._geom, c,
                                                   p[c]) for p in planes])
                      for c in range(enc.siz.num_comps)]
        cfut = self._io_pool.submit(self._io, runner, stacks)
        return self._t2_pool.submit(self._t2, cfut)

    def _io_stream(self):
        """This io worker's own CUDA stream (None on the CPU)."""
        if self.device.type != 'cuda':
            return None
        s = getattr(self._io_streams, 'stream', None)
        if s is None:
            s = self._io_streams.stream = torch.cuda.Stream(self.device)
        return s

    @torch.inference_mode()
    def _io(self, runner: _EncRunner, stacks):
        """Upload, encode and stuff one burst on this worker's stream
        (the fetch synchronises that stream): its coded blocks."""
        stream = self._io_stream()
        codeds = [_empty_coded(self._geom, len(stacks))
                  for _ in range(runner.F)]
        with torch.cuda.stream(stream):
            with trace.stage('encode.device'):
                with trace.stage('encode.dev.upload_exec'):
                    planes = self._stager.upload(
                        (runner.plan.key, runner.F), stacks, stream)
                    cats, aux = runner(*planes)
                with trace.stage('encode.dev.aux_fetch'):
                    aux = aux.cpu()
            with trace.stage('encode.segment_pack'):
                self._enc._consume_outs(runner.plan, cats, aux, codeds)
        return codeds

    def _t2(self, cfut) -> List[bytes]:
        enc, geom = self._enc, self._geom
        codeds = cfut.result()
        with trace.stage('encode.t2'):
            return [enc.assemble([_tile_packets(enc, geom, coded)])
                    for coded in codeds]


def encode_gpu_batch(frames, device='cuda', **kwargs) -> List[bytes]:
    """Encode many frames of one shape on ``device``, batched into
    bursts of _EF_BUCKETS sizes (see :class:`VideoEncoder`); each
    codestream is byte-identical to ``encode_gpu`` of its frame."""
    enc = VideoEncoder(device=device, **kwargs)
    try:
        i = 0
        while i < len(frames):
            F = next(f for f in _EF_BUCKETS if f <= len(frames) - i)
            enc.submit(frames[i:i + F])
            i += F
        out = []
        while enc.depth:
            out.extend(enc.collect())
        return out
    finally:
        enc.close()
