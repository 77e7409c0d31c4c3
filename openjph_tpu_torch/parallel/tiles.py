"""Tile mosaics (BASELINE.json config 5) over a device mesh, both
directions: the JAX package's parallel/tiles.py on the port's fused
runners.

The reference decodes a multi-tile codestream tile by tile on one CPU
(tiles are parsed independently, ojph_codestream_local.cpp:912-1115).
Here tile independence is a batch axis: every tile of a uniform grid
has the same plan geometry, so the tiles of a mosaic batch along the
fused decoder's frame axis (frame f of the runner is a tile), split
over the mesh's devices with no communication.  Edge tiles (right and
bottom rims of an image that does not divide by the tile size) have
other geometries and form their own, smaller classes.

A class larger than ``batch_tiles`` runs in sub-batches, so host and
device memory stay bounded by one sub-batch of tiles: a 32K mosaic of
1K tiles is one 1,024-tile class.  Each sub-batch is padded to a
``_bucket`` of tiles (padding slots replicate its first tile and are
dropped).  Nothing of a tile is kept past its sub-batch, neither its
plan nor its Tier-2 records nor its geometry: the sub-batch parses and
plans its tiles and drops them with it, so host memory does not grow
with the tile count (tiles of one geometry share a cached plan
skeleton, gpu/pipeline.py::_plan_skeleton).  Decode runs K2 (raw readers, the
default) or K1 (dense), and K4 on classes with refinement passes;
encode runs K3 (its 64-bit instantiation on bands of more than 30 bit
planes) and, with ``ht_passes`` 2 or 3, K5.  Nothing falls back: what
the fused runners cannot take raises, and where the JAX package's
mosaics refuse a stream (decode of more than 30 bit planes, and the
chunked encode of a stream its fused plan cannot take: more than 30 bit
planes, or multi-pass), so do these, with its ValueError.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..codec import build_encoder, normalize_planes
from ..core.geometry import build_tile, build_tile_grid
from ..core.message import warn as _wrn
from ..gpu.encode_pipeline import (GpuEncoder, _empty_coded, _enc_runner,
                                   _narrow_dtype_for, _narrow_tile_plane,
                                   _tile_packets)
from ..gpu.pipeline import (GpuDecoder, _bucket, _build_plan,
                            _burst_runner, _geometry_key, _merge_words,
                            _pack, upload)
from ..utils import trace
from .mesh import Mesh, make_mesh, pad_to_multiple, per_device

# the JAX package's refusals (openjph_tpu/parallel/tiles.py:89-91,
# 335-338); the second also refuses a multi-pass chunked encode
_WIDE_DECODE = ('>30 bit-plane streams take the host path; mosaic sharding '
                'unsupported')
_NOT_FUSED_CHUNKED = ('stream not eligible for the fused encode path; '
                      'chunked ingest needs it')


class _MemoPlans(dict):
    """MosaicDecoder's per-tile plans (the JAX package's _MemoPlans):
    tile ``ti``'s plan at its class's largest word buckets, under the
    class's ``top`` key, built at first access and kept, so a caller that
    changes a plan (as a cross-mosaic word-bucket unification does) keeps
    its change.  ``values()`` builds every tile's.  The decode paths never
    fill it: they plan each sub-batch afresh and drop the plans with it."""

    def __init__(self, md: 'MosaicDecoder'):
        super().__init__()
        self._md = md

    def __missing__(self, ti: int):
        md = self._md
        with md.dec.tiles.held((ti,)):
            with trace.stage('decode.plan'):
                plan = _build_plan(md.dec, (ti,))
        gk = _geometry_key(plan.key)
        top = next(c['top'] for c in md.classes
                   if _geometry_key(c['top'].key) == gk)
        plan = _merge_words([plan, top])[0]
        self[ti] = plan
        return plan

    def values(self):
        for ti in range(len(self._md.dec.tiles)):
            self[ti]
        return super().values()


def _frames(T: int, ndev: int) -> int:
    """Frames of a sub-batch of T tiles: a _bucket size at least the
    mesh size, split evenly over it."""
    return pad_to_multiple(max(_bucket(T, lo=8), ndev), ndev)


class MosaicDecoder:
    """Decode a multi-tile codestream with its tiles batched on the fused
    decode runner and split over ``mesh`` (``make_mesh()``: the visible
    CUDA devices; a CPU mesh runs the kernels' plain versions).

    ``data`` may be bytes or an ``mmap`` of a file.  ``batch_tiles``
    bounds a dispatch: a geometry class with more tiles runs in
    sub-batches.  ``resilient``: broken codeblocks decode as zero blocks
    with warning 0x00080006, as in ``GpuDecoder``; strict mode raises
    ValueError.  ``raw`` picks the runner's input layout (K2, or K1 with
    ``raw=False``).  Streams with a band of more than 30 bit planes
    raise ValueError, as the JAX package's MosaicDecoder does.

    The decoder indexes the tile-parts and parses a tile's Tier-2 only
    while it plans the tile (``dec.tiles`` is lazy, codec._LazyTiles):
    once a tile at construction, for its class, and once in its
    sub-batch, so host memory does not grow with the tile count.

    ``classes`` lists the geometry classes: dicts with the class's
    ``tiles`` (tile indices) and ``top``, a plan at the largest word
    buckets of any member (every sub-batch of the class runs at them, in
    refine mode if any member has refinement passes); ``plan`` names the
    same object, as in the JAX package's classes.  ``tile_plans[ti]`` is
    tile ti's own plan under its class's key, built at first access and
    kept (``tile_plans.values()`` builds them all); the decode paths never
    fill it."""

    def __init__(self, data, mesh: Optional[Mesh] = None,
                 skip_res: int = 0, batch_tiles: int = 64,
                 resilient: bool = False, raw: bool = True):
        self.mesh = mesh or make_mesh()
        self.ndev = self.mesh.size
        self.batch_tiles = max(batch_tiles, self.ndev)
        self.resilient = resilient
        self.raw = raw
        self.dec = GpuDecoder(data, device=self.mesh.devices[0], raw=raw,
                              skipped_res_for_read=skip_res,
                              skipped_res_for_recon=skip_res,
                              resilient=resilient, lazy_tiles=True)
        tiles = self.dec.tiles
        # classes by the plan key without its word buckets (those depend
        # on the tiles' coded bytes); each keeps one plan at its members'
        # largest buckets (_merge_words), not the members' plans
        self.classes: List[dict] = []
        by_key: Dict[tuple, dict] = {}
        with trace.stage('mosaic.host_prep'):
            for ti in range(len(tiles)):
                with tiles.held((ti,)):
                    if self.dec._wide_band(tiles[ti]):
                        raise ValueError(_WIDE_DECODE)
                    with trace.stage('decode.plan'):
                        plan = _build_plan(self.dec, (ti,))
                gk = _geometry_key(plan.key)
                cls = by_key.get(gk)
                if cls is None:
                    cls = by_key[gk] = {'tiles': [], 'top': plan}
                    self.classes.append(cls)
                else:
                    cls['top'] = _merge_words([cls['top'], plan])[0]
                cls['tiles'].append(ti)
        for cls in self.classes:
            cls['plan'] = cls['top']
        self.tile_plans = _MemoPlans(self)

    def _run_classes(self):
        """Yield (tile indices, comps, errs, broken) per geometry-class
        sub-batch, one runner call per mesh device each (see
        decode_on_device)."""
        for cls in self.classes:
            all_tiles = cls['tiles']
            for at in range(0, len(all_tiles), self.batch_tiles):
                tiles = all_tiles[at:at + self.batch_tiles]
                T = len(tiles)
                F = _frames(T, self.ndev)
                fd = F // self.ndev
                with trace.stage('mosaic.host_prep'), \
                        self.dec.tiles.held(tiles):
                    # tile i is frame i; padding frames replicate tile 0
                    with trace.stage('decode.plan'):
                        plans = [_build_plan(self.dec, (ti,))
                                 for ti in tiles]
                    plans = _merge_words(plans + [cls['top']])[:-1]
                    broken = sum(p.broken for p in plans)
                    plans += [plans[0]] * (F - T)
                    args = [_pack([(self.dec, p) for p in
                                   plans[i * fd:(i + 1) * fd]], self.raw)
                            for i in range(self.ndev)]
                    del plans
                runners = [_burst_runner(cls['top'], fd, d, self.raw,
                                         stage='mosaic.compile')
                           for d in self.mesh.devices]
                comps, errs = [], []
                with trace.stage('mosaic.dispatch'), \
                        torch.inference_mode():
                    for a, runner, d in zip(args, runners,
                                            self.mesh.devices):
                        e, outs = runner(*upload(a, d))
                        # one tile per plan: outs[0] is its components
                        comps.append(outs[0])
                        errs.append(e)
                del args
                yield (list(tiles),
                       tuple(per_device(self.mesh, [c[k] for c in comps])
                             for k in range(len(comps[0]))),
                       per_device(self.mesh, errs), broken)

    def decode_on_device(self):
        """One runner call per mesh device and geometry-class sub-batch.
        Returns a list of ``(tiles, comps, errs)``: ``tiles`` the tile
        indices of the sub-batch; on a one-device mesh ``comps[c]`` is a
        tensor [F, h, w] on it, component c of tile ``tiles[i]`` at
        index i (entries past ``len(tiles)`` are padding replicas), and
        ``errs`` the runner's lane flags; on a mesh of several devices
        each is the tuple of the devices' slices, in mesh order, device
        k holding frames [k * F/n, (k + 1) * F/n).  The flags are not
        checked here."""
        return [(t, c, e) for t, c, e, _ in self._run_classes()]

    def _host(self, comps, errs, broken):
        """Check a sub-batch's flags (padding slots replicate tile 0, so
        a blanket count is exact) and fetch its components."""
        errs = errs if isinstance(errs, tuple) else (errs,)
        nerr = sum(int(e.sum()) for e in errs)
        if nerr and not self.resilient:
            raise ValueError('U_q exceeds missing_msbs + 2')
        if broken or nerr:
            _wrn(0x00080006, 'broken codeblock(s) zeroed (resilient)')
        return [np.concatenate([p.cpu().numpy() for p in c])
                if isinstance(c, tuple) else c.cpu().numpy()
                for c in comps]

    def decode(self) -> List[np.ndarray]:
        """Host-assembled full-image planes (bit-exact with Decoder for
        5/3)."""
        tile_planes: Dict[int, List[np.ndarray]] = {}
        for tiles, comps, errs, broken in self._run_classes():
            host = self._host(comps, errs, broken)
            for i, ti in enumerate(tiles):
                tile_planes[ti] = [h[i] for h in host]
        return self.dec._assemble(tile_planes)

    def decode_to(self, sink) -> None:
        """Streaming decode: ``sink(tile_idx, planes)`` for every tile,
        without assembling the image, so host memory stays bounded by
        one sub-batch.  ``planes`` are the tile's component planes cropped
        to the tile rect."""
        for tiles, comps, errs, broken in self._run_classes():
            host = self._host(comps, errs, broken)
            for i, ti in enumerate(tiles):
                sink(ti, [h[i] for h in host])


def decode_mosaic(data, mesh: Optional[Mesh] = None,
                  skip_res: int = 0) -> List[np.ndarray]:
    """Tile-batched decode of a multi-tile stream; returns the assembled
    component planes."""
    return MosaicDecoder(data, mesh, skip_res).decode()


class MosaicEncoder:
    """Tile-batched encode of a multi-tile image over ``mesh``, the
    encode side of MosaicDecoder: the tiles of a geometry class batch on
    the fused encode runner's frame axis (K3), split over the mesh's
    devices; byte stuffing, Tier-2 and assembly run on the host.  The
    output is byte-identical to ``encode_gpu``'s.  The keywords are
    openjph_tpu.encode's.  Bands of 31 or more bit planes go through
    K3's 64-bit instantiation in ``encode``, and multi-pass codeblocks
    (``ht_passes`` 2 or 3) through K3 and K5, as ``encode_gpu`` codes
    them; ``encode_chunked`` refuses both with the JAX package's
    ValueError (its fused plan takes neither, and its chunked ingest has
    no whole image to code them from).  A K3 or K5 overflow raises
    RuntimeError, as ``encode_gpu`` does."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 batch_tiles: int = 64, **enc_kwargs):
        self.mesh = mesh or make_mesh()
        self.ndev = self.mesh.size
        self.batch_tiles = max(batch_tiles, self.ndev)
        self._kwargs = enc_kwargs

    def encode(self, planes) -> bytes:
        planes = normalize_planes(planes)
        nc = len(planes)

        def read_tile(ti, geom, siz):
            return [_narrow_tile_plane(siz, geom, c, planes[c])
                    for c in range(nc)]

        return self._encode_common(planes[0].shape, nc, read_tile)

    def encode_chunked(self, tile_reader, shape, num_comps: int = 1,
                       out=None) -> Optional[bytes]:
        """Encode an image too large to hold: ``tile_reader(tile_idx,
        geom)`` returns the tile's per-component planes (tile-local
        arrays of the tile component rect's shape), read from disk,
        generated, or fetched on demand; one sub-batch of tiles is held
        at a time.  ``out``: an open binary file that the tile-parts
        stream to as their sub-batch finishes (class order, legal per
        T.800 A.4.2), so the codestream is never held either; returns
        None.  Without ``out`` the assembled bytes are returned."""
        def read_tile(ti, geom, siz):
            tps = tile_reader(ti, geom)
            return [np.ascontiguousarray(
                np.asarray(tp).astype(_narrow_dtype_for(siz, c)))
                for c, tp in enumerate(tps)]

        return self._encode_common(shape, num_comps, read_tile, out=out,
                                   chunked=True)

    @torch.inference_mode()
    def _encode_common(self, shape, nc, read_tile, out=None,
                       chunked: bool = False):
        enc = build_encoder(shape, nc,
                            functools.partial(GpuEncoder,
                                              device=self.mesh.devices[0]),
                            **self._kwargs)
        trs = build_tile_grid(enc.siz)
        if chunked and enc.ht_passes != 1:
            # the JAX package's fused plan takes no multi-pass stream
            # (tpu/encode_pipeline.py:105-106), so its chunked ingest
            # refuses one
            raise ValueError(_NOT_FUSED_CHUNKED)
        # geometry classes (encode plan keys are geometry-only); a tile's
        # geometry and plan build when the class pass or its sub-batch
        # needs them, and only each class's first plan is kept, so host
        # memory does not grow with the tile count
        classes: List[dict] = []
        by_key: Dict[tuple, dict] = {}
        for ti, tr in enumerate(trs):
            plan = enc._build_enc_plan(build_tile(enc.hdr, ti, tr))
            if chunked and any(g.bits == 64 for g in plan.groups):
                # the JAX package codes such a tile on its host, from the
                # whole image, which chunked ingest does not have
                raise ValueError(_NOT_FUSED_CHUNKED)
            cls = by_key.get(plan.key)
            if cls is None:
                cls = by_key[plan.key] = {'plan': plan, 'tiles': []}
                classes.append(cls)
            cls['tiles'].append(ti)
        if out is not None:
            enc.stream_begin(out)
        all_packets = [None] * len(trs) if out is None else None
        for cls in classes:
            plan, all_tiles = cls['plan'], cls['tiles']
            for at in range(0, len(all_tiles), self.batch_tiles):
                tiles = all_tiles[at:at + self.batch_tiles]
                T = len(tiles)
                F = _frames(T, self.ndev)
                fd = F // self.ndev
                with trace.stage('mosaic.enc_host_prep'):
                    geoms = {ti: build_tile(enc.hdr, ti, trs[ti])
                             for ti in tiles}
                    per_tile = [read_tile(ti, geoms[ti], enc.siz)
                                for ti in tiles]
                    per_tile += [per_tile[0]] * (F - T)
                    stacks = [[np.stack([pt[c] for pt in
                                         per_tile[i * fd:(i + 1) * fd]])
                               for c in range(nc)]
                              for i in range(self.ndev)]
                    del per_tile
                runs = []
                with trace.stage('mosaic.enc_dispatch'):
                    for st, d in zip(stacks, self.mesh.devices):
                        runner = _enc_runner(plan, fd, d,
                                             stage='mosaic.enc_compile')
                        runs.append(runner(*(torch.from_numpy(s).to(d)
                                             for s in st)))
                del stacks
                # padding frames fill a throwaway structure
                codeds = [_empty_coded(geoms[ti], nc) for ti in tiles] \
                    + [_empty_coded(geoms[tiles[0]], nc)
                       for _ in range(F - T)]
                with trace.stage('mosaic.enc_pack'):
                    for i, (cats, aux) in enumerate(runs):
                        enc._consume_outs(plan, cats, aux,
                                          codeds[i * fd:(i + 1) * fd])
                    del runs
                with trace.stage('mosaic.enc_t2'):
                    for ti, coded in zip(tiles, codeds):
                        packets = _tile_packets(enc, geoms[ti], coded)
                        if out is None:
                            all_packets[ti] = packets
                        else:
                            enc.stream_tile(out, ti, packets)
        if out is not None:
            enc.stream_end(out)
            return None
        return enc.assemble(all_packets)


def encode_mosaic(planes, mesh: Optional[Mesh] = None,
                  **enc_kwargs) -> bytes:
    """Tile-batched encode; returns the .j2c codestream."""
    return MosaicEncoder(mesh, **enc_kwargs).encode(planes)
