"""Device meshes for the codec's scale-out (the JAX package's
parallel/mesh.py).

Three sharding axes map the codec onto several devices:
 - 'b' (block-parallel): codeblock batches and tile batches split over
   the mesh's devices; each decodes or encodes its slice with no
   communication (codeblocks are independent by construction,
   ojph_subband.cpp:292-333);
 - row-sharded spatial: large planes split by rows over the processes
   of a ``torch.distributed`` group; DWT lifting exchanges halo rows
   (parallel/dwt_sharded.py);
 - frames across processes: plain data parallelism at the pipeline
   level (parallel/multihost.py).

A :class:`Mesh` is an ordered tuple of ``torch.device`` entries and an
axis name.  On one H100 it has one entry; ``make_mesh(n, device='cpu')``
gives ``n`` CPU entries, on which the kernels' plain versions run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..gpu.block_decode_cuda import decode_cleanup
from ..gpu.pipeline import resolve_device


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis: str = 'b'

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = 'b',
              device='cuda') -> Mesh:
    """A mesh of the first ``n_devices`` visible CUDA devices (all of
    them by default; RuntimeError without CUDA), or of ``n_devices`` CPU
    entries (default 1) with ``device='cpu'``."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return Mesh((dev,) * (n_devices or 1), axis)
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f'{n} CUDA devices asked for, {count} visible')
    return Mesh(tuple(torch.device('cuda', i) for i in range(n)), axis)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def split_lanes(mesh: Mesh, n: int):
    """(device, lane slice) of each mesh entry for ``n`` lanes, which
    must divide evenly by the mesh size."""
    if n % mesh.size:
        raise ValueError(f'{n} lanes do not split evenly over '
                         f'{mesh.size} devices (pad_to_multiple)')
    k = n // mesh.size
    return [(d, slice(i * k, (i + 1) * k))
            for i, d in enumerate(mesh.devices)]


def per_device(mesh: Mesh, parts):
    """A result of one mesh entry as itself, of several as the tuple of
    their slices in mesh order."""
    parts = tuple(parts)
    return parts[0] if mesh.size == 1 else parts


def decode_blocks_sharded(mesh: Mesh, streams, p, width: int,
                          height: int, qh_lim=None):
    """Decode a batch of same-shape cleanup segments split over the
    mesh's devices, through the HT cleanup decoder's dense readers (K1
    on a CUDA device, its plain version on the CPU).  ``streams`` holds
    the dense word rows 'mel', 'vlc', 'ms' ([N, W*] uint32, as
    native.prep_cleanup_streams makes them); ``p`` = 30 -
    missing_msbs [N].  N must divide evenly by the mesh size (pad with
    replicas via pad_to_multiple).  Returns (dec, err): on a one-device
    mesh the [N, height, width] int32 (uint32 bit patterns) and [N] bool
    tensors on it, else the tuples of per-device slices in mesh order."""
    def i32(a):
        a = np.ascontiguousarray(np.asarray(a))
        return torch.from_numpy(a.view(np.int32) if a.dtype.itemsize == 4
                                else a.astype(np.int32))

    mel, vlc, ms = (i32(streams[k]) for k in ('mel', 'vlc', 'ms'))
    pt = i32(p)
    qt = None if qh_lim is None else i32(qh_lim)
    decs, errs = [], []
    for dev, sl in split_lanes(mesh, pt.shape[0]):
        d, e = decode_cleanup(
            mel[sl].to(dev), vlc[sl].to(dev), ms[sl].to(dev),
            pt[sl].to(dev), width, height,
            None if qt is None else qt[sl].to(dev))
        decs.append(d)
        errs.append(e)
    return per_device(mesh, decs), per_device(mesh, errs)
