"""Frame fan-out across processes over ``torch.distributed`` (the JAX
package's parallel/multihost.py).

The reference's only distributed component fans frames out to worker
threads on one host (ojph_stream_expand's packets / frames handlers and
thread pool).  Here frames are independent codestreams, so they spread
over processes, each on its own device (or several sharing one), with
no communication on the coding path itself: process p codes frames p,
p + N, p + 2N, ... of a burst through the fused burst coders, and with
``gather`` the results are exchanged by one all-gather so that every
process returns the whole burst, bit-exact (decode) and byte-identical
(encode) with a single process's.

Every process calls :func:`init` first.  The group's address is given,
not discovered (``tcp://host:port``); gloo works on the CPU and between
processes that share one card, NCCL between processes on their own
cards.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def init(coordinator_address: str, num_processes: int, process_id: int,
         backend: str = 'gloo') -> None:
    """Join this process to the group at ``coordinator_address``
    (``host:port``; process 0 listens there) as rank ``process_id`` of
    ``num_processes``."""
    dist.init_process_group(backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)


def _gather_device():
    """Where the all-gather's tensors live: the card for NCCL, else the
    host."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _gather_bytes(blobs: List[bytes]):
    """All-gather variable-length byte strings across processes: the
    lengths first, then one padded uint8 all-gather.  Returns (lengths
    [nproc, n] int64, bytes [nproc, n, max length] uint8), numpy."""
    dev = _gather_device()
    nproc = dist.get_world_size()
    lens = torch.tensor([len(b) for b in blobs], dtype=torch.int64,
                        device=dev)
    all_lens = [torch.empty_like(lens) for _ in range(nproc)]
    dist.all_gather(all_lens, lens)
    all_lens = torch.stack(all_lens).cpu().numpy()
    m = max(int(all_lens.max()) if all_lens.size else 1, 1)
    pad = np.zeros((len(blobs), m), np.uint8)
    for i, b in enumerate(blobs):
        pad[i, :len(b)] = np.frombuffer(b, np.uint8)
    mine = torch.from_numpy(pad).to(dev)
    allb = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(allb, mine)
    return all_lens, torch.stack(allb).cpu().numpy()


def _pack_planes(planes) -> bytes:
    """A frame's planes as one blob: their count, then per plane a
    'dtype:shape;' header and the raw samples."""
    parts = []
    for p in planes:
        p = np.ascontiguousarray(p)
        hdr = ('%s:%s;' % (p.dtype.str,
                           ','.join(map(str, p.shape)))).encode()
        parts.append(np.uint32(len(hdr)).tobytes() + hdr + p.tobytes())
    return np.uint32(len(planes)).tobytes() + b''.join(parts)


def _unpack_planes(raw: bytes) -> List[np.ndarray]:
    nplanes = int(np.frombuffer(raw[:4], np.uint32)[0])
    off = 4
    planes = []
    for _ in range(nplanes):
        hl = int(np.frombuffer(raw[off:off + 4], np.uint32)[0])
        off += 4
        dt, shp = raw[off:off + hl].decode()[:-1].split(':')
        off += hl
        shape = tuple(int(v) for v in shp.split(','))
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        planes.append(np.frombuffer(raw[off:off + n], dt).reshape(shape))
        off += n
    return planes


def _mine(n: int) -> List[int]:
    """This process's round-robin share of n frames."""
    return list(range(dist.get_rank(), n, dist.get_world_size()))


def decode_frames(streams: List[bytes], skip_res: int = 0,
                  gather: bool = True, device='cuda',
                  **kwargs) -> List[Optional[List[np.ndarray]]]:
    """Decode a burst of codestreams spread across the group's processes:
    process p decodes ``streams[p::N]`` with ``decode_gpu_batch`` on
    ``device`` (keywords: its ``resilient`` and ``raw``).  With
    ``gather`` every process returns the whole burst in order; without,
    the other processes' entries are None (results stay where they were
    made, the stream_expand storer pattern)."""
    from ..gpu.pipeline import decode_gpu_batch
    nproc = dist.get_world_size()
    mine = _mine(len(streams))
    local = decode_gpu_batch([streams[i] for i in mine], device=device,
                             skip_res=skip_res, **kwargs) if mine else []
    results: List[Optional[list]] = [None] * len(streams)
    for i, planes in zip(mine, local):
        results[i] = planes
    if not gather or nproc == 1:
        return results
    all_lens, allb = _gather_bytes(
        [b'' if r is None else _pack_planes(r) for r in results])
    for i in range(len(streams)):
        if results[i] is None:
            owner = i % nproc
            results[i] = _unpack_planes(
                bytes(allb[owner, i, :all_lens[owner, i]]))
    dist.barrier()
    return results


def encode_frames(frames, gather: bool = True, device='cuda',
                  **enc_kwargs) -> List[Optional[bytes]]:
    """Encode a burst of frames spread across the group's processes, the
    mirror of :func:`decode_frames`: process p encodes ``frames[p::N]``
    with ``encode_gpu_batch`` on ``device`` (the keywords are
    openjph_tpu.encode's); with ``gather`` the codestreams are exchanged
    so every process returns the whole burst, each byte-identical to a
    single process's encode; without, the other entries are None."""
    from ..gpu.encode_pipeline import encode_gpu_batch
    nproc = dist.get_world_size()
    mine = _mine(len(frames))
    local = encode_gpu_batch([frames[i] for i in mine], device=device,
                             **enc_kwargs) if mine else []
    results: List[Optional[bytes]] = [None] * len(frames)
    for i, s in zip(mine, local):
        results[i] = s
    if not gather or nproc == 1:
        return results
    all_lens, allb = _gather_bytes([r or b'' for r in results])
    for i in range(len(frames)):
        if results[i] is None:
            owner = i % nproc
            results[i] = bytes(allb[owner, i, :all_lens[owner, i]])
    dist.barrier()
    return results


def seeded_frames(n: int, w: int, h: int) -> List[np.ndarray]:
    """The worker's seeded 8-bit frames: ramps plus one bit of noise."""
    rng = np.random.RandomState(7)
    return [((np.arange(w)[None, :] * 3 + np.arange(h)[:, None] * 5
              + t * 17) % 254 + rng.randint(0, 2, (h, w)))
            .astype(np.int32) for t in range(n)]


def _launch_counts():
    from ..gpu import block_decode_cuda, block_encode_cuda, block_refine_cuda
    return {**block_decode_cuda.LAUNCHES, **block_refine_cuda.LAUNCHES,
            **block_encode_cuda.LAUNCHES}


def _reset_launches():
    from ..gpu import block_decode_cuda, block_encode_cuda, block_refine_cuda
    for m in (block_decode_cuda, block_refine_cuda, block_encode_cuda):
        m.reset_launches()


def _worker_main(argv=None) -> int:
    """Worker of a multi-process launch (and its self-check), one
    process per rank:

    python -m openjph_tpu_torch.parallel.multihost --coordinator H:P \\
        --num-processes N --process-id K [--frames F] [--size WxH] \\
        [--npy FRAME.npy] [--device cuda|cpu] [--backend gloo] \\
        [--out DIR]

    Every process makes the same F frames: seeded_frames(F, W, H), or
    with ``--npy`` that frame rolled 37*k columns for frame k.  It
    encodes them and decodes the codestreams spread across the N
    processes (encode_frames, decode_frames, lossless 5/3, 2 levels for
    the seeded frames, 5 for --npy), and holds the gathered bursts to
    the single-process encode_gpu_batch (byte-identical), to
    decode_gpu_batch (bit-exact) and to the frames.  ``--out`` writes
    the gathered codestreams to DIR/frame<k>.j2c (process 0).  Prints
    one line starting 'multihost OK' with the kernel launches of the
    spread coding (the single-process references excluded)."""
    import argparse
    import json
    import os

    from ..gpu.encode_pipeline import encode_gpu_batch
    from ..gpu.pipeline import decode_gpu_batch, resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--coordinator', required=True)
    ap.add_argument('--num-processes', type=int, required=True)
    ap.add_argument('--process-id', type=int, required=True)
    ap.add_argument('--frames', type=int, default=4)
    ap.add_argument('--size', default='96x64')
    ap.add_argument('--npy')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--backend', default='gloo')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.npy:
        src = np.load(args.npy).astype(np.int32)
        frames = [np.roll(src, 37 * t, axis=1) for t in range(args.frames)]
        kw = dict(reversible=True)
    else:
        w, h = (int(v) for v in args.size.split('x'))
        frames = seeded_frames(args.frames, w, h)
        kw = dict(reversible=True, num_decomps=2)
    init(args.coordinator, args.num_processes, args.process_id,
         args.backend)
    try:
        ref_streams = encode_gpu_batch(frames, device=dev, **kw)
        ref_planes = decode_gpu_batch(ref_streams, device=dev)
        _reset_launches()
        streams = encode_frames(frames, device=dev, **kw)
        planes = decode_frames(ref_streams, device=dev)
        launches = _launch_counts()
        for t, f in enumerate(frames):
            if streams[t] != ref_streams[t]:
                raise AssertionError(f'frame {t}: the spread encode is '
                                     f'not byte-identical')
            if planes[t] is None or not all(
                    np.array_equal(a, b)
                    for a, b in zip(planes[t], ref_planes[t])):
                raise AssertionError(f'frame {t}: the spread decode '
                                     f'differs from decode_gpu_batch')
            if not np.array_equal(planes[t][0], f):
                raise AssertionError(f'frame {t}: the decode differs from '
                                     f'the frame')
        if args.out and args.process_id == 0:
            for t, s in enumerate(streams):
                with open(os.path.join(args.out, f'frame{t}.j2c'),
                          'wb') as fh:
                    fh.write(s)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print('multihost OK ' + json.dumps({
        'process': args.process_id, 'processes': args.num_processes,
        'frames': len(frames), 'shape': list(frames[0].shape),
        'device': str(dev), 'backend': args.backend,
        'launches': launches}), flush=True)
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(_worker_main())
