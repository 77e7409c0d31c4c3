"""ojph_stream_expand-compatible RTP/UDP HTJ2K video receiver on the GPU.

Receives RTP packets per RFC 3550 + draft-ietf-avtcore-rtp-j2k-scl
(payload header layout from OpenJPH's
src/apps/ojph_stream_expand/stream_expand_support.h:78-211),
reorders them in an in-flight window (packets_handler, :247+),
assembles frames by RTP timestamp (frames_handler, :428+) and hands
complete frames to a worker pool that stores `.j2c` files or decodes
them on the card to `.ppm` (threaded_frame_processors).  A copy of the
JAX package's openjph_tpu/apps/stream_expand.py whose workers decode
with decode_gpu, with no host fallback: a frame that fails to decode
(no card, a damaged frame in strict mode) is reported and written
nowhere.

Flags mirror the reference CLI: -addr -port -src_addr -src_port
-num_threads -num_packets -recv_buf_size -blocking -quiet -o, and
-max_frames -resilient.
"""
from __future__ import annotations

import socket
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..gpu.pipeline import decode_gpu, resolve_device
from ..utils.imageio import write_pnm


class RtpPacket:
    """Accessors over one RTP packet (stream_expand_support.h:78-211)."""

    PT_BODY = 0
    PT_MAIN_FOLLOWED_BY_MAIN = 1
    PT_MAIN_FOLLOWED_BY_BODY = 2
    PT_MAIN = 3

    MAX_SIZE = 2048

    def __init__(self, data: bytes):
        self.data = data

    @property
    def rtp_version(self):
        return self.data[0] >> 6

    @property
    def is_marked(self):
        return (self.data[1] & 0x80) != 0

    @property
    def payload_type(self):
        return self.data[1] & 0x7F

    @property
    def seq_num(self):
        base = struct.unpack_from('>H', self.data, 2)[0]
        return base | (self.data[15] << 16)  # ESEQ extension

    @property
    def time_stamp(self):
        return struct.unpack_from('>I', self.data, 4)[0]

    @property
    def ssrc(self):
        return struct.unpack_from('>I', self.data, 8)[0]

    @property
    def packet_type(self):
        return self.data[12] >> 6

    @property
    def payload(self):
        return self.data[20:]

    @property
    def data_pos(self):
        if self.packet_type == self.PT_BODY:
            return (self.data[16] << 4) | ((self.data[17] >> 4) & 0xF)
        return 0

    def valid(self):
        return len(self.data) > 20 and self.rtp_version == 2


@dataclass
class _Frame:
    time_stamp: int
    chunks: Dict[int, bytes] = field(default_factory=dict)
    main_bytes: bytes = b''
    done: bool = False


class FramesHandler:
    """Assembles packets into frames keyed by RTP timestamp
    (frames_handler, stream_expand_support.h:428+)."""

    def __init__(self, num_inflight_frames: int,
                 on_frame: Callable[[int, bytes], None]):
        self.frames: Dict[int, _Frame] = {}
        self.order: List[int] = []
        self.max_frames = num_inflight_frames
        self.on_frame = on_frame
        self.total_frames = 0
        self.trunc_frames = 0
        self.lost_frames = 0

    def push(self, p: RtpPacket):
        ts = p.time_stamp
        f = self.frames.get(ts)
        if f is None:
            f = _Frame(ts)
            self.frames[ts] = f
            self.order.append(ts)
            while len(self.order) > self.max_frames:
                self._retire(self.order.pop(0))
        if p.packet_type == RtpPacket.PT_BODY:
            f.chunks[p.seq_num] = p.payload
        else:
            f.main_bytes += p.payload
        if p.is_marked:
            f.done = True
            if ts in self.order:
                self.order.remove(ts)
            self._retire(ts)

    def _retire(self, ts: int):
        f = self.frames.pop(ts, None)
        if f is None:
            return
        self.total_frames += 1
        data = f.main_bytes + b''.join(
            f.chunks[k] for k in sorted(f.chunks))
        if not f.done:
            if data:
                self.trunc_frames += 1
            else:
                self.lost_frames += 1
                return
        self.on_frame(ts, data)

    def flush(self):
        for ts in list(self.order):
            self._retire(ts)
        self.order.clear()

    def get_stats(self):
        return (self.total_frames, self.trunc_frames, self.lost_frames)


class PacketsHandler:
    """Sequence-number reorder window (packets_handler,
    stream_expand_support.h:247-341): out-of-order packets wait in a
    bounded buffer; when it fills, the oldest packet is pushed and the
    gap is counted as lost."""

    def __init__(self, num_packets: int, frames: FramesHandler):
        self.window: Dict[int, RtpPacket] = {}
        self.num_packets = max(1, num_packets)
        self.frames = frames
        self.last_seq = None
        self.lost_packets = 0

    def push(self, p: RtpPacket):
        seq = p.seq_num
        if self.last_seq is not None and seq <= self.last_seq:
            return  # duplicate or too late
        self.window[seq] = p
        self._drain()

    def _drain(self):
        # push consecutive packets; when the window overflows, give up
        # on the gap (count it lost) and advance.  Until the first
        # consume, packets only accumulate (the initial arrivals may be
        # out of order).
        while self.window:
            if self.last_seq is None:
                if len(self.window) < self.num_packets:
                    break
                oldest = min(self.window)
                self.frames.push(self.window.pop(oldest))
                self.last_seq = oldest
                continue
            nxt = self.last_seq + 1
            if nxt in self.window:
                self.frames.push(self.window.pop(nxt))
                self.last_seq = nxt
            elif len(self.window) >= self.num_packets:
                oldest = min(self.window)
                self.lost_packets += oldest - nxt
                self.frames.push(self.window.pop(oldest))
                self.last_seq = oldest
            else:
                break

    def flush(self):
        for seq in sorted(self.window):
            self.frames.push(self.window.pop(seq))
        self.frames.flush()

    def get_num_lost_packets(self):
        return self.lost_packets


class FrameWriter:
    """Worker-pool frame sink: stores .j2c or decodes to .ppm
    (j2k_frame_storer / j2k_frame_renderer in
    threaded_frame_processors.h); frames decode on ``device``."""

    def __init__(self, target: Optional[str], num_threads: int,
                 quiet: bool, resilient: bool = False, device='cuda'):
        self.target = target
        self.quiet = quiet
        self.count = 0
        self.decode = bool(target) and target.endswith('.ppm')
        # a decoding writer needs its device now: no card, no receiver
        self.device = resolve_device(device) if self.decode else device
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_threads))
        # lossy transport pairs with resilient decode: frames with
        # missing packets render with broken blocks zeroed instead of
        # being dropped (enable_resilience,
        # ojph_codestream_local.cpp:903)
        self.resilient = resilient

    def __call__(self, ts: int, data: bytes):
        idx = self.count
        self.count += 1
        if not self.target:
            return
        self.pool.submit(self._store, idx, ts, data)

    def _store(self, idx: int, ts: int, data: bytes):
        try:
            name = self.target % idx if '%' in self.target \
                else f'{self.target}_{idx:05d}'
            if self.decode or name.endswith('.ppm'):
                planes = decode_gpu(data, device=self.device,
                                    resilient=self.resilient)
                img = np.stack(planes, axis=-1).astype(np.uint8) \
                    if len(planes) >= 3 else planes[0].astype(np.uint8)
                write_pnm(name if name.endswith('.ppm')
                          else name + '.ppm', img)
            else:
                if not name.endswith('.j2c'):
                    name += '.j2c'
                with open(name, 'wb') as f:
                    f.write(data)
            if not self.quiet:
                print(f'frame {idx} (ts {ts}): {len(data)} bytes')
        except Exception as e:  # worker threads must not die silently
            print(f'frame {idx}: {e}', file=sys.stderr)

    def close(self):
        self.pool.shutdown(wait=True)


def serve(addr: str, port: int, src_addr: Optional[str] = None,
          src_port: Optional[int] = None, num_threads: int = 2,
          num_packets: int = 5, recv_buf_size: int = 65536,
          blocking: bool = False, quiet: bool = False,
          target: Optional[str] = None,
          max_frames: Optional[int] = None,
          resilient: bool = False, device='cuda'):
    """Receive loop; returns (packets_handler, frames_handler) stats
    after max_frames frames (or forever when None).  Frames written as
    ``.ppm`` decode on ``device``."""
    writer = FrameWriter(target, num_threads, quiet, resilient, device)
    frames = FramesHandler(num_threads + 1, writer)
    packets = PacketsHandler(num_packets, frames)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buf_size)
    sock.bind((addr, port))
    sock.settimeout(None if blocking else 1.0)
    try:
        while max_frames is None or frames.total_frames < max_frames:
            try:
                data, src = sock.recvfrom(RtpPacket.MAX_SIZE)
            except socket.timeout:
                continue
            if src_addr and src[0] != src_addr:
                continue
            if src_port and src[1] != src_port:
                continue
            p = RtpPacket(data)
            if p.valid():
                packets.push(p)
    finally:
        packets.flush()
        writer.close()
        sock.close()
    return packets, frames


def main(argv=None, device='cuda') -> int:
    """Run the receiver on ``argv`` (default: the command line); frames
    written as ``.ppm`` decode on ``device`` (the card from the command
    line).  Returns the exit code."""
    from .cli import ArgError, Args
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ('-h', '--help'):
        print(__doc__)
        return 0
    try:
        args = Args(argv)
        addr = args.get('-addr')
        port = args.get_int('-port')
        if addr is None or port is None:
            raise ArgError('-addr and -port are required')
        packets, frames = serve(
            addr, port,
            src_addr=args.get('-src_addr'),
            src_port=args.get_int('-src_port'),
            num_threads=args.get_int('-num_threads', 2),
            num_packets=args.get_int('-num_packets', 5),
            recv_buf_size=args.get_int('-recv_buf_size', 65536),
            blocking=args.get_bool('-blocking', False),
            quiet=args.get_bool('-quiet', False),
            target=args.get('-o'),
            max_frames=args.get_int('-max_frames'),
            resilient=args.get_bool('-resilient', False), device=device)
        total, trunc, lost = frames.get_stats()
        print(f'frames: {total} total, {trunc} truncated, {lost} lost; '
              f'{packets.get_num_lost_packets()} packets lost')
        return 0
    except (ArgError, OSError, RuntimeError) as e:
        print(f'ojph-gpu-stream-expand: {e}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
