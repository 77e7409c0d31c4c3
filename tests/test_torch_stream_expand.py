"""The port's RTP receiver (openjph_tpu_torch.apps.stream_expand) against
the JAX package's: packet fields, the reorder window, frame assembly and
lost-packet counting on the same packets, and loopback UDP runs that
store the sent codestreams and decode them (on the CPU) to .ppm frames
equal to openjph_tpu.decode's.  Each loopback run binds a port chosen
free at run time and joins its receiver with a timeout."""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from openjph_tpu import decode, encode
from openjph_tpu.apps import stream_expand as jax_se
from openjph_tpu_torch.apps import stream_expand as port_se
from openjph_tpu_torch.apps.stream_expand import (FrameWriter, RtpPacket,
                                                  main, serve)
from openjph_tpu_torch.gpu.pipeline import decode_gpu
from openjph_tpu_torch.utils.imageio import read_pnm


def _make_packet(seq, ts, payload, main=False, marked=False, pos=0):
    hdr = bytearray(20)
    hdr[0] = 0x80  # v2
    hdr[1] = (0x80 if marked else 0) | 96
    struct.pack_into('>H', hdr, 2, seq & 0xFFFF)
    struct.pack_into('>I', hdr, 4, ts)
    struct.pack_into('>I', hdr, 8, 0x1234)
    hdr[12] = (RtpPacket.PT_MAIN_FOLLOWED_BY_BODY if main
               else RtpPacket.PT_BODY) << 6
    hdr[15] = (seq >> 16) & 0xFF
    if not main:
        hdr[16] = (pos >> 4) & 0xFF
        hdr[17] = (pos & 0xF) << 4
    return bytes(hdr) + payload


def _packetize(stream: bytes, ts: int, seq0: int, mtu=1000):
    pkts = []
    seq = seq0
    chunks = [stream[i:i + mtu] for i in range(0, len(stream), mtu)]
    for i, ch in enumerate(chunks):
        last = i == len(chunks) - 1
        pkts.append(_make_packet(seq, ts, ch, main=(i == 0),
                                 marked=last, pos=i))
        seq += 1
    return pkts, seq


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def streams():
    rng = np.random.RandomState(11)
    imgs = [rng.randint(0, 256, size=(48, 48)).astype(np.int32)
            for _ in range(3)]
    return imgs, [encode(im, reversible=True, num_decomps=2) for im in imgs]


@pytest.mark.parametrize('seq,ts,main_pkt,marked',
                         [(0x1F234, 777, True, True), (5, 0, False, False),
                          (0xFFFFFF, 0xFFFFFFFF, False, True)])
def test_rtp_fields(seq, ts, main_pkt, marked):
    data = _make_packet(seq, ts, b'xyz', main=main_pkt, marked=marked,
                        pos=7)
    p, q = RtpPacket(data), jax_se.RtpPacket(data)
    for f in ('seq_num', 'time_stamp', 'is_marked', 'packet_type',
              'payload', 'data_pos', 'ssrc', 'payload_type'):
        assert getattr(p, f) == getattr(q, f), f
    assert p.valid() and p.seq_num == seq and p.time_stamp == ts
    assert p.is_marked == marked and p.payload == b'xyz'


def _assemble(mod, pkts, order, window, drop=()):
    got = {}
    frames = mod.FramesHandler(4, lambda ts, d: got.__setitem__(ts, d))
    ph = mod.PacketsHandler(window, frames)
    for i in order:
        if i not in drop:
            ph.push(mod.RtpPacket(pkts[i]))
    ph.flush()
    return got, ph, frames


def test_reorder_and_assemble(streams, rng):
    imgs, sts = streams
    pkts, _ = _packetize(sts[0], ts=42, seq0=100, mtu=256)
    order = list(range(len(pkts)))
    rng.shuffle(order)
    got, ph, _ = _assemble(port_se, pkts, order, 8)
    ref, _, _ = _assemble(jax_se, pkts, order, 8)
    assert got == ref and got[42] == sts[0]
    assert ph.get_num_lost_packets() == 0
    assert np.array_equal(decode_gpu(got[42], device='cpu')[0], imgs[0])


def test_lost_packet_counting(streams):
    _, sts = streams
    pkts, _ = _packetize(sts[1], ts=1, seq0=0, mtu=200)
    assert len(pkts) >= 4
    order = range(len(pkts))
    got, ph, frames = _assemble(port_se, pkts, order, 3, drop={1})
    ref, jph, jframes = _assemble(jax_se, pkts, order, 3, drop={1})
    assert got == ref
    assert ph.get_num_lost_packets() == jph.get_num_lost_packets() >= 1
    assert frames.get_stats() == jframes.get_stats()


def _loopback(tmp_path, packets, target, nframes, **kw):
    """Run serve() on a free loopback port, send ``packets``, and return
    its (packets, frames) handlers; fails if the receiver is still alive
    after 20 s."""
    port = _free_port()
    result = {}

    def rx():
        result['out'] = serve('127.0.0.1', port, num_threads=2,
                              num_packets=5, quiet=True, target=target,
                              max_frames=nframes, device='cpu', **kw)

    t = threading.Thread(target=rx, daemon=True)
    t.start()
    time.sleep(0.3)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for p in packets:
            tx.sendto(p, ('127.0.0.1', port))
            time.sleep(0.002)
    t.join(timeout=20)
    assert not t.is_alive()
    return result['out']


def _send_all(sts, mtu=600):
    out, seq = [], 0
    for k, s in enumerate(sts):
        pkts, seq = _packetize(s, ts=1000 + k, seq0=seq, mtu=mtu)
        out += pkts
    return out


def test_udp_end_to_end_j2c(tmp_path, streams):
    _, sts = streams
    _, frames = _loopback(tmp_path, _send_all(sts),
                          str(tmp_path / 'frame_%03d'), len(sts))
    assert frames.total_frames == len(sts)
    for i, s in enumerate(sts):
        with open(str(tmp_path / ('frame_%03d' % i)) + '.j2c', 'rb') as f:
            assert f.read() == s


def test_udp_end_to_end_ppm(tmp_path, streams):
    imgs, sts = streams
    _, frames = _loopback(tmp_path, _send_all(sts),
                          str(tmp_path / 'frame_%03d.ppm'), len(sts))
    assert frames.total_frames == len(sts)
    for i, s in enumerate(sts):
        got = read_pnm(str(tmp_path / ('frame_%03d.ppm' % i)))
        assert np.array_equal(got.astype(np.int32), decode(s)[0])
        assert np.array_equal(got.astype(np.int32), imgs[i])


def test_udp_dropped_body_packet_resilient(tmp_path, streams):
    """One body packet lost: the frame, received with resilient=True,
    renders full-size and equal to the resilient decode of the bytes the
    receiver assembled (JAX package and port alike)."""
    _, sts = streams
    # the reorder window (5 packets) gives up on the gap once 5 packets
    # that follow it have arrived
    mtu, drop = 100, 3
    pkts, _ = _packetize(sts[2], ts=7, seq0=0, mtu=mtu)
    assert len(pkts) >= drop + 6
    packets, frames = _loopback(tmp_path, pkts[:drop] + pkts[drop + 1:],
                                str(tmp_path / 'lossy_%03d.ppm'), 1,
                                resilient=True)
    assert frames.total_frames == 1 and packets.get_num_lost_packets() == 1
    sent = sts[2][:drop * mtu] + sts[2][(drop + 1) * mtu:]
    want = decode_gpu(sent, device='cpu', resilient=True)[0]
    assert np.array_equal(want, decode(sent, resilient=True)[0])
    got = read_pnm(str(tmp_path / 'lossy_000.ppm'))
    assert got.shape == (48, 48)
    assert np.array_equal(got.astype(np.int32),
                          want.astype(np.uint8).astype(np.int32))


def test_decoding_receiver_needs_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        FrameWriter(str(tmp_path / 'f_%03d.ppm'), 1, True)
    assert main(['-addr', '127.0.0.1', '-port', str(_free_port()),
                 '-o', str(tmp_path / 'f_%03d.ppm')]) == 1
    assert 'CUDA is not available' in capsys.readouterr().err
    # storing codestreams decodes nothing and needs no card
    FrameWriter(str(tmp_path / 'f_%03d'), 1, True).close()
