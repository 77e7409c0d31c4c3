"""Packet-header bit I/O with JPEG 2000 byte stuffing.

Bits are MSB-first within bytes; after emitting a 0xFF byte only 7 bits
are available in the following byte (the MSB is a stuffed 0).  Mirrors
ojph_bitbuffer_write.h:55-146 / ojph_bitbuffer_read.h:57-226.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.avail_bits = 8
        self.tmp = 0

    def put_bit(self, bit: int) -> None:
        self.avail_bits -= 1
        self.tmp |= (bit & 1) << self.avail_bits
        if self.avail_bits <= 0:
            self.avail_bits = 8 - (1 if self.tmp == 0xFF else 0)
            self.out.append(self.tmp & 0xFF)
            self.tmp = 0

    def put_bits(self, data: int, num_bits: int) -> None:
        for i in range(num_bits - 1, -1, -1):
            self.put_bit((data >> i) & 1)

    def terminate(self) -> None:
        """Flush a partial byte (bb_terminate, write side)."""
        if self.avail_bits < 8:
            self.out.append(self.tmp & 0xFF)
            self.tmp = 0
            self.avail_bits = 8


class BitReader:
    """Reads from a memoryview/bytes with byte-unstuffing."""

    def __init__(self, buf, pos: int, bytes_left: int):
        self.buf = buf
        self.pos = pos
        self.bytes_left = bytes_left
        self.tmp = 0
        self.avail_bits = 0
        self.unstuff = False

    def _read(self) -> bool:
        if self.bytes_left > 0:
            t = self.buf[self.pos]
            self.pos += 1
            self.tmp = t
            self.avail_bits = 8 - (1 if self.unstuff else 0)
            self.unstuff = (t == 0xFF)
            self.bytes_left -= 1
            return True
        self.tmp = 0
        self.avail_bits = 8 - (1 if self.unstuff else 0)
        self.unstuff = False
        return False

    def read_bit(self) -> int:
        if self.avail_bits == 0:
            if not self._read():
                raise EOFError('packet header truncated')
        self.avail_bits -= 1
        return (self.tmp >> self.avail_bits) & 1

    def read_bits(self, num_bits: int) -> int:
        bits = 0
        while num_bits:
            if self.avail_bits == 0:
                if not self._read():
                    raise EOFError('packet header truncated')
            tx = min(self.avail_bits, num_bits)
            bits <<= tx
            self.avail_bits -= tx
            num_bits -= tx
            bits |= (self.tmp >> self.avail_bits) & ((1 << tx) - 1)
        return bits

    def terminate(self, uses_eph: bool) -> None:
        """Skip stuffing byte and optional EPH (bb_terminate, read side)."""
        if self.unstuff:
            self._read()
        self.tmp = 0
        self.avail_bits = 0
        if uses_eph:
            if self.bytes_left >= 2:
                m0, m1 = self.buf[self.pos], self.buf[self.pos + 1]
                self.pos += 2
                self.bytes_left -= 2
                if m0 != 0xFF or m1 != 0x92:
                    raise ValueError('expected EPH marker')

    def skip_sop(self) -> None:
        if self.bytes_left >= 2:
            if self.buf[self.pos] == 0xFF and self.buf[self.pos + 1] == 0x91:
                self.pos += 2
                self.bytes_left -= 2
                if self.bytes_left >= 4:
                    ln = (self.buf[self.pos] << 8) | self.buf[self.pos + 1]
                    if ln != 4:
                        raise ValueError('wrong SOP length')
                    self.pos += ln - 2 + 2
                    self.bytes_left -= ln + 2 - 2
                    # consume Lsop (2) + Nsop (2): total ln+2 bytes incl marker
                else:
                    raise EOFError('precinct truncated early')
