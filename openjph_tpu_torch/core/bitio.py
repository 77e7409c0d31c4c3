"""Packet-header bit output with JPEG 2000 byte stuffing.

Bits are MSB-first within bytes; after emitting a 0xFF byte only 7 bits
are available in the following byte (the MSB is a stuffed 0).  Mirrors
ojph_bitbuffer_write.h:55-146; the read side is the native walker's
(native/ojtpu_native.cpp).
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
