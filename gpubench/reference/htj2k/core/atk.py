"""Part-2 ATK (arbitrary transformation kernel) marker support.

An ATK marker segment (ITU-T T.801 A.3.6) defines a custom wavelet as a
sequence of first-order lifting steps.  This module holds the typed
kernel description, its wire format (mirroring what the reference
parser accepts: param_atk::read, ojph_params.cpp:2770-2866), and the
two hardwired Part-1 kernels (init_irv97/init_rev53,
ojph_params.cpp:2870-2896).

Supported subset — the same one the reference supports:
 - whole-sample symmetric (WS) filters only (Satk bit 0x800 set)
 - one coefficient per step (LCatk == 1, first-order lifting)
 - even-indexed first reconstruction subsequence (m_init == 0)
 - symmetric boundary extension (Satk bit 0x4000 set)

A reversible step holds (a, b, e) and updates samples as
``x += (b + a*(s0+s1)) >> e`` during analysis (gen_rev_vert_step32,
ojph_transform.cpp:209-257); an irreversible step holds a float ``a``
and updates ``x += a*(s0+s1)``, with the scaling factor K applied to
the phase planes after all steps.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union

from .message import error as _err


@dataclass(frozen=True)
class AtkKernel:
    """One wavelet kernel: lifting steps in ATK storage order.

    Steps are stored as the ATK marker stores them: step 0 is applied
    LAST during analysis (the engines iterate from step Natk-1 down to
    0 for analysis and 0 up for synthesis; gen_rev_horz_ana,
    ojph_transform.cpp:363-404).

    ``steps`` entries are (a, b, e) int tuples for reversible kernels
    and plain floats for irreversible ones.
    """
    index: int                  # kernel index (COD wavelet_trans byte)
    reversible: bool
    steps: Tuple = ()
    K: float = 1.0              # irreversible scaling factor
    coeff_type: int = 0         # Satk bits 8-10; see read_coefficient

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def satk(self) -> int:
        # whole-sample (0x800) + symmetric extension (0x4000) always;
        # reversible flag 0x1000; m_init == 0 (bit 0x2000 clear)
        s = 0x4800 | (self.index & 0xFF) | ((self.coeff_type & 0x7) << 8)
        if self.reversible:
            s |= 0x1000
        return s

    # -- wire format -------------------------------------------------------

    def _coeff_bytes_irv(self, a: float) -> bytes:
        t = self.coeff_type
        if t == 2:
            return struct.pack('>f', a)
        if t == 3:
            return struct.pack('>d', a)
        _err(0x000500E5, f'unsupported irreversible ATK coeff type {t} '
             '(use 2=float or 3=double for writing)')

    def _coeff_bytes_rev(self, a: int) -> bytes:
        t = self.coeff_type
        if t == 0:
            if not -128 <= a <= 127:
                _err(0x000500EB, f'ATK coeff type 0 (8-bit) cannot hold '
                     f'a={a}')
            return struct.pack('>b', a)
        if t == 1:
            return struct.pack('>h', a)
        _err(0x000500E5, 'reversible ATK requires coeff type 0 or 1 '
             '(floats with reversible filtering make no sense)')

    def to_bytes(self) -> bytes:
        """Serialize the full marker segment (with the 0xFF79 marker),
        in the layout param_atk::read expects."""
        if not 2 <= self.index <= 255:
            _err(0x000500F3, f'ATK-Satk sets the ATK marker index to the '
                 f'illegal value of {self.index}; it should be in 2..255 '
                 '(0/1 are the hardwired 9/7 and 5/3)')
        body = struct.pack('>H', self.satk)
        if not self.reversible:
            body += self._coeff_bytes_irv(self.K)
        body += struct.pack('>B', self.num_steps)
        for s in self.steps:
            if self.reversible:
                a, b, e = s
                body += struct.pack('>BhB', e, b, 1) \
                    + self._coeff_bytes_rev(a)
            else:
                body += struct.pack('>B', 1) + self._coeff_bytes_irv(s)
        return struct.pack('>HH', 0xFF79, len(body) + 2) + body

    @classmethod
    def from_bytes(cls, body: bytes) -> 'AtkKernel':
        """Parse a marker body (excluding marker/Latk), mirroring
        param_atk::read (ojph_params.cpp:2770-2866)."""
        satk = struct.unpack_from('>H', body, 0)[0]
        o = 2
        index = satk & 0xFF
        coeff_type = (satk >> 8) & 0x7
        reversible = (satk & 0x1000) != 0
        if index in (0, 1):
            _err(0x000500F3, f'ATK-Satk parameter sets ATK marker index '
                 f'to the illegal value of {index}; it should be in '
                 '2-255 (0/1 are the hardwired 9/7 and 5/3 kernels)')
        if (satk & 0x2000) != 0:
            _err(0x000500E3, 'ATK-Satk m_init=1 (odd-indexed first '
                 'reconstruction step) is not supported')
        if (satk & 0x800) == 0:
            _err(0x000500E4, 'ATK-Satk specified an ARB (arbitrary) '
                 'filter, which is not supported; only whole-sample '
                 'symmetric')
        if reversible and coeff_type >= 2:
            _err(0x000500E5, 'ATK-Satk does not make sense: it employs '
                 'floats with reversible filtering')
        if (satk & 0x4000) == 0:
            _err(0x000500E6, 'ATK-Satk requires constant boundary '
                 'extension, which is not supported; only '
                 'whole-sample symmetric')

        def read_coeff(o: int) -> Tuple[Union[int, float], int]:
            if reversible:
                if coeff_type == 0:
                    return struct.unpack_from('>b', body, o)[0], o + 1
                return struct.unpack_from('>h', body, o)[0], o + 2
            if coeff_type == 0:
                return float(body[o]), o + 1
            if coeff_type == 1:
                return float(struct.unpack_from('>H', body, o)[0]), o + 2
            if coeff_type == 2:
                return struct.unpack_from('>f', body, o)[0], o + 4
            if coeff_type == 3:
                return float(struct.unpack_from('>d', body, o)[0]), o + 8
            if coeff_type == 4:
                # 128-bit float: convert the top 64 bits to float32
                # (param_atk::read_coefficient, ojph_params.cpp:2715-2744)
                v = struct.unpack_from('>Q', body, o)[0]
                e = ((v >> 48) & 0x7FFF) - 16383 + 127
                i = ((v >> 32) & 0x80000000) | ((e & 0xFF) << 23) \
                    | ((v >> 25) & 0x007FFFFF)
                return struct.unpack('>f', struct.pack('>I', i))[0], o + 16
            _err(0x000500E5, f'unknown ATK coefficient type {coeff_type}')

        K = 1.0
        if not reversible:
            K, o = read_coeff(o)
        natk = body[o]
        o += 1
        steps: List = []
        for _ in range(natk):
            if reversible:
                e, b, lc = struct.unpack_from('>BhB', body, o)
                o += 4
                if lc != 1:
                    _err(0x000500ED, 'ATK-LCatk value greater than 1 '
                         '(a multi-tap filter) is not supported')
                a, o = read_coeff(o)
                steps.append((a, b, e))
            else:
                lc = body[o]
                o += 1
                if lc != 1:
                    _err(0x000500F1, 'ATK-LCatk value greater than 1 '
                         '(a multi-tap filter) is not supported')
                a, o = read_coeff(o)
                steps.append(float(a))
        if o != len(body):
            _err(0x000500F3, 'the length of the ATK marker segment '
                 '(ATK-Latk) is not correct')
        return cls(index, reversible, tuple(steps), float(K), coeff_type)


# Hardwired Part-1 kernels (ojph_params.cpp:2870-2896).  Step order is
# the ATK storage order: analysis applies steps Natk-1 .. 0.
ATK_IRV97 = AtkKernel(
    index=0, reversible=False,
    steps=(0.443506852043971, 0.882911075530934,
           -0.052980118572961, -1.586134342059924),
    K=1.230174104914001, coeff_type=2)

ATK_REV53 = AtkKernel(
    index=1, reversible=True,
    steps=((1, 2, 2), (-1, 1, 1)), coeff_type=0)


def builtin_kernel(wavelet_kern: int) -> AtkKernel:
    """Kernel for a COD wavelet_trans byte of 0 or 1."""
    if wavelet_kern == 0:
        return ATK_IRV97
    if wavelet_kern == 1:
        return ATK_REV53
    raise KeyError(wavelet_kern)
