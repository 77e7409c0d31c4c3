"""Subband samples <-> sign-magnitude codeblock samples
(gen_rev/irv_tx_to_cb32/64 and tx_from_cb32/64,
ojph_codestream_gen.cpp:59-168; the JAX package's codec.py:68-107), as
torch ops.

Codeblock samples travel as int32 tensors holding the uint32 bit
pattern: bit 31 is the sign, the magnitude sits below it.  A reversible
band of kmax >= 31 uses the 64-bit forms: int64 tensors holding the
uint64 pattern, the sign in bit 63 (set with ``| INT64_MIN``) and the
magnitude shifted by 63 - kmax, always below bit 63.
"""
from __future__ import annotations

import torch

from .block_decode import INT64_MIN, to_i32_bits


def tx_from_cb(raw: torch.Tensor, kmax: int, delta: float,
               reversible: bool) -> torch.Tensor:
    """Reversible: int32 samples ``mag >> (31 - kmax)``; irreversible:
    float32 samples ``mag * delta``; both negated where bit 31 is set.
    Reversible with kmax >= 31: ``raw`` int64 patterns, int64 samples
    ``mag >> (63 - kmax)``, negated where bit 63 is set."""
    if reversible and kmax >= 31:
        val = (raw & ~INT64_MIN) >> (63 - kmax)
        return torch.where(raw < 0, -val, val)
    mag = raw & 0x7FFFFFFF
    neg = raw < 0
    if reversible:
        val = mag >> (31 - kmax)
        return torch.where(neg, -val, val)
    val = mag.to(torch.float32) * torch.tensor(delta, dtype=torch.float32)
    return torch.where(neg, -val, val)


def tx_to_cb(plane: torch.Tensor, kmax: int, delta: float,
             reversible: bool):
    """Subband samples -> (int32 sign-magnitude bit patterns, int64
    magnitudes).  Reversible: the magnitude of the sample shifted to
    ``31 - kmax``, wrapping in uint32 as the reference's C does;
    irreversible: ``trunc(x * float32(1 / delta))`` unshifted.
    Reversible with kmax >= 31: int64 patterns, the magnitude shifted to
    ``63 - kmax`` (wrapping in uint64) and the sign in bit 63."""
    if reversible and kmax >= 31:
        p = plane.to(torch.int64)
        mag = p.abs() << (63 - kmax)
        return torch.where(p < 0, mag | INT64_MIN, mag), mag
    if reversible:
        p = plane.to(torch.int64)
        neg = p < 0
        mag = (p.abs() << (31 - kmax)) & 0xFFFFFFFF
    else:
        t = torch.trunc(plane.to(torch.float32)
                        * torch.tensor(1.0 / delta, dtype=torch.float32)) \
            .to(torch.int32)
        neg = t < 0
        mag = t.to(torch.int64).abs()
    return to_i32_bits(mag | (neg.to(torch.int64) << 31)), mag
