"""Sign-magnitude -> subband samples (gen_rev/irv_tx_from_cb32,
ojph_codestream_gen.cpp:124-168), as torch ops.

Codeblock samples travel as int32 tensors holding the uint32 bit
pattern: bit 31 is the sign, the magnitude sits below it.
"""
from __future__ import annotations

import torch


def tx_from_cb(raw: torch.Tensor, kmax: int, delta: float,
               reversible: bool) -> torch.Tensor:
    """Reversible: int32 samples ``mag >> (31 - kmax)``; irreversible:
    float32 samples ``mag * delta``; both negated where bit 31 is set."""
    mag = raw & 0x7FFFFFFF
    neg = raw < 0
    if reversible:
        val = mag >> (31 - kmax)
        return torch.where(neg, -val, val)
    val = mag.to(torch.float32) * torch.tensor(delta, dtype=torch.float32)
    return torch.where(neg, -val, val)
