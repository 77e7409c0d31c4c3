"""Colour transforms and sample conversions as torch ops, both
directions (ojph_colour.cpp:220-568; the JAX package's tpu/color.py).

Reversible planes are int32 (int64 above 28 bits, and in the RCT of
such a frame), irreversible planes float32; every
constant is a float32 scalar and the order of operations is the JAX
package's.  Each multiply and add is its own torch op, so it rounds on
its own on every device (no fused multiply-add), and the forward ICT
gives the same bits on the card as on the CPU.
"""
from __future__ import annotations

import torch

ALPHA_R = 0.299
ALPHA_G = 0.587
ALPHA_B = 0.114
BETA_CB = 0.5 / (1 - 0.114)
BETA_CR = 0.5 / (1 - 0.299)
GAMMA_CB2G = 2.0 * 0.114 * (1.0 - 0.114) / 0.587
GAMMA_CR2G = 2.0 * 0.299 * (1.0 - 0.299) / 0.587
GAMMA_CB2B = 2.0 * (1.0 - 0.114)
GAMMA_CR2R = 2.0 * (1.0 - 0.299)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def rct_forward(r, g, b):
    """Reversible colour transform (gen_rct_forward,
    ojph_colour.cpp:443-490)."""
    y = (r + (g << 1) + b) >> 2
    cb = b - g
    cr = r - g
    return y, cb, cr


def ict_forward(r, g, b):
    """Irreversible colour transform (gen_ict_forward,
    ojph_colour.cpp:545-556); float32."""
    y = (_f32(ALPHA_R) * r + _f32(ALPHA_G) * g + _f32(ALPHA_B) * b)
    cb = _f32(BETA_CB) * (b - y)
    cr = _f32(BETA_CR) * (r - y)
    return y, cb, cr


def rct_backward(y, cb, cr):
    """Inverse reversible colour transform (gen_rct_backward)."""
    g = y - ((cb + cr) >> 2)
    r = cr + g
    b = cb + g
    return r, g, b


def ict_backward(y, cb, cr):
    """Inverse irreversible colour transform (gen_ict_backward)."""
    g = y - _f32(GAMMA_CR2G) * cr - _f32(GAMMA_CB2G) * cb
    r = y + _f32(GAMMA_CR2R) * cr
    b = y + _f32(GAMMA_CB2B) * cb
    return r, g, b


def rev_convert_in(x, bit_depth: int, is_signed: bool, nlt_type3: bool,
                   dtype=torch.int32):
    """Image samples -> signed representation, reversible path
    (tile::push, ojph_tile.cpp:349-359); ``dtype`` int64 for bit depths
    above 28, as the JAX package's encoder converts them
    (codec.py:742-743)."""
    x = x.to(dtype)
    shift = 1 << (bit_depth - 1)
    if is_signed and nlt_type3:
        return torch.where(x >= 0, x, -x - (shift + 1))
    return x if is_signed else x - shift


def irv_convert_to_float(x, bit_depth: int, is_signed: bool,
                         nlt_type3: bool):
    """Integer samples -> normalized float32
    (local_gen_irv_convert_to_float, ojph_colour.cpp:387-422)."""
    x = x.to(torch.int32)
    if is_signed:
        if nlt_type3:
            bias = (1 << (bit_depth - 1)) + 1
            x = torch.where(x >= 0, x, -x - bias)
    else:
        x = x - (1 << (bit_depth - 1))
    return x.to(torch.float32) * _f32(1.0 / float(1 << bit_depth))


def rev_convert_out(x, bit_depth: int, is_signed: bool, nlt_type3: bool):
    """Signed reversible samples -> image samples (tile::pull,
    ojph_tile.cpp:443-453)."""
    shift = 1 << (bit_depth - 1)
    if is_signed and nlt_type3:
        return torch.where(x >= 0, x, -x - (shift + 1))
    return x if is_signed else x + shift


def irv_convert_to_integer(x, bit_depth: int, is_signed: bool,
                           nlt_type3: bool):
    """float32 -> int32 samples with saturation and ojph_round
    semantics (local_gen_irv_convert_to_integer,
    ojph_colour.cpp:315-366; ojph_round, ojph_arch.h:317-326)."""
    neg_limit = -(1 << (bit_depth - 1))
    t = x.to(torch.float32) * _f32(float(1 << bit_depth))
    fl_up = float(1 << (bit_depth - 1))
    up_lim = (1 << (bit_depth - 1)) - 1
    # the halves are made on t's device: host tensors here would be
    # copied to the card on every call, which a CUDA graph cannot hold
    half = torch.full((), 0.5, dtype=torch.float32, device=t.device)
    tr = t + torch.where(t >= 0, half, -half)
    # out-of-range floats are replaced below; clamp first so the cast
    # itself stays defined
    v = torch.trunc(tr).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    v = torch.where(t >= -fl_up, v, torch.full_like(v, neg_limit))
    v = torch.where(t < fl_up, v, torch.full_like(v, up_lim))
    if is_signed:
        if nlt_type3:
            bias = (1 << (bit_depth - 1)) + 1
            v = torch.where(v >= 0, v, -v - bias)
        return v
    return v + (1 << (bit_depth - 1))
