"""Color transforms (RCT/ICT) and sample conversions (bit-depth bias,
NLT type-3), whole-plane NumPy formulation.

Parity: OpenJPH src/core/transform/ojph_colour.cpp:220-568.
"""
from __future__ import annotations

import numpy as np

ALPHA_R = np.float32(0.299)
ALPHA_G = np.float32(0.587)
ALPHA_B = np.float32(0.114)
BETA_CB = np.float32(0.5 / (1 - 0.114))
BETA_CR = np.float32(0.5 / (1 - 0.299))
GAMMA_CB2G = np.float32(2.0 * 0.114 * (1.0 - 0.114) / 0.587)
GAMMA_CR2G = np.float32(2.0 * 0.299 * (1.0 - 0.299) / 0.587)
GAMMA_CB2B = np.float32(2.0 * (1.0 - 0.114))
GAMMA_CR2R = np.float32(2.0 * (1.0 - 0.299))


def rct_forward(r, g, b):
    """Reversible color transform (gen_rct_forward,
    ojph_colour.cpp:443-490); int32/int64 arrays."""
    y = (r + (g << 1) + b) >> 2
    cb = b - g
    cr = r - g
    return y, cb, cr


def rct_backward(y, cb, cr):
    g = y - ((cb + cr) >> 2)
    r = cr + g
    b = cb + g
    return r, g, b


def ict_forward(r, g, b):
    """Irreversible color transform (gen_ict_forward,
    ojph_colour.cpp:545-556); float32 arrays."""
    y = ALPHA_R * r + ALPHA_G * g + ALPHA_B * b
    cb = BETA_CB * (b - y)
    cr = BETA_CR * (r - y)
    return y, cb, cr


def ict_backward(y, cb, cr):
    g = y - GAMMA_CR2G * cr - GAMMA_CB2G * cb
    r = y + GAMMA_CR2R * cr
    b = y + GAMMA_CB2B * cb
    return r, g, b


def rev_convert_in(x: np.ndarray, bit_depth: int, is_signed: bool,
                   nlt_type3: bool, dtype=np.int32) -> np.ndarray:
    """Image samples -> signed representation for the reversible path
    (tile::push, ojph_tile.cpp:349-359)."""
    x = x.astype(dtype)
    shift = 1 << (bit_depth - 1)
    if is_signed and nlt_type3:
        return np.where(x >= 0, x, -x - (shift + 1))
    return x if is_signed else x - shift


def rev_convert_out(x: np.ndarray, bit_depth: int, is_signed: bool,
                    nlt_type3: bool) -> np.ndarray:
    """Inverse of rev_convert_in (tile::pull, ojph_tile.cpp:443-453)."""
    shift = 1 << (bit_depth - 1)
    if is_signed and nlt_type3:
        return np.where(x >= 0, x, -x - (shift + 1))
    return x if is_signed else x + shift


def irv_convert_to_float(x: np.ndarray, bit_depth: int, is_signed: bool,
                         nlt_type3: bool) -> np.ndarray:
    """Integer samples -> normalized float32
    (local_gen_irv_convert_to_float, ojph_colour.cpp:387-422)."""
    x = x.astype(np.int64)
    mul = np.float32(1.0 / float(1 << bit_depth))
    if is_signed:
        if nlt_type3:
            bias = (1 << (bit_depth - 1)) + 1
            x = np.where(x >= 0, x, -x - bias)
    else:
        x = x - (1 << (bit_depth - 1))
    return x.astype(np.float32) * mul


def irv_convert_to_integer(x: np.ndarray, bit_depth: int, is_signed: bool,
                           nlt_type3: bool) -> np.ndarray:
    """float32 -> integer samples with saturation
    (local_gen_irv_convert_to_integer, ojph_colour.cpp:315-366)."""
    neg_limit = np.int64(-(1 << (bit_depth - 1)))
    mul = np.float32(float(1 << bit_depth))
    t = x.astype(np.float32) * mul
    fl_up = np.float32(float(1 << (bit_depth - 1)))
    fl_low = np.float32(-float(1 << (bit_depth - 1)))
    up_lim = (1 << (bit_depth - 1)) - 1
    # ojph_round (ojph_arch.h:317-326): add +/-0.5 in float32, then
    # truncate toward zero
    tr = t + np.where(t >= 0, np.float32(0.5), np.float32(-0.5))
    v = np.trunc(tr.astype(np.float32)).astype(np.int64)
    v = np.where(t >= fl_low, v, neg_limit)
    v = np.where(t < fl_up, v, up_lim)
    if is_signed:
        if nlt_type3:
            bias = (1 << (bit_depth - 1)) + 1
            v = np.where(v >= 0, v, -v - bias)
        return v
    return v + (1 << (bit_depth - 1))
