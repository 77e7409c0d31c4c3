"""Whole-array numpy lifting with an arbitrary first-order kernel: a
copy of the JAX package's ops/dwt.py ``fwd_atk_1d`` / ``inv_atk_1d``.
The quantization parameters of a custom (ATK) kernel are measured by
pushing identity matrices through the cascade (``core/quant.py``); the
device transforms are in ``gpu/dwt.py``.
"""
from __future__ import annotations

import numpy as np

from .atk import AtkKernel


def _rev_step(a: int, b: int, e: int, dst, s0, s1, synthesis: bool):
    """One reversible lifting step: dst ± ((b + a*(s0+s1)) >> e) with the
    reference's special cases (gen_rev_vert_step32,
    ojph_transform.cpp:209-257).  Arrays are int32/int64; >> is
    arithmetic."""
    if a == 1:
        d = (b + s0 + s1) >> e
    elif a == -1 and b == 1 and e == 1:
        d = -((s0 + s1) >> e)
    elif a == -1:
        d = (b - (s0 + s1)) >> e
    else:
        d = (b + a * (s0 + s1)) >> e
    return dst - d if synthesis else dst + d


def fwd_atk_1d(x: np.ndarray, even: bool, axis: int, kernel: AtkKernel):
    """Forward lifting along axis with an arbitrary first-order kernel;
    returns (L, H).

    Defined as the exact inverse of the reference's synthesis state
    machine (gen_rev/irv_horz_syn, ojph_transform.cpp:519-600,786-850):
    synthesis step j updates the L-storage plane for even j and the
    H-storage plane for odd j, at phase parity even^(j&1); analysis
    undoes steps Natk-1 .. 0 with the addition form, then applies the
    storage scaling (L *= 1/K, H *= K).  For even step counts this is
    identical to the reference's gen_*_horz_ana; for odd counts the
    reference's own analysis updates the high phase first and is NOT
    the inverse of its synthesis — what matters for parity is that the
    oracle's synthesis reconstructs our encoder's output."""
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0]
    if n == 1:
        if even:
            return (np.moveaxis(x, 0, axis),
                    np.moveaxis(x[:0], 0, axis))
        scaled = (x * 2) if kernel.reversible else (x * np.float32(2.0))
        return np.moveaxis(x[:0], 0, axis), np.moveaxis(scaled, 0, axis)
    P = [x[0::2] if even else x[1::2],   # L storage
         x[1::2] if even else x[0::2]]   # H storage
    for j in range(kernel.num_steps - 1, -1, -1):
        bidx = j & 1
        ev_j = even if (j & 1) == 0 else not even
        B, O = P[bidx], P[1 - bidx]
        Oe = np.concatenate([O[:1], O, O[-1:]], axis=0)
        off = 0 if ev_j else 1
        bw = B.shape[0]
        s0, s1 = Oe[off:off + bw], Oe[off + 1:off + 1 + bw]
        if kernel.reversible:
            a, b, e = kernel.steps[j]
            P[bidx] = _rev_step(a, b, e, B, s0, s1, synthesis=False)
        else:
            P[bidx] = B + np.float32(kernel.steps[j]) * (s0 + s1)
    if not kernel.reversible:
        K = np.float32(kernel.K)
        P[0] = P[0] * (np.float32(1.0) / K)
        P[1] = P[1] * K
    return np.moveaxis(P[0], 0, axis), np.moveaxis(P[1], 0, axis)


def inv_atk_1d(L: np.ndarray, H: np.ndarray, even: bool, axis: int,
               kernel: AtkKernel):
    """Inverse lifting along axis (gen_rev_horz_syn32,
    ojph_transform.cpp:519-600): steps applied 0 .. Natk-1 with the
    subtraction form; returns the interleaved signal."""
    L = np.moveaxis(L, axis, 0)
    H = np.moveaxis(H, axis, 0)
    n = L.shape[0] + H.shape[0]
    if n == 1:
        if even:
            out = L
        else:
            out = (H >> 1) if kernel.reversible else H * np.float32(0.5)
        return np.moveaxis(out, 0, axis)
    if kernel.reversible:
        aug, oth = L.copy(), H.copy()
    else:
        K = np.float32(kernel.K)
        aug = L * K
        oth = H * (np.float32(1.0) / K)
    ev = even
    for s in kernel.steps:
        othe = np.concatenate([oth[:1], oth, oth[-1:]], axis=0)
        off = 0 if ev else 1
        aw = aug.shape[0]
        if kernel.reversible:
            a, b, e = s
            aug = _rev_step(a, b, e, aug, othe[off:off + aw],
                            othe[off + 1:off + 1 + aw], synthesis=True)
        else:
            aug = aug - np.float32(s) * (othe[off:off + aw]
                                         + othe[off + 1:off + 1 + aw])
        aug, oth = oth, aug
        ev = not ev
    if kernel.num_steps % 2:
        aug, oth = oth, aug
    L2, H2 = aug, oth  # after an even number of swaps, roles are restored
    dtype = L.dtype if kernel.reversible else np.float32
    out = np.empty((n,) + L.shape[1:], dtype=dtype)
    if even:
        out[0::2], out[1::2] = L2, H2
    else:
        out[1::2], out[0::2] = L2, H2
    return np.moveaxis(out, 0, axis)
