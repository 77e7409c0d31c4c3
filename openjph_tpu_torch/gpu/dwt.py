"""Wavelet analysis and synthesis as whole-plane torch lifting (the JAX
package's tpu/dwt.py).

Reversible 5/3 runs in int32 and is bit-exact with the reference's
integer lifting (ojph_transform.cpp:209-332); irreversible 9/7 runs in
float32 with the operations in the JAX package's order.  Planes may
carry leading axes (the frame axis of a burst); ``axis`` names the
lifted one.  Each lifting step is a handful of elementwise ops over
the whole phase plane with a one-sample symmetric extension.
"""
from __future__ import annotations

import torch

from ..core.atk import ATK_IRV97, ATK_REV53, AtkKernel


def _ext(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Symmetric-extend by one sample on both ends along axis."""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 0, 1), a, a.narrow(axis, n - 1, 1)],
                     dim=axis)


def _rev_lift(a: int, b: int, e: int, s0, s1):
    """The update of one reversible lifting step, with the reference's
    special cases (gen_rev_vert_step32, ojph_transform.cpp:209-257);
    analysis adds it, synthesis subtracts it."""
    if a == 1:
        return (b + s0 + s1) >> e
    if a == -1 and b == 1 and e == 1:
        return -((s0 + s1) >> e)
    if a == -1:
        return (b - (s0 + s1)) >> e
    return (b + a * (s0 + s1)) >> e


def _phase_split(x, even: bool, axis: int):
    """(L, H) phase planes of x along axis: L holds the samples at even
    positions when ``even``, else the odd ones."""
    n = x.shape[axis]
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0 if even else 1, n, 2)
    lp = x[tuple(sl)]
    sl[axis] = slice(1 if even else 0, n, 2)
    return lp, x[tuple(sl)]


def _interleave(L, H, even: bool, axis: int):
    n = L.shape[axis] + H.shape[axis]
    shape = list(L.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=L.dtype, device=L.device)
    sl = [slice(None)] * L.ndim
    sl[axis] = slice(0 if even else 1, n, 2)
    out[tuple(sl)] = L
    sl[axis] = slice(1 if even else 0, n, 2)
    out[tuple(sl)] = H
    return out


def _take(a, start: int, size: int, axis: int):
    return a.narrow(axis, start, size)


def fwd_atk_1d(x: torch.Tensor, even: bool, axis: int,
               kernel: AtkKernel):
    """Forward lifting along axis with an arbitrary first-order kernel;
    returns (L, H).  The exact inverse of the reference's synthesis
    state machine: synthesis step j updates the L plane for even j and
    the H plane for odd j, at phase parity even ^ (j & 1); analysis
    undoes steps Natk-1 .. 0, then scales (L *= 1/K, H *= K)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if n == 0:
        return x, x  # empty line: both bands empty (reference skips)
    if n == 1:
        empty = x.narrow(axis, 0, 0)
        if even:
            return x, empty
        if kernel.reversible:
            return empty, x * 2
        return empty, x * torch.tensor(2.0, dtype=torch.float32)
    P = list(_phase_split(x, even, axis))
    for j in range(kernel.num_steps - 1, -1, -1):
        bidx = j & 1
        ev_j = even if bidx == 0 else not even
        B, O = P[bidx], P[1 - bidx]
        Oe = _ext(O, axis)
        off = 0 if ev_j else 1
        bw = B.shape[axis]
        s0 = _take(Oe, off, bw, axis)
        s1 = _take(Oe, off + 1, bw, axis)
        if kernel.reversible:
            a, b, e = kernel.steps[j]
            P[bidx] = B + _rev_lift(a, b, e, s0, s1)
        else:
            P[bidx] = B + torch.tensor(kernel.steps[j],
                                       dtype=torch.float32) * (s0 + s1)
    if not kernel.reversible:
        K = kernel.K
        P[0] = P[0] * torch.tensor(1.0 / K, dtype=torch.float32)
        P[1] = P[1] * torch.tensor(K, dtype=torch.float32)
    return P[0], P[1]


def inv_atk_1d(L: torch.Tensor, H: torch.Tensor, even: bool, axis: int,
               kernel: AtkKernel):
    """Inverse lifting along axis (gen_rev/irv_horz_syn) with an
    arbitrary first-order kernel; returns the interleaved signal."""
    axis = axis % L.ndim
    n = L.shape[axis] + H.shape[axis]
    if n == 0:
        return L  # empty line (reference skips)
    if n == 1:
        if even:
            return L
        if kernel.reversible:
            return H >> 1
        return H * torch.tensor(0.5, dtype=torch.float32)
    if kernel.reversible:
        aug, oth = L, H
    else:
        K = kernel.K
        aug = L * torch.tensor(K, dtype=torch.float32)
        oth = H * torch.tensor(1.0 / K, dtype=torch.float32)
    ev = even
    for s in kernel.steps:
        othe = _ext(oth, axis)
        off = 0 if ev else 1
        aw = aug.shape[axis]
        s0 = _take(othe, off, aw, axis)
        s1 = _take(othe, off + 1, aw, axis)
        if kernel.reversible:
            a, b, e = s
            aug = aug - _rev_lift(a, b, e, s0, s1)
        else:
            aug = aug - torch.tensor(s, dtype=torch.float32) * (s0 + s1)
        aug, oth = oth, aug
        ev = not ev
    if kernel.num_steps % 2:
        aug, oth = oth, aug
    return _interleave(aug, oth, even, axis)


def fwd_rev53_1d(x, even: bool, axis: int):
    """Forward 5/3 along axis; returns (L, H)."""
    return fwd_atk_1d(x, even, axis, ATK_REV53)


def fwd_irv97_1d(x, even: bool, axis: int):
    """Forward 9/7 along axis (float32), K scaling applied."""
    return fwd_atk_1d(x, even, axis, ATK_IRV97)


def inv_rev53_1d(L, H, even: bool, axis: int):
    """Inverse 5/3 along axis; returns the interleaved signal."""
    return inv_atk_1d(L, H, even, axis, ATK_REV53)


def inv_irv97_1d(L, H, even: bool, axis: int):
    """Inverse 9/7 along axis (float32)."""
    return inv_atk_1d(L, H, even, axis, ATK_IRV97)


def fwd_dwt2d(x, h_even: bool, v_even: bool, reversible: bool,
              kernel: AtkKernel = None):
    """One 2D analysis level (resolution::push_line,
    ojph_resolution.cpp:530-710) as whole-plane vertical then
    horizontal lifting over the last two axes; returns (LL, HL, LH,
    HH)."""
    k = kernel or (ATK_REV53 if reversible else ATK_IRV97)
    Lv, Hv = fwd_atk_1d(x, v_even, x.ndim - 2, k)
    LL, HL = fwd_atk_1d(Lv, h_even, x.ndim - 1, k)
    LH, HH = fwd_atk_1d(Hv, h_even, x.ndim - 1, k)
    return LL, HL, LH, HH


def inv_dwt2d(LL, HL, LH, HH, h_even: bool, v_even: bool,
              reversible: bool, kernel: AtkKernel = None):
    """One 2D synthesis level (resolution::pull_line,
    ojph_resolution.cpp:713-949): horizontal then vertical lifting."""
    k = kernel or (ATK_REV53 if reversible else ATK_IRV97)
    Lv = inv_atk_1d(LL, HL, h_even, LL.ndim - 1, k)
    Hv = inv_atk_1d(LH, HH, h_even, LL.ndim - 1, k)
    return inv_atk_1d(Lv, Hv, v_even, LL.ndim - 2, k)
