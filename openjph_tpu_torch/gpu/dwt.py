"""Wavelet synthesis as whole-plane torch lifting (the JAX package's
tpu/dwt.py, synthesis half).

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


def _rev_step(a: int, b: int, e: int, dst, s0, s1):
    """One reversible synthesis lifting step with the reference's
    special cases (gen_rev_vert_step32, ojph_transform.cpp:209-257)."""
    if a == 1:
        d = (b + s0 + s1) >> e
    elif a == -1 and b == 1 and e == 1:
        d = -((s0 + s1) >> e)
    elif a == -1:
        d = (b - (s0 + s1)) >> e
    else:
        d = (b + a * (s0 + s1)) >> e
    return dst - d


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
            aug = _rev_step(a, b, e, aug, s0, s1)
        else:
            aug = aug - torch.tensor(s, dtype=torch.float32) * (s0 + s1)
        aug, oth = oth, aug
        ev = not ev
    if kernel.num_steps % 2:
        aug, oth = oth, aug
    return _interleave(aug, oth, even, axis)


def inv_rev53_1d(L, H, even: bool, axis: int):
    """Inverse 5/3 along axis; returns the interleaved signal."""
    return inv_atk_1d(L, H, even, axis, ATK_REV53)


def inv_irv97_1d(L, H, even: bool, axis: int):
    """Inverse 9/7 along axis (float32)."""
    return inv_atk_1d(L, H, even, axis, ATK_IRV97)


def inv_dwt2d(LL, HL, LH, HH, h_even: bool, v_even: bool,
              reversible: bool, kernel: AtkKernel = None):
    """One 2D synthesis level (resolution::pull_line,
    ojph_resolution.cpp:713-949): horizontal then vertical lifting."""
    k = kernel or (ATK_REV53 if reversible else ATK_IRV97)
    Lv = inv_atk_1d(LL, HL, h_even, LL.ndim - 1, k)
    Hv = inv_atk_1d(LH, HH, h_even, LL.ndim - 1, k)
    return inv_atk_1d(Lv, Hv, v_even, LL.ndim - 2, k)
