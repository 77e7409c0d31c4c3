"""Wavelet lifting transforms: reversible 5/3 (integer) and irreversible
9/7 (float32), whole-array formulation.

The reference computes these line-by-line with a ring of lifting buffers
(ojph_resolution.cpp:461-949, ojph_transform.cpp:203-850); on TPU we
instead transform whole subband planes at once.  Per lifting step, each
phase array is symmetric-extended by one sample, which is equivalent to
the reference's per-step `lp[-1]=lp[0]; lp[w]=lp[w-1]` handling, so the
integer path is bit-exact with OpenJPH.

Conventions:
 - ``even`` means the resolution rect starts at an even canvas
   coordinate (horz: x0, vert: y0); the low-pass phase takes samples at
   even canvas positions.
 - 5/3 steps (T.800 / init_rev53, ojph_params.cpp:2884-2896):
   predict  H -= (L0 + L1) >> 1 ; update L += (H0 + H1 + 2) >> 2
 - 9/7 steps (init_irv97, ojph_params.cpp:2870-2881) applied in the
   ATK order with K scaling applied per direction.
"""
from __future__ import annotations

import numpy as np

from ..core.atk import ATK_IRV97, ATK_REV53, AtkKernel

# 9/7 lifting coefficients and scaling (ojph_params.cpp:2870-2881).
IRV97_K = np.float32(1.230174104914001)
IRV97_STEPS = (np.float32(0.443506852043971),   # step 0 (update 2)
               np.float32(0.882911075530934),   # step 1
               np.float32(-0.052980118572961),  # step 2
               np.float32(-1.586134342059924))  # step 3 (predict 1)
# 5/3 steps as (a, b, e) (ojph_params.cpp:2884-2896)
REV53_STEPS = ((1, 2, 2), (-1, 1, 1))


def _ext(a: np.ndarray, axis: int) -> np.ndarray:
    """Symmetric-extend by one sample on both ends along axis."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    return np.concatenate([first, a, last], axis=axis)


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


def fwd_rev53_1d(x: np.ndarray, even: bool, axis: int):
    """Forward 5/3 along axis; returns (L, H)."""
    return fwd_atk_1d(x, even, axis, ATK_REV53)


def inv_rev53_1d(L: np.ndarray, H: np.ndarray, even: bool, axis: int):
    """Inverse 5/3 along axis; returns interleaved signal."""
    return inv_atk_1d(L, H, even, axis, ATK_REV53)


def fwd_irv97_1d(x: np.ndarray, even: bool, axis: int):
    """Forward 9/7 along axis (float32); returns (L, H) with K scaling
    applied (L *= 1/K, H *= K) as in gen_irv_horz_ana."""
    return fwd_atk_1d(x, even, axis, ATK_IRV97)


def inv_irv97_1d(L: np.ndarray, H: np.ndarray, even: bool, axis: int):
    """Inverse 9/7 along axis (float32)."""
    return inv_atk_1d(L, H, even, axis, ATK_IRV97)


def _default_kernel(reversible: bool) -> AtkKernel:
    return ATK_REV53 if reversible else ATK_IRV97


def fwd_dwt2d(x: np.ndarray, x0: int, y0: int, reversible: bool,
              kernel: AtkKernel = None):
    """One 2D analysis level on a resolution plane whose top-left canvas
    coordinate is (x0, y0).  Returns (LL, HL, LH, HH).

    Vertical first then horizontal, matching resolution::push_line
    (the two orders commute for separable lifting, and the reference
    interleaves them line-wise; bit-exactness verified against the
    oracle)."""
    h_even = (x0 & 1) == 0
    v_even = (y0 & 1) == 0
    k = kernel or _default_kernel(reversible)
    Lv, Hv = fwd_atk_1d(x, v_even, 0, k)
    LL, HL = fwd_atk_1d(Lv, h_even, 1, k)
    LH, HH = fwd_atk_1d(Hv, h_even, 1, k)
    return LL, HL, LH, HH


def inv_dwt2d(LL, HL, LH, HH, x0: int, y0: int, reversible: bool,
              kernel: AtkKernel = None):
    """One 2D synthesis level; inverse of fwd_dwt2d."""
    h_even = (x0 & 1) == 0
    v_even = (y0 & 1) == 0
    k = kernel or _default_kernel(reversible)
    Lv = inv_atk_1d(LL, HL, h_even, 1, k)
    Hv = inv_atk_1d(LH, HH, h_even, 1, k)
    return inv_atk_1d(Lv, Hv, v_even, 0, k)
