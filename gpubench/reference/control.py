"""The control of the correctness check: the reference, put in the
program's place, with one precision or guarantee of the configuration
broken.  A check that passes the control cannot tell a sound run from
one that lost precision, so the control has to come out as not correct.

- Irreversible (9/7, ICT; the configurations state float32): every
  lifting pass's inputs and outputs and the colour transforms' planes
  are held in bfloat16, the step that would tempt a change that halves
  the planes' bytes.
- Reversible (5/3; the configurations state exact integer lifting, so
  lossless frames): bfloat16 holds every plane of 8-bit frames exactly
  (their lifting values stay within +-256), so it breaks nothing there.
  The control breaks the stated guarantee instead: each lifting step
  drops its rounding offset (the update step's +2 before >> 2), the
  step that would tempt a change that fuses the two lifting steps.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .htj2k import codec
from .htj2k.ops import color, dwt


def to_bf16(a):
    """``a`` rounded to bfloat16, in its own dtype (integers round to
    the nearest representable integer)."""
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    r = t.to(torch.bfloat16).to(torch.float32).numpy()
    if a.dtype.kind in 'iu':
        return np.floor(r).astype(a.dtype)
    return r.astype(a.dtype)


@contextlib.contextmanager
def broken():
    """Within the block the reference codec (encode and decode) computes
    its irreversible lifting and colour transforms in bfloat16 and its
    reversible lifting steps without their rounding offsets."""
    saved = (dwt._rev_step, dwt.fwd_atk_1d, dwt.inv_atk_1d,
             color.ict_forward, color.ict_backward)
    rev_step, fwd, inv, ictf, icti = saved

    def rev_step_truncated(a, b, e, dst, s0, s1, synthesis):
        return rev_step(a, 0, e, dst, s0, s1, synthesis)

    def fwd_atk_1d(x, even, axis, kernel):
        if kernel.reversible:
            return fwd(x, even, axis, kernel)
        lo, hi = fwd(to_bf16(x), even, axis, kernel)
        return to_bf16(lo), to_bf16(hi)

    def inv_atk_1d(lo, hi, even, axis, kernel):
        if kernel.reversible:
            return inv(lo, hi, even, axis, kernel)
        return to_bf16(inv(to_bf16(lo), to_bf16(hi), even, axis, kernel))

    def ict_forward(r, g, b):
        return tuple(to_bf16(p) for p in ictf(to_bf16(r), to_bf16(g),
                                              to_bf16(b)))

    def ict_backward(y, cb, cr):
        return tuple(to_bf16(p) for p in icti(to_bf16(y), to_bf16(cb),
                                              to_bf16(cr)))

    dwt._rev_step, dwt.fwd_atk_1d, dwt.inv_atk_1d = (
        rev_step_truncated, fwd_atk_1d, inv_atk_1d)
    color.ict_forward, color.ict_backward = ict_forward, ict_backward
    try:
        yield
    finally:
        (dwt._rev_step, dwt.fwd_atk_1d, dwt.inv_atk_1d,
         color.ict_forward, color.ict_backward) = saved


def decode(stream: bytes):
    """The control's decode: component planes, as the reference's."""
    with broken():
        return codec.decode(stream)


def encode(planes, **kwargs) -> bytes:
    """The control's encode: a codestream, as the reference's."""
    with broken():
        return codec.encode(planes, **kwargs)
