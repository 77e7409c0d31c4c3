"""The port's forward device ops (openjph_tpu_torch.gpu: dwt analysis,
forward colour and sample conversion, quantization to sign-magnitude)
held against the JAX package's on the same numpy inputs, on the CPU.

Tolerances: reversible paths (5/3, RCT, integer conversion, quantization)
are bit-exact with openjph_tpu.tpu.  The float32 paths are bit-exact with
the JAX package's host reference (openjph_tpu.ops and codec._tx_to_cb, in
numpy), whose multiplies and adds each round on their own, as the port's
do on every device.  Against openjph_tpu.tpu.dwt the 9/7 lifting differs
by a few units in the last place: XLA's CPU backend evaluates each
lifting step ``B + c * (s0 + s1)`` as one fused multiply-add (checked
bit for bit against an FMA), so it is held to atol=4e-6 on samples of
magnitude below 4 (16 ULP at that magnitude).  The forward ICT is
bit-exact with both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openjph_tpu.codec import _tx_to_cb
from openjph_tpu.core.atk import AtkKernel as JAtk
from openjph_tpu.ops import dwt as ndwt
from openjph_tpu.tpu import color as jclr
from openjph_tpu.tpu import dwt as jdwt

from openjph_tpu_torch.core.atk import ATK_IRV97, AtkKernel
from openjph_tpu_torch.gpu import color as clr
from openjph_tpu_torch.gpu import dwt
from openjph_tpu_torch.gpu.quant import tx_to_cb

# a reversible ATK kernel with three steps and a non-trivial b/e
_REV3 = dict(index=5, reversible=True,
             steps=((3, 8, 4), (-2, 1, 2), (1, 2, 2)))


def _signal(rng, shape, rev):
    if rev:
        return rng.randint(-300, 300, shape).astype(np.int32)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _same(got, ref, exact):
    assert got.shape == ref.shape
    if exact:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=4e-6)


@pytest.mark.parametrize('rev', [True, False])
@pytest.mark.parametrize('h_even,v_even', [(True, True), (False, True),
                                           (True, False), (False, False)])
@pytest.mark.parametrize('h,w', [(11, 13), (1, 7), (2, 5), (8, 1)])
def test_fwd_dwt2d_matches_jax(rev, h_even, v_even, h, w):
    x = _signal(np.random.RandomState(h * 31 + w), (2, h, w), rev)
    got = [b.numpy() for b in dwt.fwd_dwt2d(torch.from_numpy(x), h_even,
                                            v_even, rev)]
    ref = jdwt.fwd_dwt2d(jnp.asarray(x), h_even, v_even, rev)
    host = [ndwt.fwd_dwt2d(x[f], 0 if h_even else 1, 0 if v_even else 1,
                           rev) for f in range(2)]
    for k in range(4):
        _same(got[k], np.asarray(ref[k]), rev)
        # the numpy reference works per frame
        assert np.array_equal(got[k], np.stack([hb[k] for hb in host]))


@pytest.mark.parametrize('kind', ['rev53', 'irv97', 'rev3'])
@pytest.mark.parametrize('axis', [0, 1])
@pytest.mark.parametrize('even', [True, False])
@pytest.mark.parametrize('n', [1, 2, 7, 10])
def test_fwd_atk_1d_matches_jax(kind, axis, even, n):
    rev = kind != 'irv97'
    if kind == 'rev3':
        jk, k = JAtk(**_REV3), AtkKernel(**_REV3)
    elif kind == 'rev53':
        jk, k = jdwt.ATK_REV53, dwt.ATK_REV53
    else:
        jk, k = jdwt.ATK_IRV97, ATK_IRV97
    shape = (n, 5) if axis == 0 else (5, n)
    x = _signal(np.random.RandomState(n), shape, rev)
    got = dwt.fwd_atk_1d(torch.from_numpy(x), even, axis, k)
    ref = jdwt.fwd_atk_1d(jnp.asarray(x), even, axis, jk)
    host = ndwt.fwd_atk_1d(x, even, axis, jk)
    for g, r, hr in zip(got, ref, host):
        _same(g.numpy(), np.asarray(r), rev)
        assert np.array_equal(g.numpy(), hr)


def test_fwd_wrappers_match_jax():
    x = _signal(np.random.RandomState(3), (9, 6), False)
    xi = _signal(np.random.RandomState(4), (9, 6), True)
    for g, r in zip(dwt.fwd_irv97_1d(torch.from_numpy(x), False, 0),
                    ndwt.fwd_irv97_1d(x, False, 0)):
        assert np.array_equal(g.numpy(), r)
    for g, r in zip(dwt.fwd_rev53_1d(torch.from_numpy(xi), True, 1),
                    jdwt.fwd_rev53_1d(jnp.asarray(xi), True, 1)):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_colour_forward_matches_jax():
    rng = np.random.RandomState(5)
    ri = [rng.randint(-128, 128, (2, 9, 7)).astype(np.int32)
          for _ in range(3)]
    for g, r in zip(clr.rct_forward(*map(torch.from_numpy, ri)),
                    jclr.rct_forward(*map(jnp.asarray, ri))):
        assert np.array_equal(g.numpy(), np.asarray(r))
    rf = [rng.uniform(-0.5, 0.5, (2, 9, 7)).astype(np.float32)
          for _ in range(3)]
    for g, r in zip(clr.ict_forward(*map(torch.from_numpy, rf)),
                    jclr.ict_forward(*map(jnp.asarray, rf))):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('bd,sgn,nlt3', [(8, False, False),
                                         (12, True, False),
                                         (10, True, True),
                                         (16, False, False)])
def test_sample_conversion_in_matches_jax(bd, sgn, nlt3):
    rng = np.random.RandomState(bd)
    lo, hi = ((-(1 << (bd - 1)), 1 << (bd - 1)) if sgn else (0, 1 << bd))
    x = rng.randint(lo, hi, (2, 6, 5)).astype(np.int32)
    got = clr.rev_convert_in(torch.from_numpy(x), bd, sgn, nlt3)
    assert np.array_equal(got.numpy(), np.asarray(
        jclr.rev_convert_in(jnp.asarray(x), bd, sgn, nlt3)))
    got = clr.irv_convert_to_float(torch.from_numpy(x), bd, sgn, nlt3)
    ref = np.asarray(jclr.irv_convert_to_float(jnp.asarray(x), bd, sgn,
                                               nlt3))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize('rev,kmax', [(True, 9), (True, 17), (False, 12)])
def test_tx_to_cb_matches_host(rev, kmax):
    rng = np.random.RandomState(kmax)
    if rev:
        x = rng.randint(-(1 << (kmax - 1)), 1 << (kmax - 1),
                        (5, 8)).astype(np.int32)
    else:
        x = rng.uniform(-3, 3, (5, 8)).astype(np.float32)
    delta = 0.0137
    smag, mag = tx_to_cb(torch.from_numpy(x), kmax, delta, rev)
    ref_s, ref_v = _tx_to_cb(x, kmax, 0.0 if rev else 1.0 / delta, rev)
    assert np.array_equal(smag.numpy().view(np.uint32), ref_s)
    assert np.array_equal(mag.numpy(), ref_v.astype(np.int64))
