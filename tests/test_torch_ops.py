"""The port's device ops (openjph_tpu_torch.gpu: dwt, color, quant) held
against the JAX package's (openjph_tpu.tpu) on the same numpy inputs,
on the CPU.

Tolerances: reversible (5/3, RCT, integer conversion) paths are
bit-exact; 9/7 lifting and the ICT are float32 in the same order of
operations, held to atol=1e-3 on unit-scale samples (the float
rounding of two compilers); sample conversion after them is exact on
equal inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openjph_tpu.core.atk import ATK_IRV97 as J_IRV97
from openjph_tpu.core.atk import AtkKernel as JAtk
from openjph_tpu.tpu import color as jclr
from openjph_tpu.tpu import dwt as jdwt
from openjph_tpu.tpu import quant as jquant
from openjph_tpu.tpu.pipeline import _tx_from_cb_j

from openjph_tpu_torch.core.atk import ATK_IRV97, AtkKernel
from openjph_tpu_torch.gpu import color as clr
from openjph_tpu_torch.gpu import dwt
from openjph_tpu_torch.gpu.quant import tx_from_cb

# a reversible ATK kernel with three steps and a non-trivial b/e
_REV3 = dict(index=5, reversible=True,
             steps=((3, 8, 4), (-2, 1, 2), (1, 2, 2)))


def _bands(rng, h, w, h_even, v_even, rev, frames=2):
    """(LL, HL, LH, HH) numpy phase planes of an h x w signal with a
    leading frame axis; even phase keeps ceil(n/2) low samples."""
    lw = (w + 1) // 2 if h_even else w // 2
    lh = (h + 1) // 2 if v_even else h // 2
    shapes = [(lh, lw), (lh, w - lw), (h - lh, lw), (h - lh, w - lw)]
    if rev:
        return [rng.randint(-300, 300, (frames,) + s).astype(np.int32)
                for s in shapes]
    return [rng.uniform(-1, 1, (frames,) + s).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize('rev', [True, False])
@pytest.mark.parametrize('h_even,v_even', [(True, True), (False, True),
                                           (True, False), (False, False)])
def test_inv_dwt2d_matches_jax(rev, h_even, v_even):
    rng = np.random.RandomState(11)
    bands = _bands(rng, 11, 13, h_even, v_even, rev)
    ref = np.asarray(jdwt.inv_dwt2d(*[jnp.asarray(b) for b in bands],
                                    h_even, v_even, rev))
    got = dwt.inv_dwt2d(*[torch.from_numpy(b) for b in bands],
                        h_even, v_even, rev).numpy()
    assert got.shape == ref.shape == (2, 11, 13)
    if rev:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize('kind', ['rev3', 'irv97'])
@pytest.mark.parametrize('axis', [-1, -2])
@pytest.mark.parametrize('even', [True, False])
@pytest.mark.parametrize('n', [1, 2, 9])
def test_inv_atk_1d_matches_jax(kind, axis, even, n):
    rng = np.random.RandomState(n)
    if kind == 'rev3':
        jk, k = JAtk(**_REV3), AtkKernel(**_REV3)
    else:
        jk, k = J_IRV97, ATK_IRV97
    nl = (n + 1) // 2 if even else n // 2
    shp = [3, 5, 7]

    def plane(m):
        s = list(shp)
        s[axis] = m
        if jk.reversible:
            return rng.randint(-500, 500, s).astype(np.int32)
        return rng.uniform(-1, 1, s).astype(np.float32)

    L, H = plane(nl), plane(n - nl)
    ref = np.asarray(jdwt.inv_atk_1d(jnp.asarray(L), jnp.asarray(H), even,
                                     axis % 3, jk))
    got = dwt.inv_atk_1d(torch.from_numpy(L), torch.from_numpy(H), even,
                         axis, k).numpy()
    assert got.shape == ref.shape
    if jk.reversible:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_rev53_and_irv97_wrappers_match_jax():
    rng = np.random.RandomState(3)
    L = rng.randint(-99, 99, (4, 6)).astype(np.int32)
    H = rng.randint(-99, 99, (4, 5)).astype(np.int32)
    assert np.array_equal(
        dwt.inv_rev53_1d(torch.from_numpy(L), torch.from_numpy(H), True,
                         1).numpy(),
        np.asarray(jdwt.inv_rev53_1d(jnp.asarray(L), jnp.asarray(H), True,
                                     1)))
    # odd phase along axis 0: 5 low and 6 high rows
    Lf = (H.T.astype(np.float32) / 64)[:, :4]
    Hf = (L.T.astype(np.float32) / 64)[:, :4]
    np.testing.assert_allclose(
        dwt.inv_irv97_1d(torch.from_numpy(Lf), torch.from_numpy(Hf), False,
                         0).numpy(),
        np.asarray(jdwt.inv_irv97_1d(jnp.asarray(Lf), jnp.asarray(Hf),
                                     False, 0)),
        rtol=0, atol=1e-3)


def test_colour_backward_matches_jax():
    rng = np.random.RandomState(5)
    yi, cbi, cri = (rng.randint(-512, 512, (2, 9, 7)).astype(np.int32)
                    for _ in range(3))
    for got, ref in zip(
            clr.rct_backward(*map(torch.from_numpy, (yi, cbi, cri))),
            jclr.rct_backward(*map(jnp.asarray, (yi, cbi, cri)))):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    yf, cbf, crf = (rng.uniform(-0.5, 0.5, (2, 9, 7)).astype(np.float32)
                    for _ in range(3))
    for got, ref in zip(
            clr.ict_backward(*map(torch.from_numpy, (yf, cbf, crf))),
            jclr.ict_backward(*map(jnp.asarray, (yf, cbf, crf)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('bd,sgn,nlt3', [(8, False, False),
                                         (12, True, False),
                                         (10, True, True),
                                         (16, False, False)])
def test_sample_conversion_matches_jax(bd, sgn, nlt3):
    rng = np.random.RandomState(bd)
    x = rng.randint(-(1 << bd), 1 << bd, (3, 17)).astype(np.int32)
    assert np.array_equal(
        clr.rev_convert_out(torch.from_numpy(x), bd, sgn, nlt3).numpy(),
        np.asarray(jclr.rev_convert_out(jnp.asarray(x), bd, sgn, nlt3)))
    # floats spanning the range, both saturation limits and exact halves
    f = rng.uniform(-0.75, 0.75, (3, 17)).astype(np.float32)
    f[0, :4] = [-0.5, 0.5, 0.5 - 2.0 ** -(bd + 1), -2.0 ** -(bd + 1)]
    assert np.array_equal(
        clr.irv_convert_to_integer(torch.from_numpy(f), bd, sgn,
                                   nlt3).numpy(),
        np.asarray(jclr.irv_convert_to_integer(jnp.asarray(f), bd, sgn,
                                               nlt3)))


@pytest.mark.parametrize('rev,kmax', [(True, 9), (True, 1), (True, 30),
                                      (False, 12)])
def test_tx_from_cb_matches_jax(rev, kmax):
    rng = np.random.RandomState(kmax)
    raw = rng.randint(0, 1 << 32, (2, 6, 8), dtype=np.uint64) \
        .astype(np.uint32)
    delta = 1.0 / 1024
    ref = np.asarray(_tx_from_cb_j(jnp.asarray(raw), kmax, delta, rev))
    got = tx_from_cb(torch.from_numpy(raw.view(np.int32)), kmax, delta,
                     rev).numpy()
    assert got.dtype == ref.dtype
    assert np.array_equal(got, ref)
    assert np.array_equal(
        got, np.asarray(jquant.tx_from_cb(jnp.asarray(raw), kmax, delta,
                                          rev)))
