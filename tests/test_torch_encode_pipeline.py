"""The port's fused frame encode (openjph_tpu_torch.encode_gpu) on the CPU,
held byte for byte against the JAX package on the same images: against
openjph_tpu.encode_tpu for two cases, and against openjph_tpu.encode for
the rest of tests/test_tpu_encode_pipeline.py's cases, which that suite
pins byte-identical to encode_tpu.  Each 5/3 stream decodes back to its
image through the port's own decoder.  Also the plan against the JAX
plan, a two-frame runner, and the guards: CUDA by default, no kernel
launched on the CPU, a Part-2 DFS structure byte-identical to the JAX
host encoder, and configurations outside this slice raising
NotImplementedError.
"""
import functools

import numpy as np
import pytest
import torch

from openjph_tpu import encode, encode_tpu
from openjph_tpu.codec import Encoder as JaxEncoder
from openjph_tpu.codec import build_encoder as jax_build_encoder
from openjph_tpu.core import markers as jmk
from openjph_tpu.core.geometry import build_tile as jax_build_tile
from openjph_tpu.core.geometry import build_tile_grid as jax_tile_grid
from openjph_tpu.tpu.encode_pipeline import TpuEncoder

import openjph_tpu_torch
from openjph_tpu_torch.codec import build_encoder
from openjph_tpu_torch.core import markers as mk
from openjph_tpu_torch.core.geometry import build_tile, build_tile_grid
from openjph_tpu_torch.core.message import OjphError
from openjph_tpu_torch.gpu import block_encode_cuda as E
from openjph_tpu_torch.gpu import encode_pipeline as ep


_CPU_ENCODER = functools.partial(ep.GpuEncoder, device='cpu')


def _img(seed, w, h, bd=8):
    rng = np.random.RandomState(seed)
    ramp = (np.arange(w)[None, :] + np.arange(h)[:, None]) % (1 << bd)
    noise = rng.randint(0, 1 << bd, size=(h, w))
    return np.where((np.arange(h)[:, None] // 8) % 2 == 0, ramp,
                    noise).astype(np.int32)


def _rgb(seed, w, h):
    return np.stack([_img(seed + c, w, h) for c in range(3)], axis=-1)


# name -> (image, encode keywords, JAX reference)
CASES = {
    'gray256_nd5': (lambda: _img(1, 256, 256),
                    dict(reversible=True, num_decomps=5,
                         block_size=(64, 64)), encode_tpu),
    'rgb_rct': (lambda: _rgb(2, 130, 77),
                dict(reversible=True, num_decomps=3), encode_tpu),
    '77x65_bs32': (lambda: _img(3, 77, 65),
                   dict(reversible=True, num_decomps=3,
                        block_size=(32, 32)), encode),
    '128x96_bs16': (lambda: _img(4, 128, 96),
                    dict(reversible=True, num_decomps=3,
                         block_size=(16, 16)), encode),
    '33x33_bs4': (lambda: _img(5, 33, 33),
                  dict(reversible=True, num_decomps=2, block_size=(4, 4)),
                  encode),
    '1024x4': (lambda: _img(6, 1024, 4),
               dict(reversible=True, num_decomps=5, block_size=(32, 32)),
               encode),
    '4x1024': (lambda: _img(7, 4, 1024),
               dict(reversible=True, num_decomps=5, block_size=(32, 32)),
               encode),
    'lossy97': (lambda: _img(8, 256, 256),
                dict(reversible=False, base_delta=0.01), encode),
    'rgb_ict97': (lambda: _rgb(9, 64, 48),
                  dict(reversible=False, num_decomps=2), encode),
    'tiles33': (lambda: _img(10, 128, 96),
                dict(reversible=True, num_decomps=3, tile_size=(33, 33)),
                encode),
    '16bit': (lambda: _img(11, 100, 80, bd=16),
              dict(bit_depth=16, reversible=True), encode),
}


@pytest.mark.parametrize('name', list(CASES))
def test_encode_gpu_matches_jax(name):
    make, kw, ref = CASES[name]
    img = make()
    got = openjph_tpu_torch.encode_gpu(img, device='cpu', **kw)
    assert got == ref(img, **kw)
    if kw['reversible']:
        planes = openjph_tpu_torch.decode_gpu(got, device='cpu')
        want = [img[..., c] for c in range(img.shape[-1])] \
            if img.ndim == 3 else [img]
        assert len(planes) == len(want)
        for p, w in zip(planes, want):
            assert np.array_equal(p, w)


def test_package_encode_entry_point():
    make, kw, _ = CASES['77x65_bs32']
    img = make()
    assert openjph_tpu_torch.encode(img, device='cpu', **kw) \
        == encode(img, **kw)


def _plans(shape, nc, **kw):
    enc = build_encoder(shape, nc, _CPU_ENCODER, **kw)
    plan = enc._build_enc_plan(build_tile(enc.hdr, 0,
                                          build_tile_grid(enc.siz)[0]))
    jenc = jax_build_encoder(shape, nc, encoder_cls=TpuEncoder, **kw)
    jplan = jenc._build_enc_plan(jax_build_tile(
        jenc.hdr, 0, jax_tile_grid(jenc.siz)[0]))
    return plan, jplan


@pytest.mark.parametrize('shape,nc,kw', [
    ((65, 77), 1, dict(num_decomps=3, block_size=(32, 32))),
    ((77, 130), 3, dict(reversible=False, num_decomps=3)),
])
def test_plan_matches_jax(shape, nc, kw):
    plan, jplan = _plans(shape, nc, **kw)
    assert len(plan.groups) == len(jplan.groups)
    for g, j in zip(plan.groups, jplan.groups):
        assert (g.gid, g.w, g.h, g.strips, g.lanes, g.p, g.thresh,
                g.caps) == (j.gid, j.w, j.h, j.strips, j.lanes, j.p,
                            j.thresh, j.caps)
        assert g.n_pad >= len(g.lanes) and g.n_pad % 8 == 0
    assert plan.bands == jplan.bands
    assert plan.mct == jplan.mct
    # the port's level specs also carry the level's DFS type (all
    # BIDIR here); the wavelet kernel objects are each package's own
    # class
    assert [c[:4] + (tuple(r[:3] for r in c[4]),) for c in plan.comps] \
        == [c[:5] for c in jplan.comps]
    assert {r[3] for c in plan.comps for r in c[4]} == {mk.Dfs.BIDIR_DWT}
    assert [c[5].steps for c in plan.comps] == \
        [c[5].steps for c in jplan.comps]


def test_two_frame_runner_matches_single_frames():
    """Two different frames of one geometry in one runner call: each
    frame's stream equals its own single-frame encode."""
    frames = [_img(12, 77, 65), _img(13, 77, 65)]
    kw = dict(reversible=True, num_decomps=3, block_size=(32, 32))
    enc = build_encoder((65, 77), 1, _CPU_ENCODER, **kw)
    geom = build_tile(enc.hdr, 0, build_tile_grid(enc.siz)[0])
    plan = enc._build_enc_plan(geom)
    runner = ep._make_enc_runner(plan, 2, 'cpu')
    stack = torch.from_numpy(np.stack(
        [ep._narrow_tile_plane(enc.siz, geom, 0, f) for f in frames]))
    cats, aux = runner(stack)
    codeds = [ep._empty_coded(geom, 1) for _ in frames]
    enc._consume_outs(plan, cats, aux, codeds)
    for f, coded in zip(frames, codeds):
        got = enc.assemble([ep._tile_packets(enc, geom, coded)])
        assert got == openjph_tpu_torch.encode_gpu(f, device='cpu', **kw)


def _dfs_encoder(m, make):
    """A 32x32 encoder with a HORZ, VERT, BIDIR decomposition structure,
    built from markers module ``m`` by ``make``."""
    siz = m.Siz()
    siz.xsiz, siz.ysiz = 32, 32
    siz.comps = [m.CompInfo(8, False, 1, 1)]
    dfs = m.Dfs.from_types(0, [m.Dfs.HORZ_DWT, m.Dfs.VERT_DWT,
                               m.Dfs.BIDIR_DWT])
    cod = m.Cod(num_decomps=3, wavelet_kern=m.DWT_REV53)
    cocs = {0: m.Cod(num_decomps=3, wavelet_kern=m.DWT_REV53,
                     comp_idx=0, dfs_idx=0)}
    return make(siz, cod, cocs=cocs, dfs_list=[dfs])


def test_dfs_encode_matches_jax_host_encoder():
    """Part-2 DFS structures are in the slice: the stream is the JAX
    host Encoder's (tests/test_torch_dfs_encode.py has the other cases)."""
    img = _img(15, 32, 32)
    got = _dfs_encoder(mk, _CPU_ENCODER).encode([img])
    assert got == _dfs_encoder(jmk, JaxEncoder).encode([img])
    assert np.array_equal(openjph_tpu_torch.decode(got, device='cpu')[0],
                          img)


def test_configurations_outside_the_slice_raise():
    """Configurations the early slices refused now encode as the JAX
    package does: multi-pass (ROADMAP 12; tests/test_torch_multipass_
    encode.py has the other cases), and 30-bit samples, whose bands
    reach 31 bit planes (ROADMAP 7c).  A configuration the JAX package
    refuses raises its error."""
    img = _img(14, 40, 48)
    got = openjph_tpu_torch.encode_gpu(img, device='cpu', ht_passes=2)
    ref = encode(img, ht_passes=2)
    assert got[got.index(b'\xff\x90'):] == ref[ref.index(b'\xff\x90'):]
    with pytest.raises(OjphError, match='ht_passes must be 1, 2 or 3'):
        openjph_tpu_torch.encode_gpu(img, device='cpu', ht_passes=4)
    wide = np.random.RandomState(14).randint(0, 1 << 30, (40, 48))
    got = openjph_tpu_torch.encode_gpu(wide, device='cpu', bit_depth=30)
    ref = encode(wide, bit_depth=30)
    assert got[got.index(b'\xff\x90'):] == ref[ref.index(b'\xff\x90'):]


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    img = _img(16, 40, 48)
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.encode_gpu(img)
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.encode(img)
    with pytest.raises(RuntimeError, match='CUDA'):
        ep._make_enc_runner(_plans((48, 40), 1)[0])


def test_cpu_encode_launches_no_kernel():
    E.reset_launches()
    openjph_tpu_torch.encode_gpu(_img(17, 40, 48), device='cpu')
    assert sum(E.LAUNCHES.values()) == 0
