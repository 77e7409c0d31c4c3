"""Part-2 DFS encode through the port's fused frame encode (GpuEncoder on
the CPU), held byte for byte against the JAX package's host encoder
(openjph_tpu.codec.Encoder) with the same arguments: the cases of
tests/test_atk_dfs.py (the five DFS structures at 93x61, an odd canvas
origin, 9/7, RGB with the colour transform, several tiles, an ATK
kernel with a DFS).  Every stream also decodes back through the port's
CPU decode, bit-exact to the image for the reversible ones.
"""
import numpy as np
import pytest

from openjph_tpu import codec as jcodec
from openjph_tpu.core import markers as jmk
from openjph_tpu.core.atk import AtkKernel as JAtkKernel

import openjph_tpu_torch
from openjph_tpu_torch.core import markers as mk
from openjph_tpu_torch.core.atk import AtkKernel
from openjph_tpu_torch.gpu import encode_pipeline as ep

H_, V_, B_, N_ = (mk.Dfs.HORZ_DWT, mk.Dfs.VERT_DWT, mk.Dfs.BIDIR_DWT,
                  mk.Dfs.NO_DWT)

# tests/test_atk_dfs.py:REV_KERNELS[1], a 4-step reversible cascade
_ATK = dict(index=2, reversible=True,
            steps=((1, 16, 5), (-1, 8, 4), (1, 2, 2), (-1, 1, 1)),
            coeff_type=0)


def _encoders(w, h, types, nc=1, xo=0, yo=0, tile=None, reversible=True,
              atk=False, mc_trans=0, **kw):
    """(port GpuEncoder on the CPU, JAX codec.Encoder), each built from
    its own package's marker classes with the same arguments: one DFS
    shared by every component, signalled per component by a COC
    (tests/test_atk_dfs.py::_dfs_encoder)."""
    out = []
    for m, atk_cls, make in (
            (mk, AtkKernel, lambda *a, **k: ep.GpuEncoder(*a, device='cpu',
                                                          **k)),
            (jmk, JAtkKernel, jcodec.Encoder)):
        siz = m.Siz()
        siz.xsiz, siz.ysiz = w + xo, h + yo
        siz.xosiz, siz.yosiz = xo, yo
        if tile is not None:
            siz.xtsiz, siz.ytsiz = tile
        siz.comps = [m.CompInfo(8, False, 1, 1) for _ in range(nc)]
        wk = (_ATK['index'] if atk else
              m.DWT_REV53 if reversible else m.DWT_IRV97)
        nd = len(types)
        cod = m.Cod(num_decomps=nd, wavelet_kern=wk, mc_trans=mc_trans)
        cocs = {c: m.Cod(num_decomps=nd, wavelet_kern=wk, comp_idx=c,
                         dfs_idx=0) for c in range(nc)}
        extra = dict(kw)
        if atk:
            extra['atks'] = [atk_cls(**_ATK)]
        out.append(make(siz, cod, cocs=cocs,
                        dfs_list=[m.Dfs.from_types(0, types)], **extra))
    return out


def _image(seed, h, w, nc=1):
    rng = np.random.RandomState(seed)
    shape = (h, w) if nc == 1 else (h, w, nc)
    return rng.randint(0, 256, shape).astype(np.int32)


# name -> (image, _encoders arguments)
CASES = {
    'horz3': ((93, 61), dict(types=[H_] * 3)),
    'vert3': ((93, 61), dict(types=[V_] * 3)),
    'bidir_horz_vert': ((93, 61), dict(types=[B_, H_, V_])),
    'none_bidir_horz': ((93, 61), dict(types=[N_, B_, H_])),
    'hhvvb': ((93, 61), dict(types=[H_, H_, V_, V_, B_])),
    # an odd canvas origin flips the lifting phase on every level
    'odd_origin': ((64, 47), dict(types=[H_, V_, B_], xo=3, yo=5)),
    'irv97': ((93, 61), dict(types=[V_, B_, H_], reversible=False,
                             base_delta=1 / 1024.)),
    'rgb_mct': ((40, 52, 3), dict(types=[H_, B_], nc=3, mc_trans=1)),
    'tiles': ((75, 90), dict(types=[V_, H_, B_], tile=(48, 40))),
    'atk_dfs': ((93, 61), dict(types=[H_, B_, V_], atk=True)),
}


@pytest.mark.parametrize('name', list(CASES))
def test_dfs_encode_matches_jax_encoder(name):
    shape, kw = CASES[name]
    img = _image(len(name), *shape)
    h, w = shape[:2]
    nc = shape[2] if len(shape) == 3 else 1
    planes = [img] if nc == 1 else [img[..., c] for c in range(nc)]
    port, ref = _encoders(w, h, **kw)
    got = port.encode(planes)
    assert got == ref.encode(planes)
    out = openjph_tpu_torch.decode(got, device='cpu')
    assert [p.shape for p in out] == [(h, w)] * nc
    if kw.get('reversible', True):
        for p, want in zip(out, planes):
            assert np.array_equal(p, want)
    else:
        # 9/7 (tests/test_atk_dfs.py's distortion bound)
        assert np.mean((out[0] - img) ** 2.0) < 2.0
