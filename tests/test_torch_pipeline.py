"""The port's fused frame decode (openjph_tpu_torch.decode_gpu) on the
CPU, in both runner modes, held against openjph_tpu.decode_tpu on the
same streams: reversible streams bit-exact, 9/7 within +-1 (the JAX
package's own tolerance for irreversible decode).  Also the guards of
the port: it imports neither JAX nor the JAX package, its entry points
run on CUDA unless told otherwise and raise without it, and streams
outside this slice raise NotImplementedError.
"""
import ast
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openjph_tpu import codec, decode_tpu, encode
from openjph_tpu.core import markers as mk
from openjph_tpu.core.markers import Dfs

import openjph_tpu_torch
from openjph_tpu_torch.gpu import block_decode_cuda as K
from openjph_tpu_torch.gpu import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(seed, h, w):
    rng = np.random.RandomState(seed)
    ramp = (np.arange(w)[None, :] + np.arange(h)[:, None]) % 256
    noise = rng.randint(0, 256, size=(h, w))
    return np.where((np.arange(h)[:, None] // 8) % 2 == 0, ramp,
                    noise).astype(np.int32)


def _dfs_stream(seed):
    """Part-2 DFS: one horizontal-only, one vertical-only and one
    two-way level."""
    siz = mk.Siz()
    siz.xsiz, siz.ysiz = 32, 32
    siz.comps = [mk.CompInfo(8, False, 1, 1)]
    dfs = Dfs.from_types(0, [Dfs.HORZ_DWT, Dfs.VERT_DWT, Dfs.BIDIR_DWT])
    cod = mk.Cod(num_decomps=3, wavelet_kern=mk.DWT_REV53)
    cocs = {0: mk.Cod(num_decomps=3, wavelet_kern=mk.DWT_REV53,
                      comp_idx=0, dfs_idx=0)}
    return codec.Encoder(siz, cod, cocs=cocs, dfs_list=[dfs]).encode(
        [_img(seed, 32, 32)])


def _rgb(seed, h, w):
    return [_img(seed + c, h, w) for c in range(3)]


# name -> (stream builder, skip_res, exact).  Shapes keep the number of
# distinct codeblock shapes low: the JAX reference compiles its graph
# per lane-group shape, and that compile is most of this file's time.
STREAMS = {
    'gray256_nd5': (lambda: encode([_img(1, 256, 256)], reversible=True,
                                   num_decomps=5), 0, True),
    'gray77x65': (lambda: encode([_img(2, 65, 77)], reversible=True,
                                 num_decomps=1), 0, True),
    'rgb_rct': (lambda: encode(_rgb(3, 48, 64), reversible=True,
                               num_decomps=2, block_size=(32, 32)),
                0, True),
    'rgb_ict97': (lambda: encode(_rgb(4, 48, 64), reversible=False,
                                 num_decomps=2, block_size=(32, 32)),
                  0, False),
    'tiles': (lambda: encode([_img(5, 64, 96)], reversible=True,
                             num_decomps=2, tile_size=(32, 32),
                             block_size=(16, 16)), 0, True),
    'skip1': (lambda: encode([_img(6, 64, 64)], reversible=True,
                             num_decomps=2, block_size=(16, 16)),
              1, True),
    'entry_sample': (lambda: open(os.path.join(
        REPO, 'bench_data', 'entry_sample.j2c'), 'rb').read(), 0, True),
    'dfs_hv': (lambda: _dfs_stream(7), 0, True),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    build, skip, exact = STREAMS[name]
    stream = build()
    return stream, skip, exact, decode_tpu(stream, skip_res=skip)


def _assert_close(got, ref, exact):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if exact:
            assert np.array_equal(g, r)
        else:
            assert np.abs(g.astype(np.int64) - r).max() <= 1


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
@pytest.mark.parametrize('name', list(STREAMS))
def test_decode_gpu_matches_decode_tpu(name, raw):
    stream, skip, exact, ref = _case(name)
    got = openjph_tpu_torch.decode_gpu(stream, device='cpu', skip_res=skip,
                                       raw=raw)
    _assert_close(got, ref, exact)


def test_package_decode_entry_point():
    stream, _, _, ref = _case('gray77x65')
    _assert_close(openjph_tpu_torch.decode(stream, device='cpu'), ref, True)


@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'dense'])
def test_two_frame_runner_matches_decode_tpu(raw):
    """Two different frames of one geometry in one runner call."""
    s1 = _case('gray77x65')[0]
    # a second image whose plan has the same key (same lane groups and
    # word buckets), as frames of one video do
    s2 = encode([_img(10, 65, 77)], reversible=True, num_decomps=1)
    pairs = []
    for s in (s1, s2):
        d = tp.GpuDecoder(s, device='cpu', raw=raw)
        pairs.append((d, tp._build_plan(d)))
    assert pairs[0][1].key == pairs[1][1].key
    args = tp._pack_device(pairs) if raw else tp._pack_dense(pairs)
    runner = tp._make_runner(pairs[0][1], 2, 'cpu', raw)
    errs, outs = runner(*tp.upload(args, 'cpu'))
    assert not errs.any()
    for f, s in enumerate((s1, s2)):
        ref = decode_tpu(s)[0]
        assert outs[0][0].dtype == torch.uint8
        assert np.array_equal(outs[0][0][f].numpy().astype(np.int32), ref)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, 'openjph_tpu_torch')
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def _forbidden(mod):
    top = mod.split('.')[0]
    return top in ('jax', 'jaxlib', 'openjph_tpu')


def test_port_imports_neither_jax_nor_the_jax_package():
    seen = 0
    names = set()
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        seen += 1
        names.add(os.path.relpath(path, REPO))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad = [a.name for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                bad = [node.module] if _forbidden(node.module or '') else []
            else:
                continue
            assert not bad, f'{path}:{node.lineno} imports {bad}'
    assert seen > 10
    # the scale-out package is walked too
    assert {os.path.join('openjph_tpu_torch', 'parallel', f + '.py')
            for f in ('mesh', 'tiles', 'dwt_sharded', 'multihost')} <= names
    # ... and the refinement-pass encoder (K5) and its wrapper
    assert {os.path.join('openjph_tpu_torch', 'gpu', f + '.py')
            for f in ('block_refine_encode', 'block_refine_encode_cuda')} \
        <= names


def test_packaging_lists_every_port_package():
    """An installed (not editable) port has every subpackage that the
    source tree holds."""
    import tomllib
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as fh:
        listed = set(tomllib.load(fh)['tool']['setuptools']['packages'])
    root = os.path.join(REPO, 'openjph_tpu_torch')
    found = {os.path.relpath(d, REPO).replace(os.sep, '.')
             for d, _, files in os.walk(root) if '__init__.py' in files}
    assert 'openjph_tpu_torch.parallel' in found
    assert found <= listed, sorted(found - listed)


def test_importing_the_port_loads_no_jax():
    code = ('import sys, openjph_tpu_torch, openjph_tpu_torch.gpu.pipeline\n'
            'import openjph_tpu_torch.gpu.encode_pipeline\n'
            'import openjph_tpu_torch.gpu.block_encode_cuda\n'
            'import openjph_tpu_torch.gpu.block_refine_cuda\n'
            'import openjph_tpu_torch.gpu.block_refine_encode_cuda\n'
            'import openjph_tpu_torch.gpu.staging\n'
            'import openjph_tpu_torch.parallel.tiles\n'
            'import openjph_tpu_torch.parallel.dwt_sharded\n'
            'import openjph_tpu_torch.parallel.multihost\n'
            'import openjph_tpu_torch.fuzzing.fuzz_decode\n'
            'import openjph_tpu_torch.fuzzing.fuzz_encode\n'
            'import openjph_tpu_torch.entry\n'
            'from openjph_tpu_torch.parallel import (MosaicDecoder,\n'
            '    MosaicEncoder)\n'
            'from openjph_tpu_torch import (VideoDecoder, VideoEncoder,\n'
            '    decode_gpu_batch, encode_gpu_batch)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "openjph_tpu")]\n'
            'assert not bad, bad\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    stream = _case('gray77x65')[0]
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.decode_gpu(stream)
    with pytest.raises(RuntimeError, match='CUDA'):
        openjph_tpu_torch.GpuDecoder(stream)
    with pytest.raises(RuntimeError, match='CUDA'):
        tp._make_runner(tp._build_plan(
            tp.GpuDecoder(stream, device='cpu')))


def test_resilient_decode_of_a_clean_stream_equals_strict():
    img = _img(8, 48, 40)
    plain = encode([img], reversible=True, num_decomps=2)
    for raw in (True, False):
        strict = openjph_tpu_torch.decode(plain, device='cpu', raw=raw)
        res = openjph_tpu_torch.decode(plain, device='cpu', raw=raw,
                                       resilient=True)
        assert np.array_equal(strict[0], img)
        assert np.array_equal(res[0], strict[0])


def test_streams_outside_the_slice_raise():
    """Bands of 31 or more bit planes (tests/test_highbit.py's streams),
    once outside the slice, decode in both modes to the JAX package's
    host-decoder output, value and dtype (ROADMAP 7c)."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 1 << 31, (32, 32)).astype(np.int64)
    wide = encode([img], bit_depth=31, reversible=True, num_decomps=2)
    ref = codec.decode(wide)
    assert np.array_equal(ref[0], img)
    for resilient in (False, True):
        got = openjph_tpu_torch.GpuDecoder(wide, device='cpu',
                                           resilient=resilient).decode()
        assert got[0].dtype == ref[0].dtype
        assert np.array_equal(got[0], ref[0])


def test_cpu_decode_launches_no_kernel():
    K.reset_launches()
    openjph_tpu_torch.decode_gpu(_case('gray77x65')[0], device='cpu')
    assert sum(K.LAUNCHES.values()) == 0
