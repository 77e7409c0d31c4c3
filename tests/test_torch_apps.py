"""The port's CLI apps (openjph_tpu_torch.apps.compress / expand) against
the JAX package's (openjph_tpu.apps), on the CPU (``device='cpu'``): the
same input files and flags give byte-identical .j2c files (the whole
file: both write the same version COM marker) and byte-identical
expanded files.  Without a card the port's CLIs fail and write nothing:
no host fallback.  Streams of more than 30 bit planes go through them as
through the entry points."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openjph_tpu import decode as jax_decode
from openjph_tpu import encode as jax_encode
from openjph_tpu.apps import compress as jax_compress
from openjph_tpu.apps import expand as jax_expand
from openjph_tpu_torch import decode, encode_gpu
from openjph_tpu_torch.apps import compress, expand
from openjph_tpu_torch.utils import imageio


def _img(rng, shape, hi=256):
    return rng.randint(0, hi, size=shape).astype(np.int32)


def _both(tmp_path, src, cargs, ext, eargs=()):
    """Compress ``src`` with both CLIs and expand each .j2c with its own
    CLI to ``ext``; asserts both pairs of files are byte-identical and
    returns the port's expanded file."""
    j2c = {}
    for name, mod, kw in (('jax', jax_compress, {}),
                          ('port', compress, {'device': 'cpu'})):
        j2c[name] = str(tmp_path / f'{name}.j2c')
        assert mod.main(['-i', src, '-o', j2c[name]] + list(cargs),
                        **kw) == 0
    with open(j2c['jax'], 'rb') as a, open(j2c['port'], 'rb') as b:
        assert b.read() == a.read()
    return _expand_both(tmp_path, j2c['jax'], ext, eargs)


def _expand_both(tmp_path, j2c, ext, eargs=()):
    out = {}
    for name, mod, kw in (('jax', jax_expand, {}),
                          ('port', expand, {'device': 'cpu'})):
        out[name] = str(tmp_path / f'{name}_out{ext}')
        assert mod.main(['-i', j2c, '-o', out[name]] + list(eargs),
                        **kw) == 0
    with open(out['jax'], 'rb') as a, open(out['port'], 'rb') as b:
        assert b.read() == a.read()
    return out['port']


def test_cli_gray(tmp_path, rng):
    img = _img(rng, (32, 48))
    src = str(tmp_path / 'in.pgm')
    imageio.write_pnm(src, img.astype(np.uint8))
    dst = _both(tmp_path, src, ['-reversible', 'true', '-num_decomps', '2'],
                '.pgm')
    assert np.array_equal(imageio.read_pnm(dst).astype(np.int32), img)


def test_cli_rgb_tileparts_tlm(tmp_path, rng):
    img = _img(rng, (32, 48, 3))
    src = str(tmp_path / 'in.ppm')
    imageio.write_pnm(src, img.astype(np.uint8))
    dst = _both(tmp_path, src, ['-reversible', 'true', '-num_decomps', '2',
                                '-tileparts', 'R', '-tlm_marker', 'true',
                                '-prog_order', 'RPCL'], '.ppm')
    assert np.array_equal(imageio.read_pnm(dst).astype(np.int32), img)


def test_cli_raw_signed_12bit(tmp_path, rng):
    img = rng.randint(-(1 << 11), 1 << 11, size=(24, 40)).astype(np.int32)
    src = str(tmp_path / 'in.raw')
    imageio.write_raw(src, img, 12, True)
    dst = _both(tmp_path, src, ['-reversible', 'true', '-num_decomps', '1',
                                '-dims', '{40,24}', '-bit_depth', '12',
                                '-signed', 'true'], '.raw')
    assert np.array_equal(imageio.read_raw(dst, 40, 24, 12, True), img)


def test_cli_yuv_420(tmp_path, rng):
    comps = [_img(rng, (32, 48)), _img(rng, (16, 24)), _img(rng, (16, 24))]
    src = str(tmp_path / 'in.yuv')
    imageio.write_yuv(src, comps, 8)
    dst = _both(tmp_path, src, ['-reversible', 'true', '-num_decomps', '1',
                                '-dims', '{48,32}', '-num_comps', '3',
                                '-bit_depth', '8',
                                '-downsamp', '{1,1},{2,2}'], '.yuv')
    with open(src, 'rb') as a, open(dst, 'rb') as b:
        assert b.read() == a.read()


def test_cli_tiff(tmp_path, rng):
    img = _img(rng, (24, 40, 3))
    src = str(tmp_path / 'in.tif')
    imageio.write_tiff(src, img.astype(np.uint8))
    dst = _both(tmp_path, src, ['-reversible', 'true', '-num_decomps', '1'],
                '.tif')
    assert np.array_equal(imageio.read_tiff(dst).astype(np.int32), img)


@pytest.fixture(scope='module')
def gray_j2c(tmp_path_factory):
    """A 3-level gray stream of a 32x32 frame, from the JAX package's
    encoder."""
    img = _img(np.random.RandomState(3), (32, 32))
    path = str(tmp_path_factory.mktemp('gray') / 'gray.j2c')
    with open(path, 'wb') as f:
        f.write(jax_encode(img, reversible=True, num_decomps=3))
    return path


@pytest.mark.parametrize('skip,shape', [('1', (16, 16)), ('2,1', (16, 16)),
                                        ('2,0', (8, 8))])
def test_cli_skip_res(tmp_path, gray_j2c, skip, shape):
    """-skip_res x[,y]: x resolutions skipped when reading, y when
    reconstructing (GpuDecoder's skipped_res_for_read / _recon; a y of 0
    means y = x)."""
    dst = _expand_both(tmp_path, gray_j2c, '.pgm', ['-skip_res', skip])
    assert imageio.read_pnm(dst).shape == shape


@pytest.mark.parametrize('ext', ['.pfm', '.rawl', '.yuv', '.tif'])
def test_cli_expand_formats(tmp_path, gray_j2c, ext):
    _expand_both(tmp_path, gray_j2c, ext)


def test_cli_bad_args(tmp_path):
    missing = ['-i', str(tmp_path / 'missing.j2c'),
               '-o', str(tmp_path / 'o.pgm')]
    for argv in (['-i'], ['-nonsense', 'x', '-i', 'a', '-o', 'b']):
        assert compress.main(argv, device='cpu') == \
            jax_compress.main(argv) == 1
    assert expand.main(missing, device='cpu') == jax_expand.main(missing) == 1
    assert expand.main(['-i', 'a'], device='cpu') == 1
    assert compress.main(['-h']) == expand.main([]) == 0


def test_cli_without_a_card_fails_and_writes_nothing(tmp_path, rng,
                                                     gray_j2c, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    src = str(tmp_path / 'in.pgm')
    imageio.write_pnm(src, _img(rng, (16, 16)).astype(np.uint8))
    out = str(tmp_path / 'out.j2c')
    assert compress.main(['-i', src, '-o', out, '-reversible', 'true']) == 1
    assert not os.path.exists(out)
    out = str(tmp_path / 'out.pgm')
    assert expand.main(['-i', gray_j2c, '-o', out]) == 1
    assert not os.path.exists(out)
    assert 'CUDA is not available' in capsys.readouterr().err


def test_cli_refused_streams_are_reported_not_coded(tmp_path, rng):
    """More than 30 bit planes (ROADMAP 7c), once refused, go through the
    CLIs as through the entry points: a 29-bit raw file compresses to
    the port's encode_gpu stream (the JAX package's from the first SOT),
    and a 32-bit stream expands to the raw file of the port's decode
    (the JAX package's decode), without a host fallback."""
    img = rng.randint(0, 1 << 29, (16, 16)).astype(np.int32)
    src = str(tmp_path / 'in.raw')
    imageio.write_raw(src, img, 29, False)
    out = str(tmp_path / 'out.j2c')
    assert compress.main(['-i', src, '-o', out, '-dims', '{16,16}',
                          '-bit_depth', '29', '-reversible', 'true'],
                         device='cpu') == 0
    with open(out, 'rb') as f:
        got = f.read()
    assert got == encode_gpu(img, device='cpu', bit_depth=29,
                             reversible=True)
    ref = jax_encode(img, bit_depth=29, reversible=True)
    assert got[got.index(b'\xff\x90'):] == ref[ref.index(b'\xff\x90'):]
    wide = str(tmp_path / 'wide.j2c')
    img = rng.randint(0, 1 << 32, (16, 16), dtype=np.int64)
    with open(wide, 'wb') as f:
        f.write(jax_encode(img, bit_depth=32, reversible=True))
    out = str(tmp_path / 'out.raw')
    assert expand.main(['-i', wide, '-o', out], device='cpu') == 0
    planes = decode(open(wide, 'rb').read(), device='cpu')
    assert planes[0].dtype == np.int64
    assert np.array_equal(planes[0], jax_decode(open(wide, 'rb').read())[0])
    ref = str(tmp_path / 'ref.raw')
    imageio.write_raw(ref, planes[0], 32, False)
    with open(out, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    assert np.array_equal(imageio.read_raw(out, 16, 16, 32, False), img)


def test_importing_the_apps_and_utils_loads_no_jax():
    code = ('import sys\n'
            'import openjph_tpu_torch.apps.compress, '
            'openjph_tpu_torch.apps.expand\n'
            'import openjph_tpu_torch.apps.stream_expand\n'
            'import openjph_tpu_torch.utils.imageio, '
            'openjph_tpu_torch.utils.trace\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "openjph_tpu")]\n'
            'assert not bad, bad\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, '-c', code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
