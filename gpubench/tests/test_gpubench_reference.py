"""The plain reference against the port's CPU path (its kernels' plain
PyTorch versions) on a small frame of each configuration: the same
codestream bytes from the same frame, and the same frames decoded (9/7
within the port's tolerance of 1)."""
import numpy as np
import pytest

from gpubench.harness import manifest
from gpubench.inputs.frames import make_frames
from gpubench.inputs.streams import encode_kwargs, frame_dtype
from gpubench.reference.htj2k import codec

CONFIGS = ('gray8_2k_rev53', 'rgb8_2k_97ict')


def _config(name):
    cell = {'gray8_2k_rev53': 'gray8_2k_rev53.decode_stream',
            'rgb8_2k_97ict': 'rgb8_2k_97ict.decode_frame'}[name]
    return manifest.cell(cell).config


@pytest.mark.parametrize('name', CONFIGS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    import openjph_tpu_torch as port
    cfg = _config(name)
    kw = dict(encode_kwargs(cfg), num_decomps=3)
    frame = make_frames(2**31 + 3, 1, 96, 160, cfg['components'],
                        cfg['bit_depth'])[0].astype(frame_dtype(cfg))
    ref = codec.encode(frame, **kw)
    assert port.encode(frame, device='cpu', **kw) == ref
    want = codec.decode(ref)
    got = port.decode(ref, device='cpu')
    tol = 0 if cfg['reversible'] else 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.astype(np.int64) - w).max() <= tol
    if cfg['reversible']:
        planes = [frame] if frame.ndim == 2 else \
            [frame[..., c] for c in range(frame.shape[-1])]
        for p, w in zip(planes, want):
            assert np.array_equal(p, w)


def test_frames_are_seeded():
    a = make_frames(12345678901, 2, 32, 48, 3)
    b = make_frames(12345678901, 2, 32, 48, 3)
    c = make_frames(-5, 2, 32, 48, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].shape == (32, 48, 3) and a[0].min() >= 0 \
        and a[0].max() <= 255
