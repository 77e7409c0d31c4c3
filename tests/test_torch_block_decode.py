"""The HT cleanup decoder of the port (gpu/block_decode_cuda.py) in both
reader modes, held against the JAX package's decoders on the same
inputs.

On the CPU the wrapper runs the kernel's plain PyTorch versions:
dense readers (K1) -> gpu/block_decode.decode_cleanup_core; raw
readers (K2) -> gpu/unstuff.raw_to_dense, then the same.  They are
compared with tpu/block_decode.decode_cleanup on the dense words that
TpuDecoder._group_arrays builds, bit-exact on rows < 2*qhl (rows past
a lane's quad-row limit are cropped by the caller), with equal error
flags; one small case goes against the Pallas raw-mode kernel in
interpret mode.  The plain decoder's first step (MEL / VLC / UVLC, the
CUDA kernel's phase 1) is also held against the JAX package's _step1 on
its own.  The CUDA kernel itself is held against the plain versions by
the test marked ``cuda``, which runs only where a card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openjph_tpu import encode
from openjph_tpu.tpu import pipeline as jp
from openjph_tpu.tpu.block_decode import _step1 as jax_step1
from openjph_tpu.tpu.block_decode import decode_cleanup as jax_decode
from openjph_tpu.tpu.block_decode_pallas import decode_cleanup_pallas_raw
from openjph_tpu.tpu.unstuff import _lane_words_fwd, _lane_words_rev

from openjph_tpu_torch.gpu import block_decode as plain
from openjph_tpu_torch.gpu import block_decode_cuda as K
from openjph_tpu_torch.gpu import pipeline as tp


def _stream(seed, shape, bs, noise, nd=2):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape).astype(np.int32)
    # heavy noise on every third row drives stuffing events
    img[::3] = np.clip(img[::3] + rng.randint(-noise, noise,
                                              img[::3].shape), 0, 255)
    return encode([img], bit_depth=8, reversible=True,
                  block_size=bs if isinstance(bs, tuple) else (bs, bs),
                  num_decomps=nd)


# one lane-group shape each where possible (the JAX reference compiles
# per shape); bs64's odd frame gives odd-width and odd-height blocks;
# w128 (128x32 blocks) has rows of 40 quads, more than a warp's 32 lanes,
# and h128 (32x128 blocks) 24 quad rows of 16 quads
CASES = {'bs32': (5, (128, 128), 32, 90), 'bs16': (7, (64, 64), 16, 120),
         'bs64': (9, (67, 75), 64, 40, 1),
         'w128': (11, (96, 160), (128, 32), 60),
         'h128': (12, (96, 160), (32, 128), 60)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _groups(stream, p_shift=0):
    """Per lane group: (group, JAX group arrays, JAX reference dec/err,
    the port's raw-mode inputs from its own blob)."""
    jd = jp.TpuDecoder(stream)
    jplan = jp._build_plan(jd)
    td = tp.GpuDecoder(stream, device='cpu')
    tplan = tp._build_plan(td)
    (buf,) = tp._pack_device([(td, tplan)])
    blob = torch.from_numpy(buf.view(np.uint8).copy())
    tl = sum(g.n_pad for g in tplan.groups)
    meta = _t(buf[buf.shape[0] - tl * 8:]).reshape(tl, 8)
    out = []
    s0 = 0
    for g, gd in zip(jplan.groups, jd._group_arrays(jplan)):
        p = gd['p'] + p_shift
        ref, rerr = jax_decode(jnp.asarray(gd['mel']),
                               jnp.asarray(gd['vlc']),
                               jnp.asarray(gd['ms']), jnp.asarray(p),
                               g.w, g.h)
        mg = meta[s0:s0 + g.n_pad]
        s0 += g.n_pad
        raw = [mg[:, k].contiguous() for k in range(8)]
        out.append((g, gd, p, np.asarray(ref).view(np.int32),
                    np.asarray(rerr), blob, raw))
    return out


def _check(g, qhl, got, err, ref, rerr):
    got = got.numpy()
    assert got.shape == (g.n_pad, g.h, g.w)
    live = qhl > 0
    for i in range(g.n_pad):
        hh = 2 * int(qhl[i])
        assert np.array_equal(got[i, :hh], ref[i, :hh]), \
            f'lane {i} of group w={g.w} h={g.h}'
        assert not got[i, hh:].any()
    # the reference decodes every row; the port flags errors only on
    # rows below each lane's limit, which here is every row of a live
    # lane (dead lanes are zeroed by the runner)
    assert np.array_equal(err.numpy()[live], rerr[live])


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_dense_and_raw_match_jax(name):
    for g, gd, p, ref, rerr, blob, raw in _groups(_stream(*CASES[name])):
        qhl = gd['qhl']
        d, e = K.decode_cleanup(_t(gd['mel']), _t(gd['vlc']), _t(gd['ms']),
                                _t(p), g.w, g.h, _t(qhl))
        _check(g, qhl, d, e, ref, rerr)
        assert not e.any()
        d, e = K.decode_cleanup_raw(blob, raw[0], raw[1], raw[2], raw[6],
                                    g.w, g.h, raw[7], g.words)
        assert np.array_equal(raw[7].numpy(), qhl)
        _check(g, qhl, d, e, ref, rerr)


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_step1_matches_jax(name):
    """The plain decoder's MEL / VLC / UVLC step alone: each quad's inf
    and u equal the JAX package's _step1 on every row below the lane's
    quad-row limit."""
    for g, gd, *_ in _groups(_stream(*CASES[name])):
        qw, qh = (g.w + 1) // 2, (g.h + 1) // 2
        ref_inf, ref_u = (np.asarray(a, np.int64)[:, :, :qw] for a in
                          jax_step1(jnp.asarray(gd['mel']),
                                    jnp.asarray(gd['vlc']), qw, qh))
        inf, u = plain._step1(_t(gd['mel']), _t(gd['vlc']), qw, qh)
        rows = np.arange(qh)[None, :, None] < gd['qhl'][:, None, None]
        assert np.array_equal(np.where(rows, inf.numpy(), 0),
                              np.where(rows, ref_inf, 0)), g.w
        assert np.array_equal(np.where(rows, u.numpy(), 0),
                              np.where(rows, ref_u, 0)), g.w


def test_error_flag_matches_jax():
    """p raised by 3 on every lane (missing MSBs understated): U_q
    exceeds missing_msbs + 2 on the busy lanes, and both readers flag
    exactly the lanes the reference flags."""
    flagged = 0
    for g, gd, p, ref, rerr, blob, raw in _groups(
            _stream(*CASES['bs32']), p_shift=3):
        qhl = gd['qhl']
        d, e = K.decode_cleanup(_t(gd['mel']), _t(gd['vlc']), _t(gd['ms']),
                                _t(p), g.w, g.h, _t(qhl))
        _check(g, qhl, d, e, ref, rerr)
        d, e = K.decode_cleanup_raw(blob, raw[0], raw[1], raw[2],
                                    _t(p), g.w, g.h, raw[7], g.words)
        _check(g, qhl, d, e, ref, rerr)
        flagged += int(e.sum())
    assert flagged > 0


def test_plain_raw_matches_pallas_interpret(monkeypatch):
    """The smallest raw-mode case against the Pallas kernel itself
    (interpret mode), on the JAX packer's blob with 128-lane groups."""
    monkeypatch.setattr(jp, '_USE_PALLAS', True)
    stream = _stream(3, (32, 32), 8, 120, 1)
    jd = jp.TpuDecoder(stream)
    plan = jp._build_plan(jd)
    (buf,), _ = jp._pack_device([(jd, plan)])
    tl = sum(g.n_pad for g in plan.groups)
    meta = buf[buf.shape[0] - tl * 8:].view(np.int32).reshape(tl, 8)
    words = jnp.asarray(buf)
    blob = torch.from_numpy(buf.view(np.uint8).copy())
    g = max(plan.groups, key=lambda g: len(g.members))
    s0 = sum(h.n_pad for h in plan.groups[:plan.groups.index(g)])
    mg = meta[s0:s0 + g.n_pad]
    wm, wv, ws = g.words
    off, msn, shn = (jnp.asarray(mg[:, k]) for k in range(3))
    ref, rerr = decode_cleanup_pallas_raw(
        _lane_words_fwd(words, off + msn, wm),
        _lane_words_rev(words, off + msn, shn, wv),
        _lane_words_fwd(words, off, ws), jnp.asarray(mg[:, 6]), g.w, g.h,
        jnp.asarray(mg[:, 7]), msn, shn, interpret=True)
    col = [torch.from_numpy(mg[:, k].copy()) for k in range(8)]
    d, e = K.decode_cleanup_raw(blob, col[0], col[1], col[2], col[6], g.w,
                                g.h, col[7], g.words)
    _check(g, mg[:, 7], d, e, np.asarray(ref).view(np.int32),
           np.asarray(rerr))


def test_raw_lane_outside_blob_is_flagged():
    blob = torch.full((64,), 0x0F, dtype=torch.uint8)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    d, e = K.decode_cleanup_raw(blob, i32([0, 60, -1]), i32([0, 8, 0]),
                                i32([1, 1, 1]), i32([30, 30, 30]), 4, 4,
                                i32([2, 2, 2]), (8, 8, 8))
    assert e.tolist() == [False, True, True]
    assert not d[1:].any()


def test_raw_lane_past_the_suffix_cap_is_flagged():
    """A MEL / VLC suffix longer than HTJ2K's cap (4,079 bytes) does not
    fit the kernel's shared buffers: that lane is flagged and zeroed."""
    blob = torch.full((4200,), 0x0F, dtype=torch.uint8)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    d, e = K.decode_cleanup_raw(blob, i32([0, 0]), i32([0, 0]),
                                i32([1, K.MAX_SUFFIX + 1]), i32([30, 30]),
                                4, 4, i32([2, 2]), (8, 8, 8))
    assert e.tolist() == [False, True]
    assert not d[1].any()


def test_wrapper_never_falls_back_off_the_cpu():
    z = torch.zeros((8, 8), dtype=torch.int32, device='meta')
    v = torch.zeros((8,), dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError, match='no HT decoder'):
        K.decode_cleanup(z, z, z, v, 4, 4, v)
    with pytest.raises(RuntimeError, match='no HT decoder'):
        K.decode_cleanup_raw(torch.zeros(64, dtype=torch.uint8,
                                         device='meta'),
                             v, v, v, v, 4, 4, v, (8, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CASES))
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    K.reset_launches()
    for g, gd, p, ref, rerr, blob, raw in _groups(_stream(*CASES[name])):
        dense = [_t(gd[k]) for k in ('mel', 'vlc', 'ms')] + [_t(p),
                                                            _t(gd['qhl'])]
        want = K.decode_cleanup(*dense[:4], g.w, g.h, dense[4])
        got = K.decode_cleanup(*[t.to(dev) for t in dense[:4]], g.w, g.h,
                               dense[4].to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        args = [blob] + raw[:3] + [raw[6]]
        want = K.decode_cleanup_raw(*args, g.w, g.h, raw[7], g.words)
        got = K.decode_cleanup_raw(*[t.to(dev) for t in args], g.w, g.h,
                                   raw[7].to(dev), g.words)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    assert K.LAUNCHES['ht_cleanup_decode_dense'] > 0
    assert K.LAUNCHES['ht_cleanup_decode_raw'] > 0
