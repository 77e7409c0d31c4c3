"""The HT cleanup encoder of the port (gpu/block_encode_cuda.py, K3) held
against the JAX package's encoders on the same inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version
(gpu/block_encode.py).  Its dense words go through the port's host
stuffer (native.pack_from_dense) and must give, lane for lane, the bytes
of the JAX records path: tpu/block_encode.encode_cleanup_core, then
openjph_tpu.native.pack_cleanup_segments.  One small case goes against
the Pallas kernel itself in interpret mode, word for word.  The CUDA
kernel is held against the plain version by the test marked ``cuda``,
which runs only where a card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openjph_tpu import native as jnative
from openjph_tpu.tpu.block_encode import encode_cleanup_core
from openjph_tpu.tpu.block_encode_pallas import encode_cleanup_pallas_cat

from openjph_tpu_torch import native
from openjph_tpu_torch.gpu import block_encode_cuda as E
from openjph_tpu_torch.gpu.encode_pipeline import _ebucket


def _caps(w, h, kmax):
    qw, qh = (w + 1) // 2, (h + 1) // 2
    pairs = (qw + 1) // 2
    return (_ebucket(qh * pairs * 18 // 32 + 2),
            _ebucket(qh * pairs * 34 // 32 + 2),
            _ebucket(qw * qh * 4 * (kmax + 1) // 32 + 2))


def _blocks(seed, n, w, h, kmax, heights=None):
    """[n, hp, wp] uint32 sign-magnitude blocks: lane 0 a zero block,
    lane 1 a sparse one (two rows), the rest random; rows at or past a
    lane's height (``heights``) zeroed."""
    rng = np.random.RandomState(seed)
    hp, wp = ((h + 1) // 2) * 2, ((w + 3) // 4) * 4
    mag = rng.randint(0, 1 << kmax, (n, h, w)).astype(np.uint32)
    mag[0] = 0
    mag[1, 2:] = 0
    sign = rng.randint(0, 2, (n, h, w)).astype(np.uint32) << 31
    buf = np.zeros((n, hp, wp), np.uint32)
    buf[:, :h, :w] = np.where(mag != 0, sign, 0) | (mag << (31 - kmax))
    hs = np.full(n, h) if heights is None else np.asarray(heights)
    for i in range(n):
        buf[i, hs[i]:] = 0
    return buf, hs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _plain(buf, p, w, h, caps, qhl):
    cat, bits, ovf = E.encode_cleanup(_t(buf), _t(p), w, h, caps, _t(qhl))
    return cat.numpy().view(np.uint32), bits.numpy(), ovf.numpy()


def _prefixes(cat, bits, caps):
    """Each lane's used word prefix of each stream, and the words after
    it, as (used, rest) lists over (lane, stream)."""
    off = np.cumsum([0] + list(caps))
    used, rest = [], []
    for i in range(cat.shape[0]):
        for s in range(3):
            c = (int(bits[i, s]) + 31) // 32
            used.append(cat[i, off[s]:off[s] + c])
            rest.append(cat[i, off[s] + c:off[s + 1]])
    return used, rest


def _stuff(cat, bits, caps, stride):
    """The port's host stuffer over the plain version's words."""
    used, _ = _prefixes(cat, bits, caps)
    meta = np.zeros((cat.shape[0], 6), np.int64)
    cur = 0
    for i in range(cat.shape[0]):
        for s in range(3):
            meta[i, 2 * s] = cur
            meta[i, 2 * s + 1] = bits[i, s]
            cur += used[3 * i + s].size
    return native.pack_from_dense(np.concatenate(used), meta, stride)


def _records(buf, p, w, hs):
    """The JAX records path, each lane at its own height (one batch per
    height)."""
    stride = buf.shape[1] * w * 5 + 256
    pairs = ((w + 1) // 2 + 1) // 2
    segs = [None] * buf.shape[0]
    for h in np.unique(hs):
        idx = np.nonzero(hs == h)[0]
        sub = np.ascontiguousarray(buf[idx, :((h + 1) // 2) * 2])
        rec = encode_cleanup_core(jnp.asarray(sub), jnp.asarray(p[idx]),
                                  w, int(h))
        out, lens = jnative.pack_cleanup_segments(
            *[np.asarray(a).swapaxes(0, 1) for a in rec],
            np.full(len(idx), ((h + 1) // 2) * pairs, np.int64),
            out_stride=stride)
        for k, i in enumerate(idx):
            segs[i] = bytes(out[k, :lens[k]])
    return segs


@pytest.mark.parametrize('w,h,kmax,mixed', [
    (16, 16, 8, False), (32, 16, 5, False), (4, 4, 8, False),
    (6, 10, 12, False), (13, 11, 9, True)])
def test_plain_segments_match_records(w, h, kmax, mixed):
    n = 24
    heights = [[h, h - 3, h // 2, 1][i % 4] for i in range(n)] \
        if mixed else None
    buf, hs = _blocks(w * 100 + kmax, n, w, h, kmax, heights)
    p = np.full(n, 31 - kmax, np.int32)
    qhl = ((hs + 1) // 2).astype(np.int32)
    caps = _caps(w, h, kmax)
    cat, bits, ovf = _plain(buf, p, w, h, caps, qhl)
    assert not ovf.any()
    _, rest = _prefixes(cat, bits, caps)
    assert not any(r.any() for r in rest)   # zero past each used prefix
    out, lens = _stuff(cat, bits, caps, h * w * 5 + 256)
    for i, seg in enumerate(_records(buf, p, w, hs)):
        assert bytes(out[i, :lens[i]]) == seg, f'lane {i} (h={hs[i]})'


def test_plain_matches_pallas_interpret():
    """128 lanes of 16x16, mixed heights, against the Pallas kernel in
    interpret mode: bit counts, overflow flags and every word."""
    w = h = 16
    kmax = 8
    n = 128
    buf, hs = _blocks(17, n, w, h, kmax,
                      [[16, 7, 10, 4, 13][i % 5] for i in range(n)])
    p = np.full(n, 31 - kmax, np.int32)
    qhl = ((hs + 1) // 2).astype(np.int32)
    caps = _caps(w, h, kmax)
    cat, bits, ovf = _plain(buf, p, w, h, caps, qhl)
    ref_cat, ref_bits, ref_ovf = (np.asarray(a) for a in
                                  encode_cleanup_pallas_cat(
                                      jnp.asarray(buf), jnp.asarray(p), w, h,
                                      caps, qhl=jnp.asarray(qhl),
                                      interpret=True))
    assert np.array_equal(bits, ref_bits)
    assert np.array_equal(ovf, ref_ovf)
    used, _ = _prefixes(cat, bits, caps)
    ref_used, _ = _prefixes(ref_cat, ref_bits, caps)
    for i, (u, r) in enumerate(zip(used, ref_used)):
        assert np.array_equal(u, r), f'lane {i // 3} stream {i % 3}'


def test_overflow_is_flagged():
    """Caps below the need: the lanes whose MagSgn bits pass the cap are
    flagged, and their bit counts still give the need."""
    buf, _ = _blocks(5, 4, 16, 16, 8)
    p = np.full(4, 23, np.int32)
    qhl = np.full(4, 8, np.int32)
    cat, bits, ovf = _plain(buf, p, 16, 16, (32, 32, 32), qhl)
    assert ovf[2:].all() and cat.shape == (4, 96)
    assert (bits[2:, 2] > 32 * 32).all()


def test_wrapper_never_falls_back_off_the_cpu():
    z = torch.zeros((8, 4, 4), dtype=torch.int32, device='meta')
    v = torch.zeros((8,), dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError, match='no HT encoder'):
        E.encode_cleanup(z, v, 4, 4, (32, 32, 32), v)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    E.reset_launches()
    for w, h, kmax, heights in ((16, 16, 8, None), (13, 11, 9, [11, 3, 6])):
        n = 48
        hh = None if heights is None else [heights[i % 3] for i in range(n)]
        buf, hs = _blocks(w, n, w, h, kmax, hh)
        args = [_t(buf), _t(np.full(n, 31 - kmax, np.int32))]
        qhl = _t(((hs + 1) // 2).astype(np.int32))
        caps = _caps(w, h, kmax)
        want = E.encode_cleanup(*args, w, h, caps, qhl)
        got = E.encode_cleanup(*[t.to(dev) for t in args], w, h, caps,
                               qhl.to(dev))
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert torch.equal(g.cpu(), r)
    assert E.LAUNCHES['ht_cleanup_encode'] == 2
