"""The HT cleanup encoder of the port (gpu/block_encode_cuda.py, K3) held
against the JAX package's encoders on the same inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version
(gpu/block_encode.py).  Its dense words go through the port's host
stuffer (native.pack_from_dense) and must give, lane for lane, the bytes
of the JAX records path: tpu/block_encode.encode_cleanup_core, then
openjph_tpu.native.pack_cleanup_segments.  One small case goes against
the Pallas kernel itself in interpret mode, word for word.  The table
that drives the kernel's MEL coder is held to the plain MEL coder.  The
CUDA kernel is held against the plain version by the test marked
``cuda``, which runs only where a card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openjph_tpu import native as jnative
from openjph_tpu.tpu.block_encode import encode_cleanup_core
from openjph_tpu.tpu.block_encode_pallas import encode_cleanup_pallas_cat

from openjph_tpu_torch import native
from openjph_tpu_torch.gpu import block_encode as plain
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
    (6, 10, 12, False), (13, 11, 9, True),
    # the shapes the card holds the kernel to, 8 lanes each
    (64, 64, 12, False),   # qw = 32: one full warp of quads
    (128, 32, 8, False),   # two chunks of 32 quads a row
    (32, 128, 8, False),   # half a warp, 64 quad rows
    (63, 64, 9, True)])    # odd qw at warp width, mixed heights
def test_plain_segments_match_records(w, h, kmax, mixed):
    n = 24 if w * h <= 512 else 8
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


def _mel_bits(vals, lens):
    """(bits, count) of one lane's MEL records, LSB-first."""
    acc, nb = 0, 0
    for v, ln in zip(vals, lens):
        acc |= (int(v) & ((1 << int(ln)) - 1)) << nb
        nb += int(ln)
    return acc, nb


def test_mel_tables_match_plain_coder():
    """The kernel's MEL coder steps four events a table entry and codes
    the last 0-3 one at a time.  Every entry (each state and four events)
    is the plain version's coder (block_encode._Mel) started in that
    state; whole runs of seeded events of every density, tail included,
    give the plain version's MEL words."""
    step, kr = E.mel_tables()
    assert step.shape == (85, 16, 2) and kr.shape == (85,)
    tables = E._tables('cpu')
    assert tables.numel() == 4096 + 300 + step.size + kr.size
    assert (4096 + 300) % 4 == 0   # the step table is 16-byte aligned
    # every entry: lane 16 s + nib starts in state s and takes nib's events
    n = 85 * 16
    mel = plain._Mel(n, 'cpu')
    mel.k = torch.from_numpy((kr.astype(np.int64) & 15).repeat(16))
    mel.run = torch.from_numpy((kr.astype(np.int64) >> 4).repeat(16))
    nib = np.tile(np.arange(16), 85)
    for i in range(4):
        mel.event(torch.ones(n, dtype=torch.bool),
                  torch.from_numpy((nib >> i) & 1 == 1))
    vals, lens = torch.stack(mel.vals), torch.stack(mel.lens)
    nxt = (mel.k | mel.run << 4).numpy()
    for lane in range(n):
        s, b = divmod(lane, 16)
        bits, cnt = _mel_bits(vals[:, lane], lens[:, lane])
        assert int(step[s, b, 0]) == bits | cnt << 24, (s, b)
        assert kr[step[s, b, 1]] == nxt[lane], (s, b)
    # whole runs, the coder as the kernel drives it
    rng = np.random.RandomState(7)
    n = 64
    for density in (0.02, 0.2, 0.5, 0.9):
        ev = rng.rand(n, 203) < density
        mel = plain._Mel(n, 'cpu')
        for j in range(ev.shape[1]):
            mel.event(torch.ones(n, dtype=torch.bool),
                      torch.from_numpy(ev[:, j]))
        mel.terminate()
        vals, lens = torch.stack(mel.vals), torch.stack(mel.lens)
        full = ev.shape[1] // 4 * 4
        for i in range(n):
            s, acc, nb = 0, 0, 0
            for j in range(0, full, 4):
                word, s = step[s, sum(int(ev[i, j + b]) << b
                                      for b in range(4))]
                acc |= (int(word) & 0xFFFFFF) << nb
                nb += int(word) >> 24
            k, run = int(kr[s]) & 15, int(kr[s]) >> 4
            for j in range(full, ev.shape[1]):
                e = E._MEL_EXP[k]
                if not ev[i, j]:
                    run += 1
                    if run >= 1 << e:
                        acc |= 1 << nb
                        nb += 1
                        run, k = 0, min(k + 1, 12)
                else:
                    rev = int(f'{run:0{e}b}'[::-1], 2) if e else 0
                    acc |= (rev << 1) << nb
                    nb += 1 + e
                    run, k = 0, max(k - 1, 0)
            if run > 0:
                acc |= 1 << nb
                nb += 1
            assert (acc, nb) == _mel_bits(vals[:, i], lens[:, i]), \
                (density, i)


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
    shapes = ((16, 16, 8, None), (13, 11, 9, [11, 3, 6]),
              (64, 64, 12, None), (128, 32, 8, None), (32, 128, 8, None),
              (63, 64, 9, [64, 61, 32]))
    for w, h, kmax, heights in shapes:
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
    assert E.LAUNCHES['ht_cleanup_encode'] == len(shapes)
