"""The port's scale-out primitives (openjph_tpu_torch.parallel) on the CPU,
held against the JAX package's (openjph_tpu.parallel) on the same seeded
inputs, as tests/test_parallel.py runs them: the row-sharded DWT on 2
and 4 gloo processes against openjph_tpu.parallel.dwt_sharded under
shard_map (5/3 exact; 9/7 within atol 4e-6 on samples below 4 in
magnitude, the tolerance of tests/test_torch_encode_ops.py: XLA's CPU
backend fuses each lifting step into a multiply-add, the port rounds its
multiply and add apart), and decode_blocks_sharded against
openjph_tpu.coding.decoder.decode_codeblock.
"""
import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from openjph_tpu import encode
from openjph_tpu.codec import Decoder
from openjph_tpu.coding.decoder import decode_codeblock
from openjph_tpu.parallel import dwt_sharded as jdwt
from openjph_tpu.parallel.mesh import make_mesh as jmesh

from openjph_tpu_torch.native import prep_cleanup_streams
from openjph_tpu_torch.parallel._testing import start_ranks, wait_ranks
from openjph_tpu_torch.parallel.dwt_sharded import seeded_plane
from openjph_tpu_torch.parallel.mesh import (decode_blocks_sharded,
                                             make_mesh, pad_to_multiple,
                                             split_lanes)

H, W, SEED = 128, 96, 3
BANDS = ('LL', 'HL', 'LH', 'HH')


def _jax_sharded(n: int, rev: bool):
    """openjph_tpu's row-sharded analysis and synthesis over n devices."""
    mesh = jmesh(n, axis='y')
    x = seeded_plane(SEED, H, W, rev)
    fwd = shard_map(lambda a: jdwt.fwd_dwt2d_sharded(a, 'y', rev),
                    mesh=mesh, in_specs=P('y', None),
                    out_specs=(P('y', None),) * 4)
    bands = jax.jit(fwd)(x)
    inv = shard_map(
        lambda a, b, c, d: jdwt.inv_dwt2d_sharded(a, b, c, d, 'y', rev),
        mesh=mesh, in_specs=(P('y', None),) * 4, out_specs=P('y', None))
    back = jax.jit(inv)(*bands)
    return x, [np.asarray(b) for b in bands], np.asarray(back)


@pytest.mark.parametrize('n', [2, 4])
def test_sharded_dwt_matches_jax(n, tmp_path):
    procs = start_ranks('openjph_tpu_torch.parallel.dwt_sharded', n,
                        ['--size', f'{W}x{H}', '--seed', str(SEED),
                         '--out', str(tmp_path)])
    # the JAX references compile while the processes run
    refs = {rev: _jax_sharded(n, rev) for rev in (True, False)}
    outs = wait_ranks(procs)
    # each process also held its rows to the unsharded gpu/dwt.py
    assert all('dwt_sharded OK' in o for o in outs)
    ranks = [np.load(tmp_path / f'rank{k}.npz') for k in range(n)]
    for rev, name in ((True, 'rev53'), (False, 'irv97')):
        x, bands, back = refs[rev]
        mine = [np.concatenate([r[f'{name}_{b}'] for r in ranks])
                for b in BANDS]
        got_back = np.concatenate([r[f'{name}_back'] for r in ranks])
        for a, b in zip(mine, bands):
            assert a.shape == b.shape
            if rev:
                assert np.array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=4e-6)
        if rev:
            assert np.array_equal(got_back, back)
            assert np.array_equal(got_back, x)
        else:
            np.testing.assert_allclose(got_back, back, rtol=0, atol=4e-6)
            assert np.abs(x).max() < 4


@pytest.fixture(scope='module')
def blocks():
    """The full-size 64x64 codeblocks of a 256x256 5/3 stream, each with
    the JAX host decoder's output."""
    img = np.random.RandomState(1234).randint(0, 256, (256, 256)) \
        .astype(np.int32)
    dec = Decoder(encode(img, reversible=True, num_decomps=2))
    out = []
    for c, comp in enumerate(dec.tiles[0].geom.comps):
        for r, res in enumerate(comp.resolutions):
            for b in range(4):
                sb = res.bands[b]
                if sb is None or sb.empty:
                    continue
                coded = dec.tiles[0].coded[c][r][b]
                for g in sb.blocks:
                    cb = coded[g.cb_y * sb.num_cb_x + g.cb_x]
                    if cb and cb.data and (g.rect.w, g.rect.h) == (64, 64):
                        d = bytes(cb.data)
                        lc = cb.pass_length[0]
                        out.append((d, cb.missing_msbs, lc,
                                    decode_codeblock(d, cb.missing_msbs, 1,
                                                     lc, 0, 64, 64)))
    assert len(out) >= 8
    return out


@pytest.mark.parametrize('n', [1, 2])
def test_sharded_block_decode(blocks, n):
    mesh = make_mesh(n, device='cpu')
    m = pad_to_multiple(len(blocks), n)
    lanes = blocks + [blocks[0]] * (m - len(blocks))
    datas = [b[0] for b in lanes]
    lcups = np.array([b[2] for b in lanes], np.int64)
    miss = np.array([b[1] for b in lanes], np.int32)
    scups = np.array([(d[lc - 1] << 4) + (d[lc - 2] & 0xF)
                      for d, lc in zip(datas, lcups)], np.int64)
    streams = prep_cleanup_streams(datas, lcups, scups)
    got, err = decode_blocks_sharded(mesh, streams, 30 - miss, 64, 64)
    if n == 1:
        got, err = (got,), (err,)
    assert len(got) == n and all(g.shape[0] == m // n for g in got)
    assert not any(bool(e.any()) for e in err)
    got = torch.cat(got).numpy().view(np.uint32)
    for i, b in enumerate(lanes):
        assert np.array_equal(got[i], b[3])


def test_mesh():
    m = make_mesh(3, axis='y', device='cpu')
    assert m.size == 3 and m.axis == 'y'
    assert all(d == torch.device('cpu') for d in m.devices)
    assert make_mesh(device='cpu').size == 1
    assert pad_to_multiple(13, 4) == 16 and pad_to_multiple(12, 4) == 12
    assert [s for _, s in split_lanes(m, 6)] == [slice(0, 2), slice(2, 4),
                                                 slice(4, 6)]
    with pytest.raises(ValueError, match='evenly'):
        split_lanes(m, 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            make_mesh()
