"""Entry points of the port for a harness (the JAX package's
__graft_entry__.py).

entry(): the fused frame decode of a deterministic stream
(bench_data/entry_sample.j2c) as a runner and its device inputs, in the
dense-words layout, so the runner launches the cleanup decoder's dense
readers (K1): ``runner(*args)`` returns (err, outs) as the JAX graph
does.

dryrun_multichip(n): the scale-out paths on ``n`` devices, each held
to its reference: the codeblock batch sharded over a mesh (K1), the
row-sharded 5/3 DWT over ``n`` gloo processes, the tile-sharded mosaic
decode (K2) and encode (K3), and the two-process frame fan-out.

    python -m openjph_tpu_torch.entry [--device cpu] [--dryrun N]

runs entry() and then dryrun_multichip(N); N defaults to the count of
visible devices of that type (1 for the CPU).
"""
import os
import sys

import numpy as np

from .gpu.pipeline import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'bench_data', 'entry_sample.j2c')


def _sample_stream(w=256, h=256, device='cuda'):
    """(stream, image): a ramp with bands of seeded noise every 16 rows;
    at 256x256 the committed bench_data/entry_sample.j2c, else the port's
    lossless 3-level encode of it on ``device``."""
    rng = np.random.RandomState(42)
    ramp = (np.arange(w)[None, :] + np.arange(h)[:, None]) % 256
    noise = rng.randint(0, 256, size=(h, w))
    img = np.where((np.arange(h)[:, None] // 16) % 2 == 0, ramp,
                   noise).astype(np.int32)
    if (w, h) == (256, 256) and os.path.exists(SAMPLE):
        with open(SAMPLE, 'rb') as fh:
            return fh.read(), img
    from . import encode
    return encode(img, device=device, reversible=True, num_decomps=3), img


def entry(device='cuda'):
    """Returns (runner, args): the fused frame decode of the sample
    stream on ``device`` and its inputs there (the dense layout, one
    frame).  ``runner(*args)`` returns (err [lanes] bool, outs), outs
    per tile a tuple of per-component [1, h, w] tensors."""
    from .gpu.pipeline import (GpuDecoder, _build_plan, _make_runner,
                               _pack_dense, upload)
    dev = resolve_device(device)
    stream, _ = _sample_stream(device=dev)
    dec = GpuDecoder(stream, dev, raw=False)
    plan = _build_plan(dec)
    runner = _make_runner(plan, device=dev, raw=False)
    return runner, upload(_pack_dense([(dec, plan)]), dev)


def _full_blocks(stream: bytes):
    """(data, missing_msbs, cleanup length) of every coded 64x64
    codeblock of the stream's first tile."""
    from .codec import Decoder
    dec = Decoder(stream)
    dec._materialize_coded()
    st = dec.tiles[0]
    blocks = []
    for c, comp in enumerate(st.geom.comps):
        for r, res in enumerate(comp.resolutions):
            for b in range(4):
                sb = res.bands[b]
                if sb is None or sb.empty:
                    continue
                coded = st.coded[c][r][b]
                for g in sb.blocks:
                    cb = coded[g.cb_y * sb.num_cb_x + g.cb_x]
                    if cb is not None and cb.data \
                            and (g.rect.w, g.rect.h) == (64, 64):
                        blocks.append((bytes(cb.data), cb.missing_msbs,
                                       cb.pass_length[0]))
    return blocks


def dryrun_multichip(n_devices: int, device='cuda') -> None:
    """Run the five scale-out stages on ``n_devices`` devices of
    ``device``'s type; raises on any difference from the references.  A
    CUDA mesh of more devices than are visible raises make_mesh's
    ValueError; nothing moves to the CPU by itself."""
    from . import encode
    from .native import prep_cleanup_streams
    from .parallel import (decode_blocks_sharded, decode_mosaic,
                           encode_mosaic, make_mesh, pad_to_multiple)
    from .parallel._testing import start_ranks, wait_ranks
    dev = resolve_device(device)
    mesh = make_mesh(n_devices, 'b', dev.type)
    # stages 2 and 5 run in processes of their own, started first so
    # that they run beside stages 1, 3 and 4
    procs = [start_ranks('openjph_tpu_torch.parallel.dwt_sharded',
                         n_devices, ['--size', f'64x{8 * n_devices}'],
                         device=dev.type),
             start_ranks('openjph_tpu_torch.parallel.multihost', 2,
                         ['--frames', '4'], device=dev.type)]
    try:
        # --- stage 1: a codeblock batch sharded over the mesh (K1) ---
        stream, _ = _sample_stream(128, 128, dev)
        blocks = _full_blocks(stream)
        if not blocks:
            raise AssertionError('sample stream has no full codeblocks')
        n = pad_to_multiple(len(blocks), n_devices)
        blocks += [blocks[0]] * (n - len(blocks))
        datas = [b[0] for b in blocks]
        lcups = np.array([b[2] for b in blocks], np.int64)
        miss = np.array([b[1] for b in blocks], np.int32)
        scups = np.array([(d[lc - 1] << 4) + (d[lc - 2] & 0xF)
                          for d, lc in zip(datas, lcups)], np.int64)
        _, err = decode_blocks_sharded(
            mesh, prep_cleanup_streams(datas, lcups, scups),
            (30 - miss).astype(np.int32), 64, 64)
        errs = err if isinstance(err, tuple) else (err,)
        if any(bool(e.any()) for e in errs):
            raise AssertionError('decode_blocks_sharded flagged a lane of '
                                 'the sample stream')

        # --- stage 3: the tile-sharded mosaic decode (K2) ---
        rng = np.random.RandomState(3)
        mimg = rng.randint(0, 256, (128, 128)).astype(np.int32)
        kw = dict(reversible=True, num_decomps=2, tile_size=(64, 64))
        mstream = encode([mimg], device=dev, **kw)
        if not np.array_equal(decode_mosaic(mstream, mesh)[0], mimg):
            raise AssertionError('decode_mosaic differs from the image')

        # --- stage 4: the tile-sharded mosaic encode (K3), byte-identical
        # to the sequential encode ---
        if encode_mosaic([mimg], mesh, **kw) != mstream:
            raise AssertionError('encode_mosaic differs from the '
                                 'sequential encode')

        # --- stage 2: the row-sharded DWT over n processes, and stage 5:
        # the frame fan-out over two ---
        for tag, group in zip(('dwt_sharded OK', 'multihost OK'), procs):
            for k, out in enumerate(wait_ranks(group, timeout=300)):
                if tag not in out:
                    raise AssertionError(f'process {k} printed no '
                                         f'"{tag}":\n{out[-4000:]}')
    finally:
        for p in procs[0] + procs[1]:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dryrun', type=int, metavar='N',
                    help='devices of the dryrun (default: those visible)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    runner, inputs = entry(dev)
    errs, outs = runner(*inputs)
    if bool(errs.any()):
        raise AssertionError('entry(): a lane was flagged')
    print('entry OK:', [tuple(tuple(p.shape) for p in t) for t in outs])
    n = args.dryrun
    if n is None:
        import torch
        n = torch.cuda.device_count() if dev.type == 'cuda' else 1
    dryrun_multichip(n, dev)
    print(f'dryrun_multichip({n}) OK', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
