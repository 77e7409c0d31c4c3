"""Smoke run of openjph_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version
on every lane of 2048x1080 frames, drives the fused frame decode end to
end (gray 5/3 in both runner modes, RGB 9/7 ICT, an 8-frame burst) and
the fused frame encode end to end (gray 5/3 against the repository's
codestream, RGB 9/7 ICT against the port's CPU encode, an 8-frame
burst), times each stage (device stages with CUDA events, host stages
with the host clock), and prints one JSON line per result.

    python3 chip_smoke.py

Exits non-zero, printing no result, when no CUDA device is present or
any phase fails.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'bench_data')
GRAY = os.path.join(DATA, 'gray_2048x1080_rev.j2c')
GRAY_NPY = os.path.join(DATA, 'gray_2048x1080.npy')
RGB = os.path.join(DATA, 'rgb_2048x1080_97.j2c')
BURST = 8

# H100 SXM published peaks (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# integer operations per decoded sample, counted off the kernel source
# (VLC/UVLC pair decode and MEL shared over a quad's four samples, plus
# each sample's MagSgn refill, extract, value assembly and store)
OPS_PER_SAMPLE = 36
# integer operations per encoded sample, counted off ht_cleanup_encode.cu:
# per pair of quads (8 samples) ~96 for the samples' exponents and
# MagSgn values, ~100 per quad for kappa, eps, the context rows, the VLC
# lookup and append, the MEL event and the MagSgn appends, and ~70 for the
# u codes: ~370, or 46 per sample
ENC_OPS_PER_SAMPLE = 46


def card() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader', '-i', '0'],
                       capture_output=True, text=True, check=True,
                       timeout=60)
    return r.stdout.strip()


def emit(tag: str, **fields):
    print(json.dumps({'phase': tag, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def build_all():
    """Build the CUDA kernels (nvcc, one per source) and the host library
    (g++) at once, one compiler process each; returns their build
    seconds."""
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import _build
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(f,))
               for f in (K.load, E.load, native.have_native)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, dict(_build.BUILD_SECONDS)


def group_views(buf, plan, raw: bool, words=None):
    """Per lane group: the kernel's arguments as the runner slices them
    out of the uploaded buffers."""
    import torch
    from openjph_tpu_torch.gpu.pipeline import _window
    tl = sum(g.n_pad for g in plan.groups)
    meta = (buf[buf.shape[0] - tl * 8:] if raw else buf).reshape(tl, 8)
    out, s0 = [], 0
    for g in plan.groups:
        c = [meta[s0:s0 + g.n_pad, k].contiguous() for k in range(8)]
        s0 += g.n_pad
        if raw:
            args = (buf.view(torch.uint8), c[0], c[1], c[2], c[6], g.w, g.h,
                    c[7], g.words)
        else:
            wm, wv, ws = g.words
            args = (_window(words, c[0], c[1], wm, -1),
                    _window(words, c[2], c[3], wv, 0),
                    _window(words, c[4], c[5], ws, -1), c[6], g.w, g.h,
                    c[7])
        out.append((g, args, c))
    return out


def kernel_vs_plain(data: bytes, dev, name: str, card_id: str):
    """Both reader modes of the kernel against their plain versions on
    every lane of one frame, on the card."""
    import torch
    from openjph_tpu_torch.gpu import block_decode as plain
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu.pipeline import (GpuDecoder, _build_plan,
                                                _pack_burst, _pack_device,
                                                upload)
    dec = GpuDecoder(data, device=dev)
    plan = _build_plan(dec)
    (rbuf,) = upload(_pack_device([(dec, plan)]), dev)
    words, dmeta = upload(_pack_burst([dec._group_arrays(plan)]), dev)
    rows = {}
    for raw in (True, False):
        kname = 'ht_cleanup_decode_raw' if raw else 'ht_cleanup_decode_dense'
        kern = K.decode_cleanup_raw if raw else K.decode_cleanup
        ref = K.decode_cleanup_raw_plain if raw else plain.decode_cleanup_core
        views = group_views(rbuf if raw else dmeta, plan, raw, words)
        lanes = live = 0
        coded = out_bytes = samples = 0
        err_max = 0
        ms = plain_ms = 0.0
        for g, args, c in views:
            d, e = kern(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp, ep = ref(*args)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            qhl = c[7].to(torch.int64)
            rowmask = (torch.arange(g.h, device=dev)[None, :]
                       < 2 * qhl[:, None])[:, :, None]
            diff = (d.to(torch.int64) - dp.to(torch.int64)).abs() * rowmask
            err_max = max(err_max, int(diff.max()))
            if not torch.equal(e, ep):
                raise AssertionError(f'{kname}: error flags differ from '
                                     f'the plain version in group {g.w}')
            if err_max != 0:
                raise AssertionError(f'{kname}: samples differ from the '
                                     f'plain version in group {g.w}')
            if bool(e[qhl > 0].any()):
                raise AssertionError(f'{kname}: flagged a lane of a valid '
                                     f'stream')
            ms += cuda_ms(lambda: kern(*args), 20)
            n = g.n_pad
            lanes += n
            live += int((qhl > 0).sum())
            samples += int((2 * qhl).clamp(max=g.h).sum()) * g.w
            if raw:
                # each lane's stuffed bytes, its meta, tables; dec + err out
                coded += int((c[1] + c[2]).sum()) + n * 5 * 4
            else:
                coded += 4 * int((c[1] + c[3] + c[5]).sum()) + n * 8 * 4
            out_bytes += n * g.h * g.w * 4 + n
        nbytes = coded + out_bytes + 2624 * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = samples * OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3
        rows[kname] = {
            'name': kname, 'route': 'cuda',
            'source': 'openjph_tpu_torch/gpu/csrc/ht_cleanup_decode.cu',
            'replaces': 'openjph_tpu/tpu/block_decode_pallas.py:801',
            'launches': 0, 'max_abs_err': err_max, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None, 'bit_exact': err_max == 0,
        }
        # codeblocks per CUDA block: the launch setting against others
        sweep = {}
        default = K.THREADS
        try:
            for tpb in (1, 2, 4, 8, 32):
                K.THREADS = tpb
                sweep[tpb] = sum(cuda_ms(lambda: kern(*a), 20)
                                 for _, a, _ in views)
        finally:
            K.THREADS = default
        emit('kernel_vs_plain', frame=name, kernel=kname, lanes=lanes,
             live_lanes=live, bit_exact=True, kernel_ms=ms,
             plain_ms=plain_ms, bytes_moved=nbytes, samples=samples,
             bound_ms=rows[kname]['bound_ms'], threads_per_block=default,
             kernel_ms_by_threads_per_block=sweep, card=card_id)
    return rows


def decode_frames(datas, dev, raw: bool = True):
    """Bytes -> frames in device memory through the fused decode, with
    per-stage times.  Returns (outputs, times in ms)."""
    import torch
    from openjph_tpu_torch.gpu.pipeline import (GpuDecoder, _build_plan,
                                                _make_runner, _pack_dense,
                                                _pack_device, upload)
    t0 = time.perf_counter()
    pairs = []
    for d in datas:
        dec = GpuDecoder(d, device=dev, raw=raw)
        plan = _build_plan(dec)
        if plan is None or plan.has_refine:
            raise AssertionError('stream left the fused path')
        pairs.append((dec, plan))
    t1 = time.perf_counter()
    args = _pack_device(pairs) if raw else _pack_dense(pairs)
    t2 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    dargs = upload(args, dev)
    ev[1].record()
    runner = _make_runner(pairs[0][1], len(datas), dev, raw)
    decs, errs = runner.tier1(*dargs)
    ev[2].record()
    outs = runner.rest(decs)
    ev[3].record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if bool(torch.cat(errs).any()):
        raise AssertionError('a lane of a valid stream was flagged')
    times = {'host_t2_plan': (t1 - t0) * 1e3, 'pack': (t2 - t1) * 1e3,
             'upload': ev[0].elapsed_time(ev[1]),
             'tier1': ev[1].elapsed_time(ev[2]),
             'rest_of_graph': ev[2].elapsed_time(ev[3]),
             'total': (t3 - t0) * 1e3}
    return outs, times


def timed(run, reps: int):
    """Median stage times of run() -> (outputs, times) over reps runs
    after a warm-up, and the 75th percentile of the total (reps >= 40
    leaves ten samples above it)."""
    run()
    runs = [run()[1] for _ in range(reps)]
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    totals = sorted(r['total'] for r in runs)
    return med, totals[(3 * reps) // 4 - 1]


def encoder(shape, nc: int, dev, **kwargs):
    """(GpuEncoder, its single tile's geometry) for frames of ``shape``
    with ``nc`` components."""
    import functools
    from openjph_tpu_torch.codec import build_encoder
    from openjph_tpu_torch.core.geometry import build_tile, build_tile_grid
    from openjph_tpu_torch.gpu.encode_pipeline import GpuEncoder
    enc = build_encoder(shape, nc, functools.partial(GpuEncoder, device=dev),
                        **kwargs)
    return enc, build_tile(enc.hdr, 0, build_tile_grid(enc.siz)[0])


def enc_batches(planes, dev, **kwargs):
    """(plan, runner, group batches) of one frame's fused encode: the
    kernel's arguments as the runner builds them."""
    import torch
    from openjph_tpu_torch.gpu.encode_pipeline import (_make_enc_runner,
                                                       _narrow_tile_plane)
    enc, geom = encoder(planes[0].shape, len(planes), dev, **kwargs)
    plan = enc._build_enc_plan(geom)
    runner = _make_enc_runner(plan, 1, dev)
    tpl = [torch.from_numpy(_narrow_tile_plane(enc.siz, geom, c,
                                               planes[c])[None]).to(dev)
           for c in range(len(planes))]
    return plan, runner, runner.graph(*tpl)


def k3_vs_plain(planes, dev, name: str, card_id: str, **kwargs):
    """The encode kernel against its plain version on every lane of one
    frame's group batches, on the card; returns its kernels-line row."""
    import torch
    from openjph_tpu_torch.gpu import block_encode as plain
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    plan, runner, batches = enc_batches(planes, dev, **kwargs)
    lanes = live = samples = nbytes = 0
    ms = plain_ms = 0.0
    groups = []
    for g, (buf, _), p, qhl in zip(plan.groups, batches, runner.lane_p,
                                   runner.lane_qhl):
        args = (buf, p, g.w, g.h, g.caps, qhl)
        cat, bits, ovf = E.encode_cleanup(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cat_p, bits_p, ovf_p = plain.encode_cleanup_core(*args)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not torch.equal(bits, bits_p) or not torch.equal(ovf, ovf_p):
            raise AssertionError(f'ht_cleanup_encode: bit counts or '
                                 f'overflow flags differ from the plain '
                                 f'version in group {g.w} of {name}')
        if bool(ovf.any()):
            raise AssertionError(f'ht_cleanup_encode: a lane of {name} '
                                 f'overflowed')
        # every word is compared: both versions leave the words past
        # each stream's used prefix zero
        if not torch.equal(cat, cat_p):
            raise AssertionError(f'ht_cleanup_encode: words differ from '
                                 f'the plain version in group {g.w} of '
                                 f'{name}')
        ms += cuda_ms(lambda: E.encode_cleanup(*args), 20)
        n = buf.shape[0]
        lanes += n
        live += int((qhl > 0).sum())
        samples += int((2 * qhl.to(torch.int64)).clamp(max=g.h).sum()) * g.w
        used = int(((bits.to(torch.int64) + 31) // 32).sum())
        # samples and per-lane p/qhl in; used words, bit counts and
        # flags out
        nbytes += buf.numel() * 4 + n * 8 + used * 4 + n * 16
        groups.append(args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = samples * ENC_OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3
    sweep = {}
    default = E.THREADS
    try:
        for tpb in (1, 2, 4, 8, 32):
            E.THREADS = tpb
            sweep[tpb] = sum(cuda_ms(lambda: E.encode_cleanup(*a), 20)
                             for a in groups)
    finally:
        E.THREADS = default
    emit('k3_vs_plain', frame=name, lanes=lanes, live_lanes=live,
         groups=[(g.w, g.h, len(g.lanes), g.n_pad, list(g.caps))
                 for g in plan.groups],
         bit_exact=True, kernel_ms=ms, plain_ms=plain_ms, bytes_moved=nbytes,
         samples=samples, bound_ms=max(bytes_ms, ops_ms),
         threads_per_block=default, kernel_ms_by_threads_per_block=sweep,
         card=card_id)
    return {
        'name': 'ht_cleanup_encode', 'route': 'cuda',
        'source': 'openjph_tpu_torch/gpu/csrc/ht_cleanup_encode.cu',
        'replaces': 'openjph_tpu/tpu/block_encode_pallas.py:671',
        'launches': 0, 'max_abs_err': 0, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': max(bytes_ms, ops_ms),
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': None, 'bit_exact': True,
    }


def encode_frames(frames, dev):
    """Gray frames in host memory -> lossless .j2c streams through the
    fused encode, with per-stage times.  Returns (streams, times in
    ms)."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu.encode_pipeline import (_empty_coded,
                                                       _fetch_outs,
                                                       _make_enc_runner,
                                                       _narrow_tile_plane,
                                                       _tile_packets)
    F = len(frames)
    t0 = time.perf_counter()
    enc, geom = encoder(frames[0].shape, 1, dev, reversible=True)
    plan = enc._build_enc_plan(geom)
    runner = _make_enc_runner(plan, F, dev)
    t1 = time.perf_counter()
    stack = np.stack([_narrow_tile_plane(enc.siz, geom, 0, f)
                      for f in frames])
    t2 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    dplane = torch.from_numpy(stack).to(dev)
    ev[1].record()
    batches = runner.graph(dplane)
    ev[2].record()
    cats, aux = runner.tier1(batches)
    ev[3].record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dense, metas, nzs = _fetch_outs(plan, cats, aux, F)
    t4 = time.perf_counter()
    codeds = [_empty_coded(geom, 1) for _ in range(F)]
    enc._stuff(plan, dense, metas, nzs, codeds)
    t5 = time.perf_counter()
    streams = [enc.assemble([_tile_packets(enc, geom, c)]) for c in codeds]
    t6 = time.perf_counter()
    times = {'host_plan': (t1 - t0) * 1e3, 'narrow': (t2 - t1) * 1e3,
             'upload': ev[0].elapsed_time(ev[1]),
             'device_graph': ev[1].elapsed_time(ev[2]),
             'tier1_k3': ev[2].elapsed_time(ev[3]),
             'fetch_compact_d2h': (t4 - t3) * 1e3,
             'host_stuffing': (t5 - t4) * 1e3,
             't2_assemble': (t6 - t5) * 1e3, 'total': (t6 - t0) * 1e3}
    return streams, times


def from_sot(stream: bytes) -> bytes:
    """The codestream from its first SOT marker (FF 90) on."""
    at = stream.find(b'\xff\x90')
    if at < 0:
        raise AssertionError('no SOT marker in the stream')
    return stream[at:]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run',
              file=sys.stderr)
        return 1
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    from openjph_tpu_torch.gpu.pipeline import decode_gpu

    card_id = card()
    print(card_id, flush=True)
    dev = torch.device('cuda', 0)
    build_s, per_lib = build_all()
    emit('setup', card=card_id, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_s=build_s, build_s_per_library=per_lib)

    gray = open(GRAY, 'rb').read()
    gray_ref = np.load(GRAY_NPY)
    rgb = open(RGB, 'rb').read()

    # 1. the kernel against its plain version, every lane of the frame
    kernels = kernel_vs_plain(gray, dev, 'gray_2048x1080_rev', card_id)

    # reference for the RGB frame: the port's own CPU decode (plain
    # versions of every stage); it launches no kernel
    t0 = time.perf_counter()
    rgb_cpu = decode_gpu(rgb, device='cpu', raw=False)
    rgb_cpu_s = time.perf_counter() - t0

    # 2. the main path, counted: every kernel launch from here to the
    # reading below is the fused decode's own
    K.reset_launches()
    for raw in (True, False):
        out = decode_gpu(gray, device='cuda', raw=raw)
        if len(out) != 1 or not np.array_equal(out[0], gray_ref):
            raise AssertionError(f'gray frame differs (raw={raw})')
        emit('e2e_gray', raw=raw, bit_exact=True, shape=list(out[0].shape))
    out = decode_gpu(rgb, device='cuda')
    diff = max(int(np.abs(a.astype(np.int64) - b).max())
               for a, b in zip(out, rgb_cpu))
    if len(out) != 3 or diff > 1 or \
            any(a.shape != b.shape for a, b in zip(out, rgb_cpu)):
        raise AssertionError(f'RGB 9/7 differs from the CPU decode by {diff}')
    emit('e2e_rgb_97_ict', max_abs_diff_vs_cpu=diff, tolerance=1,
         cpu_reference_s=rgb_cpu_s, shape=list(out[0].shape))
    outs, _ = decode_frames([gray] * BURST, dev)
    frames = outs[0][0]
    if tuple(frames.shape) != (BURST,) + gray_ref.shape:
        raise AssertionError(f'burst shape {tuple(frames.shape)}')
    ref_t = torch.from_numpy(gray_ref.astype(np.uint8)).to(dev)
    for f in range(BURST):
        if not torch.equal(frames[f], ref_t):
            raise AssertionError(f'burst frame {f} differs')
    emit('burst', frames=BURST, bit_exact=True, dtype=str(frames.dtype))
    launches = dict(K.LAUNCHES)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched on the main path')
        kernels[k]['launches'] = v
    emit('main_path_launches', **launches)

    # 3. stage times, one frame and a burst (median of the runs)
    mp = gray_ref.size / 1e6
    for n in (1, BURST):
        med, p75 = timed(lambda: decode_frames([gray] * n, dev), 40)
        emit('timing', frames=n, runs=40, median_ms=med, total_p75_ms=p75,
             mp_per_s=n * mp / (med['total'] / 1e3), card=card_id)

    # 4. the encode kernel against its plain version, every lane of the
    # gray frame's and the RGB 9/7 frame's group batches.  The RGB input
    # is the port's card decode of rgb_2048x1080_97.j2c (8-bit planes).
    rgb_planes = [a.astype(np.int32) for a in out]
    kernels['ht_cleanup_encode'] = k3_vs_plain(
        [gray_ref], dev, 'gray_2048x1080', card_id, reversible=True)
    k3_vs_plain(rgb_planes, dev, 'rgb_2048x1080_97_ict', card_id,
                reversible=False)

    # reference for the RGB encode: the port's own CPU encode (plain
    # versions of every stage); it launches no kernel
    t0 = time.perf_counter()
    rgb_enc_cpu = encode_gpu(rgb_planes, device='cpu', reversible=False)
    rgb_enc_cpu_s = time.perf_counter() - t0

    # 5. the encode path, counted: every launch from here to the reading
    # below is the fused encode's own
    E.reset_launches()
    gray_j2c = encode_gpu(gray_ref, device='cuda', reversible=True)
    if from_sot(gray_j2c) != from_sot(gray):
        raise AssertionError('gray encode differs from gray_2048x1080_rev.j2c '
                             'from its first SOT on')
    enc_rgb = encode_gpu(rgb_planes, device='cuda', reversible=False)
    if enc_rgb != rgb_enc_cpu:
        raise AssertionError('RGB 9/7 ICT encode differs from the CPU encode')
    streams, _ = encode_frames([gray_ref] * BURST, dev)
    if any(st != gray_j2c for st in streams):
        raise AssertionError('an 8-frame burst stream differs from the '
                             'single-frame stream')
    enc_launches = dict(E.LAUNCHES)
    if enc_launches['ht_cleanup_encode'] == 0:
        raise AssertionError('ht_cleanup_encode was not launched on the '
                             'encode path')
    kernels['ht_cleanup_encode']['launches'] = \
        enc_launches['ht_cleanup_encode']
    back = decode_gpu(gray_j2c, device='cuda')
    if len(back) != 1 or not np.array_equal(back[0], gray_ref):
        raise AssertionError('the gray encode does not decode to the frame')
    emit('e2e_encode_gray', bytes=len(gray_j2c), equal_from_sot=True,
         decodes_to_source=True)
    emit('e2e_encode_rgb_97_ict', bytes=len(enc_rgb), equal_to_cpu=True,
         cpu_reference_s=rgb_enc_cpu_s)
    emit('encode_burst', frames=BURST, equal_to_single=True)
    emit('encode_path_launches', **enc_launches)

    # 6. encode stage times, one frame and a burst (median of the runs)
    for n in (1, BURST):
        med, p75 = timed(lambda: encode_frames([gray_ref] * n, dev), 40)
        emit('encode_timing', frames=n, runs=40, median_ms=med,
             total_p75_ms=p75, mp_per_s=n * mp / (med['total'] / 1e3),
             card=card_id)

    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
