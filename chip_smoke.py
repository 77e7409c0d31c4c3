"""Smoke run of openjph_tpu_torch on one NVIDIA GPU: builds the CUDA
kernel from this checkout, holds it against its plain PyTorch version
on every lane of a 2048x1080 frame, drives the fused frame decode end
to end (gray 5/3 in both runner modes, RGB 9/7 ICT, an 8-frame burst),
times each stage with CUDA events, and prints one JSON line per result.

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
    """Build the CUDA kernel (nvcc) and the host library (g++) at once,
    one compiler process each; returns their build seconds."""
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import _build
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(f,))
               for f in (K.load, native.have_native)]
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


def timed(datas, dev, reps: int):
    """Median stage times over reps runs after a warm-up, and the 75th
    percentile of the total (reps >= 40 leaves ten samples above it)."""
    decode_frames(datas, dev)
    runs = [decode_frames(datas, dev)[1] for _ in range(reps)]
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    totals = sorted(r['total'] for r in runs)
    return med, totals[(3 * reps) // 4 - 1]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run',
              file=sys.stderr)
        return 1
    from openjph_tpu_torch.gpu import block_decode_cuda as K
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
        med, p75 = timed([gray] * n, dev, 40)
        emit('timing', frames=n, runs=40, median_ms=med, total_p75_ms=p75,
             mp_per_s=n * mp / (med['total'] / 1e3), card=card_id)

    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
