"""Smoke run of openjph_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version
on every lane of 2048x1080 frames (both kernels also on frames of
128x32 and 32x128 codeblocks, the decode kernel on lanes with damaged
bytes, the encode kernel on a 12-bit 2047x1079 frame and on 2037 of its
columns), drives the fused frame decode end to end (gray 5/3 in both
runner modes, RGB 9/7 ICT, an 8-frame burst) and the fused frame encode
end to end (gray 5/3 against the repository's codestream, RGB 9/7 ICT
and the 12-bit frame against the port's CPU encode, an 8-frame burst),
and the multi-pass decode: the refinement-pass kernel against its plain
version on every lane of the two multi-pass test streams (as coded and
with its gates forced) and of seeded synthetic batches (seven codeblock
shapes, odd ones among them), also on lanes enough that a block's SigProp
chains share one warp, split by its gates, on the committed lanes whose
cleanup makes a padding sample significant (32 and 64 bits, against the
JAX package's fused refine stored beside them), the cleanup and
refinement kernels together against the C++ scalar codeblock decoder,
and both streams decoded end to end against the port's CPU decode (both
runner modes, an 8-frame burst); the multi-pass encode (the
`multipass_encode` phase): the refinement-pass encoder against its plain
version on every lane of the 3-pass frame, of an 8-frame burst of
distinct frames and of seeded lanes of eight codeblock shapes, at 2 and
3 passes, causal off and on, the cleanup encoder one plane coarser
against its plain version and the C++ scalar encoder, the 3-pass frame,
its causal 512x256 crop and the mixed-choice fixture encoded equal to
their committed streams from the first SOT, the 3-pass mosaic fixture
through MosaicEncoder, a burst through encode_gpu_batch and a 9/7 RGB
3-pass frame against the CPU encode, each decoded back on the card, and
the 3-pass encode timed in turns with the 1-pass one; codeblocks of more
than 30 bit planes
(the `wide` phase): the 64-bit instantiations of the three kernels
against their plain versions on every lane of a 2048x1080 32-bit frame
(the refinement kernel on a committed 3-pass 32-bit stream and on
committed multi-pass codeblocks) and against the C++ scalar coders lane
by lane, the 32-bit and 29-bit 2048x1080 frames and a 32-bit RGB frame
through the RCT encoded and decoded on the card against the port's CPU
encode and decode and the sources, the committed wide fixtures against
their JAX-package decodes and streams, an 8-frame burst each way, and
the 32-bit frame timed in turns with the 8-bit one; damaged streams: the gray and 3-pass
frames cut at 1/4, 1/2 and 3/4 and with a seeded 8-byte flip that strict
decode rejects, decoded with resilient=True in both runner modes against
the port's CPU decode (the same lanes zeroed), and the causal stream's
cuts against the committed host decode; and the gray frame encoded with
a Part-2 DFS structure (HORZ, VERT, three BIDIR levels) against the
port's CPU encode, decoded back bit-exact; and the video paths
(VideoEncoder, VideoDecoder to the host in both runner modes and to the
device) on 32 distinct 2048x1080 frames in bursts of 8, two in flight,
against the per-frame encode and the sources, with 3-pass and damaged
bursts, timed against the sequential per-burst path; the CLI apps from
files (compress of the gray frame against its repository stream from the
first SOT, expand of it, of the 3-pass and RGB streams and at reduced
resolutions against decode_gpu and the CPU decode, each timed); the RTP
receiver on loopback (8 frames decoded on the card to .ppm, bit-exact,
and a frame with a dropped packet under resilient=True); and tracing: the
stage timers on every path, their cost, and torch.profiler windows (one
frame and bursts, decode and encode, 32 frames through VideoDecoder, the
3-pass frame) with the card's busy share, its top ops and its longest
idle gaps, the traces written gzipped under traces/; and mosaics and
scale-out: the committed multi-tile fixtures through MosaicDecoder (both
runner modes, the 3-pass one through K4) and MosaicEncoder against their
sources and the JAX package's streams and fused 9/7 decode,
decode_blocks_sharded against the C++ scalar decoder, BASELINE config 5
as an 8192x8192 mosaic (64 tiles of 1024x1024, every tile lossless, the
stream equal to encode_gpu of the whole image) and a 32768x32768 one
(1,024 tiles, streamed to a file, decoded from an mmap of it) with their
peak host RSS and device memory, the row-sharded DWT and the frame
fan-out in two processes that share the card over gloo; the fuzz
harnesses (the `fuzz` phase): the 52 OpenJPH streams of
fuzzing/seed_corpus/ and the decode fuzzer's 6 own seeds in both runner
modes, strict and resilient, 96 mutated streams a runner mode in two
processes of their own with the card's peak memory, 4 mutations of the
gray frame, 48 random encode parameter sets and codeblocks of 1024x4,
4x1024 and 4x4, each against the port's CPU path; and the entry
point (the `entry` phase): entry()'s runner against the sample image and
dryrun_multichip(1); and the upload A/B tool (the `ab_upload` phase):
VideoDecoder's staged, unstaged and synchronous uploads in turns, 3
rounds of 6 bursts of 8 frames, MP/s a round; and the rest of graph
replayed from its CUDA graph (the `rest_graph` phase) bit-equal to its
eager launch on the benchmark's two geometries, the video decoder's five
modes, two decoders sharing a graph and a mosaic pass, with the share
replayed over sequences of distinct frames that do not loop.  It
times each stage (device stages with CUDA events, host stages with the
host clock), and prints one JSON line per result.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OTHER.cu          # another build of
                                                      # the decode kernel
    python3 chip_smoke.py --against-encode OTHER.cu   # ... of the encode
                                                      # kernel
    python3 chip_smoke.py --against-refine OTHER.cu   # ... of the
                                                      # refinement kernel
    python3 chip_smoke.py --against-refine-encode OTHER.cu
                                                      # ... of the
                                                      # refinement-pass
                                                      # encoder
    python3 chip_smoke.py --mosaic-100k               # also the
                                                      # 100000x100000
                                                      # mosaic (9,604 tiles)

Exits non-zero, printing no result, when no CUDA device is present or
any phase fails.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
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
# the multi-pass streams (openjph_tpu_torch/testdata/README.md)
TESTDATA = os.path.join(ROOT, 'openjph_tpu_torch', 'testdata')
GRAY3 = os.path.join(TESTDATA, 'gray_2048x1080_rev_p3.j2c')
CAUSAL2 = os.path.join(TESTDATA, 'gray_512x256_rev_p2_causal.j2c')
# multi-pass codeblocks whose cleanup makes a padding sample significant,
# with the JAX package's fused refine of each
# (tests/test_torch_refine_padding.py)
REFINE_PADDING = os.path.join(TESTDATA, 'refine_padding_lanes.npz')
# the host decoder's resilient decode of three cuts of CAUSAL2
CAUSAL2_REF = os.path.join(TESTDATA,
                           'gray_512x256_rev_p2_causal_resilient.npz')
BURST = 8
# the video phase's distinct frames (four bursts)
VIDEO_FRAMES = 32
NOISE = (1080, 2048)  # the seeded noise frame of the block-shape phase
# the seeded 12-bit frame of the encode phases: its odd sizes give edge
# codeblocks of odd height and 63 wide
NOISE12 = (1079, 2047)

# H100 SXM published peaks (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# integer operations per decoded sample, counted off the kernel source
# (phase 1's VLC/UVLC pair decode and MEL shared over a quad's eight
# samples, phase 2's kappa, U_q and scan shared over four, and each
# sample's bit count, window, value assembly and store)
OPS_PER_SAMPLE = 36
# integer operations per encoded sample, counted off ht_cleanup_encode.cu,
# per quad (4 samples) and lane: ~64 for the samples' exponents, MagSgn
# values and rho, ~35 for the context (shuffles, the row above's entries,
# c_q, max_e, kappa), ~45 for u_q, eps, the tuple and the MagSgn lengths,
# ~25 for its half of the pair's VLC bits and MEL events, ~17 for the
# scan, ~45 for the ten atomic ORs, ~10 for the events' reduction and the
# context store, ~6 for the ring's stores: ~250, or 62 per sample (the MEL
# coder, a table step per four events, adds under one per sample)
ENC_OPS_PER_SAMPLE = 62
# integer operations per codeblock sample of the refinement kernel,
# counted off ht_refine_decode.cu: ~8 for the significance words (load,
# test, index, atomic OR), ~6 for SigProp (a group's ~45-op context over
# 16 samples, ~10 a candidate, ~10 a newly significant sample), ~6 for
# MagRef (~20 a step over up to 32 samples, ~12 a significant sample)
REFINE_OPS_PER_SAMPLE = 20


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
    """Mean device time of fn() over reps launches, after a warm-up.  The
    card first sleeps until the host has queued every launch, so they run
    back to back and the events time the device, not the host's
    enqueueing (a wrapper's Python costs tens of microseconds a call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # clock64 cycles at up to 1.98 GHz: the reps' host time, twice over,
    # plus a millisecond
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * 1.98e9))
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
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(f,))
               for f in (K.load, E.load, R.load, R5.load, native.have_native,
                         lambda: phase_builds(0), lambda: phase_builds(1))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, dict(_build.BUILD_SECONDS)


_PHASE_LIBS = {}


def phase_builds(stop: int):
    """The decode kernel built to stop each codeblock after phase
    ``stop`` (OJK_STOP_AFTER), for the phase split."""
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    if stop not in _PHASE_LIBS:
        _PHASE_LIBS[stop] = K.build(
            K.SRC, f'ht_cleanup_decode_stop{stop}',
            defines=(f'OJK_STOP_AFTER={stop}',))
    return _PHASE_LIBS[stop]


def runner_views(data: bytes, dev):
    """(plan, raw (src, views), dense (src, views)) of one frame: its
    buffers uploaded to the card in both runner modes and sliced per
    lane group as the runner slices them (_Runner.views)."""
    from openjph_tpu_torch.gpu.pipeline import (GpuDecoder, _build_plan,
                                                _make_runner, _pack_dense,
                                                _pack_device, upload)
    dec = GpuDecoder(data, device=dev)
    plan = _build_plan(dec)
    pairs = [(dec, plan)]
    return (plan,
            _make_runner(plan, 1, dev, True).views(
                *upload(_pack_device(pairs), dev)),
            _make_runner(plan, 1, dev, False).views(
                *upload(_pack_dense(pairs), dev)))


def cleanup_args(src, views, raw: bool):
    """Per lane group: the cleanup kernel's arguments as the runner
    builds them (a 64-bit group's with its sample width), with the
    group's meta columns."""
    from openjph_tpu_torch.gpu.pipeline import _window
    out = []
    for g, c, _ in views:
        if raw:
            args = (src, c[0], c[1], c[2], c[6], g.w, g.h, c[7], g.words)
        else:
            wm, wv, ws = g.words
            args = (_window(src, c[0], c[1], wm, -1),
                    _window(src, c[2], c[3], wv, 0),
                    _window(src, c[4], c[5], ws, -1), c[6], g.w, g.h,
                    c[7])
        if g.bits == 64:
            args += (64,)
        out.append((g, args, c))
    return out


def launch_counts(*mods, wide: bool = False) -> dict:
    """The launch counts of the wrappers ``mods``: their 32-bit entries,
    or with ``wide`` their 64-bit instantiations (only the ``wide`` phase
    drives those)."""
    return {k: v for m in mods for k, v in m.LAUNCHES.items()
            if k.endswith('64') == wide}


def frame_views(data: bytes, dev):
    """(plan, raw-mode group views, dense-mode group views) of one
    frame's cleanup-kernel arguments on the card."""
    plan, (rsrc, rv), (dsrc, dv) = runner_views(data, dev)
    return plan, cleanup_args(rsrc, rv, True), cleanup_args(dsrc, dv, False)


def corrupt_views(views, seed: int, lanes: int = 64, flips: int = 4):
    """The raw-mode views with ``flips`` seeded byte flips in the MagSgn
    and MEL / VLC bytes of about ``lanes`` live lanes, and dense-mode
    views of the same damaged bytes (the plain unstuffer's word rows)."""
    import types
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu.block_decode import to_i32_bits
    from openjph_tpu_torch.gpu.unstuff import raw_to_dense
    rng = np.random.RandomState(seed)
    blob = views[0][1][0].clone()
    live = [(g, i) for g, _, c in views
            for i in np.nonzero((c[7] > 0).cpu().numpy())[0]]
    picks = rng.choice(len(live), min(lanes, len(live)), replace=False)
    for k in picks:
        g, i = live[k]
        c = next(c for h, _, c in views if h is g)
        off, n = int(c[0][i]), int(c[1][i] + c[2][i])
        for _ in range(flips):
            at = off + int(rng.randint(0, n))
            blob[at] ^= int(rng.randint(1, 256))
    raw, dense = [], []
    for g, args, c in views:
        raw.append((g, (blob,) + tuple(args[1:]), c))
        mel, vlc, ms = raw_to_dense(blob, c[0], c[1], c[2], g.words)
        dense.append((g, tuple(to_i32_bits(t).contiguous()
                               for t in (mel, vlc, ms))
                      + (c[6], g.w, g.h, c[7]), c))
    return raw, dense, len(picks)


def hold(kname, kern, ref, views, valid: bool):
    """Kernel against plain version on every lane of ``views``: equal
    samples (rows at or past 2*qhl are zero in both) and equal error
    flags.  Returns (plain ms, kernel outputs per group)."""
    import torch
    plain_ms = 0.0
    outs = []
    for g, args, c in views:
        d, e = kern(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp, ep = ref(*args)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not torch.equal(e, ep):
            raise AssertionError(f'{kname}: error flags differ from the '
                                 f'plain version in group {g.w}x{g.h}')
        if not torch.equal(d, dp):
            raise AssertionError(f'{kname}: samples differ from the plain '
                                 f'version in group {g.w}x{g.h}')
        if valid and bool(e[c[7] > 0].any()):
            raise AssertionError(f'{kname}: flagged a lane of a valid '
                                 f'stream')
        outs.append((d, e))
    return plain_ms, outs


def kernel_modes():
    """(name, wrapper, plain version, raw?) of both reader modes."""
    from openjph_tpu_torch.gpu import block_decode as plain
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    return (('ht_cleanup_decode_raw', K.decode_cleanup_raw,
             K.decode_cleanup_raw_plain, True),
            ('ht_cleanup_decode_dense', K.decode_cleanup,
             plain.decode_cleanup_core, False))


def kernel_vs_plain(data: bytes, dev, name: str, card_id: str):
    """Both reader modes of the kernel against their plain versions on
    every lane of one frame, on the card, timed, with the sweep over
    codeblocks per CUDA block; returns the kernels-line rows."""
    import torch
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    _, rviews, dviews = frame_views(data, dev)
    rows = {}
    for kname, kern, ref, raw in kernel_modes():
        views = rviews if raw else dviews
        plain_ms, _ = hold(kname, kern, ref, views, True)
        ms = sum(cuda_ms(lambda: kern(*a), 20) for _, a, _ in views)
        lanes = live = coded = out_bytes = samples = 0
        for g, args, c in views:
            qhl = c[7].to(torch.int64)
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
            'launches': 0, 'max_abs_err': 0, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None, 'bit_exact': True,
        }
        # codeblocks per CUDA block: the launch setting against others
        sweep = {}
        default = K.PER_BLOCK
        try:
            for k in (1, 2, 4, 8):
                K.PER_BLOCK = k
                sweep[k] = sum(cuda_ms(lambda: kern(*a), 20)
                               for _, a, _ in views)
        finally:
            K.PER_BLOCK = default
        # the phases: builds that stop after phase 0 and after phase 1
        stops = [sum(cuda_ms(lambda: run(*a), 20) for _, a, _ in views)
                 for run in (other_build(phase_builds(s), raw, default)
                             for s in (0, 1))]
        emit('phase_split', frame=name, kernel=kname,
             phase0_ms=stops[0], phase1_ms=stops[1] - stops[0],
             phase2_ms=ms - stops[1], all_ms=ms, card=card_id)
        emit('kernel_vs_plain', frame=name, kernel=kname, lanes=lanes,
             live_lanes=live, bit_exact=True, kernel_ms=ms,
             plain_ms=plain_ms, bytes_moved=nbytes, samples=samples,
             bound_ms=rows[kname]['bound_ms'],
             longest_lane_pair_steps=pair_steps(views),
             codeblocks_per_block=default,
             kernel_ms_by_codeblocks_per_block=sweep, card=card_id)
    return rows


def pair_steps(views) -> int:
    """Pair steps of the frame's longest lane: its quad rows (qhl) times
    the pairs of quads in a row."""
    return max(int(c[7].max()) * ((((g.w + 1) // 2) + 1) // 2)
               for g, _, c in views)


def shapes_vs_plain(dev, card_id: str):
    """Codeblocks wider and taller than 64: a seeded noise frame encoded
    on the card with 128x32 and with 32x128 blocks, the encode kernel and
    then the decode kernel in both modes held against their plain
    versions on every lane."""
    import numpy as np
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    frame = np.random.RandomState(3).randint(0, 256, NOISE).astype(np.int32)
    for bs in ((128, 32), (32, 128)):
        k3_vs_plain([frame], dev, f'noise_{bs[0]}x{bs[1]}', card_id,
                    reversible=True, block_size=bs)
        data = encode_gpu(frame, device='cuda', reversible=True,
                          block_size=bs)
        plan, rviews, dviews = frame_views(data, dev)
        for kname, kern, ref, raw in kernel_modes():
            views = rviews if raw else dviews
            plain_ms, _ = hold(kname, kern, ref, views, True)
            ms = sum(cuda_ms(lambda: kern(*a), 20) for _, a, _ in views)
            emit('shapes_vs_plain', block_size=list(bs), kernel=kname,
                 bit_exact=True, lanes=sum(g.n_pad for g in plan.groups),
                 groups=[(g.w, g.h, g.n_pad) for g in plan.groups],
                 max_quads_per_row=max((g.w + 1) // 2 for g in plan.groups),
                 kernel_ms=ms, plain_ms=plain_ms, card=card_id)


def other_build(lib, raw: bool, per_block: int):
    """A launcher of another build of the kernel's source (``lib``) that
    takes the wrapper's arguments; its launches are not counted."""
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    if raw:
        return lambda *a: K.launch_raw(lib, per_block, *a[:-1])
    return lambda *a: K.launch_dense(lib, per_block, *a)


def corrupted_vs_plain(data: bytes, dev, card_id: str, lib=None):
    """The gray frame's inputs with seeded byte flips in about 64 lanes,
    kernel against plain version in both modes (samples and error
    flags).  ``lib``: another build of the kernel's source (the one
    ``--against`` names, two codeblocks per block) to hold instead."""
    _, rviews, _ = frame_views(data, dev)
    raw_v, dense_v, hit = corrupt_views(rviews, seed=11)
    for kname, kern, ref, raw in kernel_modes():
        if lib is not None:
            kern = other_build(lib, raw, 2)
        views = raw_v if raw else dense_v
        _, outs = hold(kname, kern, ref, views, False)
        emit('corrupted_vs_plain', kernel=kname, damaged_lanes=hit,
             flagged_lanes=sum(int(e.sum()) for _, e in outs),
             bit_exact=True, build='main' if lib is None else 'against',
             card=card_id)


def against(src: str, dev, card_id: str):
    """``--against SRC``: another source of the decode kernel with the
    same C interface (launched with two codeblocks per block) and this
    checkout's, in turns on the gray frame in both modes (against, this,
    this, against): equal outputs, their times, and the other build held
    against the plain version on the corrupted-lane copy."""
    import torch
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    gray = open(GRAY, 'rb').read()
    K.load()
    lib = K.build(os.path.abspath(src), 'ht_cleanup_decode_against')
    _, rviews, dviews = frame_views(gray, dev)
    for kname, kern, _, raw in kernel_modes():
        views = rviews if raw else dviews
        other = other_build(lib, raw, 2)
        for g, a, _ in views:
            d0, e0 = other(*a)
            d1, e1 = kern(*a)
            torch.cuda.synchronize()
            if not (torch.equal(d0, d1) and torch.equal(e0, e1)):
                raise AssertionError(f'{kname}: {src} and this checkout '
                                     f'differ in group {g.w}x{g.h}')
        times = {'against': [], 'this': []}
        for who in ('against', 'this', 'this', 'against'):
            fn = other if who == 'against' else kern
            times[who].append(sum(cuda_ms(lambda: fn(*a), 20)
                                  for _, a, _ in views))
        steps = pair_steps(views)
        old = statistics.mean(times['against'])
        new = statistics.mean(times['this'])
        emit('against', kernel=kname, source=src, equal=True,
             against_ms=times['against'], this_ms=times['this'],
             speedup=old / new, longest_lane_pair_steps=steps,
             against_ns_per_pair_step=old * 1e6 / steps,
             this_ns_per_pair_step=new * 1e6 / steps,
             this_codeblocks_per_block=K.PER_BLOCK, card=card_id)
    try:
        corrupted_vs_plain(gray, dev, card_id, lib)
    except AssertionError as e:
        emit('corrupted_vs_plain', build='against', bit_exact=False,
             error=str(e), card=card_id)


def decode_frames(datas, dev, raw: bool = True, resilient: bool = False):
    """Bytes -> frames in device memory through the fused decode, with
    per-stage times; Tier-1 is split into the cleanup kernel, the
    refinement kernel (multi-pass groups only) and the masking of dead
    and broken lanes.  Returns (outputs, times in ms)."""
    import torch
    from openjph_tpu_torch.gpu.pipeline import (GpuDecoder, _build_plan,
                                                _make_runner, _merge_words,
                                                _pack_dense, _pack_device,
                                                upload)
    t0 = time.perf_counter()
    decs = [GpuDecoder(d, device=dev, raw=raw, resilient=resilient)
            for d in datas]
    # distinct frames of one geometry share the largest word buckets
    pairs = list(zip(decs, _merge_words([_build_plan(d) for d in decs])))
    t1 = time.perf_counter()
    args = _pack_device(pairs) if raw else _pack_dense(pairs)
    t2 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    dargs = upload(args, dev)
    ev[1].record()
    runner = _make_runner(pairs[0][1], len(datas), dev, raw)
    src, views = runner.views(*dargs)
    outs = runner.cleanup(src, views)
    ev[2].record()
    outs = runner.refine(src, views, outs)
    ev[3].record()
    decs, errs = runner.mask(views, outs)
    ev[4].record()
    outs = runner.rest(decs)
    ev[5].record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if not resilient and bool(torch.cat(errs).any()):
        raise AssertionError('a lane of a valid stream was flagged')
    times = {'host_t2_plan': (t1 - t0) * 1e3, 'pack': (t2 - t1) * 1e3,
             'upload': ev[0].elapsed_time(ev[1]),
             'tier1': ev[1].elapsed_time(ev[4]),
             'tier1_cleanup': ev[1].elapsed_time(ev[2]),
             'tier1_refine': ev[2].elapsed_time(ev[3]),
             'tier1_mask': ev[3].elapsed_time(ev[4]),
             'rest_of_graph': ev[4].elapsed_time(ev[5]),
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


def k3_groups(planes, dev, **kwargs):
    """(plan, [(group, encode_cleanup's arguments)]) of one frame's fused
    encode on the card."""
    plan, runner, batches = enc_batches(planes, dev, **kwargs)
    return plan, [(g, (buf, p, g.w, g.h, g.caps, qhl))
                  for g, (buf, _), p, qhl in zip(plan.groups, batches,
                                                  runner.lane_p,
                                                  runner.lane_qhl)]


def k3_pair_steps(groups) -> int:
    """Pair steps of the longest lane: its quad rows times the pairs of
    quads in a row."""
    return max(int(a[5].max()) * ((((g.w + 1) // 2) + 1) // 2)
               for g, a in groups)


def k3_vs_plain(planes, dev, name: str, card_id: str, sweep: bool = False,
                **kwargs):
    """The encode kernel against its plain version on every lane of one
    frame's group batches, on the card: bit counts, overflow flags and
    every word.  ``sweep`` times codeblocks per CUDA block 1 / 2 / 4 / 8.
    Returns its kernels-line row."""
    import torch
    from openjph_tpu_torch.gpu import block_encode as plain
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    plan, groups = k3_groups(planes, dev, **kwargs)
    lanes = live = samples = nbytes = zero_tail = 0
    ms = plain_ms = zeros_ms = 0.0
    odd_qw_lanes = 0
    for g, args in groups:
        cat, bits, ovf = E.encode_cleanup(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cat_p, bits_p, ovf_p = plain.encode_cleanup_core(*args)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not torch.equal(bits, bits_p) or not torch.equal(ovf, ovf_p):
            raise AssertionError(f'ht_cleanup_encode: bit counts or '
                                 f'overflow flags differ from the plain '
                                 f'version in group {g.w}x{g.h} of {name}')
        if bool(ovf.any()):
            raise AssertionError(f'ht_cleanup_encode: a lane of {name} '
                                 f'overflowed')
        # every word is compared: both versions leave the words past
        # each stream's used prefix zero
        if not torch.equal(cat, cat_p):
            raise AssertionError(f'ht_cleanup_encode: words differ from '
                                 f'the plain version in group {g.w}x{g.h} '
                                 f'of {name}')
        ms += cuda_ms(lambda: E.encode_cleanup(*args), 20)
        buf, qhl = args[0], args[5]
        n = buf.shape[0]
        # what zeroing cat would cost a caller whose kernel left the
        # words past each used prefix to it (this kernel stores them)
        zeros_ms += cuda_ms(lambda: torch.zeros(
            (n, sum(g.caps)), dtype=torch.int32, device=dev), 20)
        lanes += n
        live += int((qhl > 0).sum())
        if ((g.w + 1) // 2) % 2:
            odd_qw_lanes += int((qhl > 0).sum())
        rows = (2 * qhl.to(torch.int64)).clamp(max=g.h)
        samples += int(rows.sum()) * g.w
        used = int(((bits.to(torch.int64) + 31) // 32).sum())
        # the bound as defined since the kernel's first port: samples and
        # per-lane p/qhl in; used words, bit counts and flags out.  The
        # zeros the kernel stores past the used prefixes, which no
        # consumer reads, are reported apart
        nbytes += buf.numel() * 4 + n * 8 + used * 4 + n * 16
        zero_tail += (n * sum(g.caps) - used) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = samples * ENC_OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3
    fields = {}
    if sweep:
        # codeblocks per CUDA block: the launch setting against others, on
        # the frame and on its lanes repeated as in an 8-frame burst
        burst = [(buf.repeat(BURST, 1, 1), p.repeat(BURST), w, h, caps,
                  qhl.repeat(BURST))
                 for _, (buf, p, w, h, caps, qhl) in groups]
        for key, sets in (('kernel_ms_by_codeblocks_per_block', groups),
                          ('burst_ms_by_codeblocks_per_block',
                           [(None, b) for b in burst])):
            fields[key] = {k: sum(cuda_ms(lambda: E.launch(E.load(), k, *a),
                                          20) for _, a in sets)
                           for k in (1, 2, 4, 8)}
    emit('k3_vs_plain', frame=name, lanes=lanes, live_lanes=live,
         odd_qw_live_lanes=odd_qw_lanes,
         groups=[(g.w, g.h, len(g.lanes), g.n_pad, list(g.caps))
                 for g in plan.groups],
         bit_exact=True, kernel_ms=ms, plain_ms=plain_ms, bytes_moved=nbytes,
         zero_tail_bytes=zero_tail, caller_zeros_ms=zeros_ms,
         samples=samples, bound_ms=max(bytes_ms, ops_ms),
         longest_lane_pair_steps=k3_pair_steps(groups),
         codeblocks_per_block=E.PER_BLOCK, card=card_id, **fields)
    return {
        'name': 'ht_cleanup_encode', 'route': 'cuda',
        'source': 'openjph_tpu_torch/gpu/csrc/ht_cleanup_encode.cu',
        'replaces': 'openjph_tpu/tpu/block_encode_pallas.py:671',
        'launches': 0, 'max_abs_err': 0, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': max(bytes_ms, ops_ms),
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': None, 'bit_exact': True,
    }


def against_encode(src: str, dev, card_id: str):
    """``--against-encode SRC``: another source of the encode kernel with
    the same C interface (two codeblocks per block, handed a zeroed
    output) and this checkout's, on the gray frame: equal outputs on
    every lane, then their times in turns (against, this, this,
    against)."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    E.load()
    lib = E.build(os.path.abspath(src), 'ht_cleanup_encode_against')
    _, groups = k3_groups([np.load(GRAY_NPY)], dev, reversible=True)

    def other(*a):
        return E.launch(lib, 2, *a, zeroed=True)

    for g, a in groups:
        got, want = E.encode_cleanup(*a), other(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f'ht_cleanup_encode: {src} and this '
                                 f'checkout differ in group {g.w}x{g.h}')
    times = {'against': [], 'this': []}
    for who in ('against', 'this', 'this', 'against'):
        fn = other if who == 'against' else E.encode_cleanup
        times[who].append(sum(cuda_ms(lambda: fn(*a), 20)
                              for _, a in groups))
    steps = k3_pair_steps(groups)
    old = statistics.mean(times['against'])
    new = statistics.mean(times['this'])
    emit('against_encode', kernel='ht_cleanup_encode', source=src,
         equal=True, lanes=sum(a[0].shape[0] for _, a in groups),
         against_ms=times['against'], this_ms=times['this'],
         speedup=old / new, longest_lane_pair_steps=steps,
         against_ns_per_pair_step=old * 1e6 / steps,
         this_ns_per_pair_step=new * 1e6 / steps,
         this_codeblocks_per_block=E.PER_BLOCK, card=card_id)


def encode_frames(frames, dev, make=None):
    """Gray frames in host memory -> lossless .j2c streams through the
    fused encode, with per-stage times; ``make(shape, dev)`` gives the
    (encoder, tile geometry), by default 5/3 with openjph_tpu.encode's
    defaults.  Returns (streams, times in ms)."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu.encode_pipeline import (_empty_coded,
                                                       _fetch_outs,
                                                       _make_enc_runner,
                                                       _narrow_tile_plane,
                                                       _tile_packets)
    F = len(frames)
    t0 = time.perf_counter()
    enc, geom = (make or dfs_free)(frames[0].shape, dev)
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
    outs = _fetch_outs(plan, cats, aux, F)
    t4 = time.perf_counter()
    codeds = [_empty_coded(geom, 1) for _ in range(F)]
    enc._stuff(plan, *outs, codeds)
    t5 = time.perf_counter()
    streams = [enc.assemble([_tile_packets(enc, geom, c)]) for c in codeds]
    t6 = time.perf_counter()
    # a multi-pass plan's Tier-1: K3, K5 and K3 again on its groups
    tier1 = 'tier1_k3_k5_k3' if any(g.rcap for g in plan.groups) \
        else 'tier1_k3'
    times = {'host_plan': (t1 - t0) * 1e3, 'narrow': (t2 - t1) * 1e3,
             'upload': ev[0].elapsed_time(ev[1]),
             'device_graph': ev[1].elapsed_time(ev[2]),
             tier1: ev[2].elapsed_time(ev[3]),
             'fetch_compact_d2h': (t4 - t3) * 1e3,
             'host_stuffing': (t5 - t4) * 1e3,
             't2_assemble': (t6 - t5) * 1e3, 'total': (t6 - t0) * 1e3}
    return streams, times


def dfs_free(shape, dev):
    return encoder(shape, 1, dev, reversible=True)


# the DFS phase's decomposition structure, finest level first: a
# horizontal-only level, a vertical-only one, then three in both ways
DFS_TYPES = ('HORZ_DWT', 'VERT_DWT', 'BIDIR_DWT', 'BIDIR_DWT', 'BIDIR_DWT')


def dfs_encoder(shape, dev):
    """(GpuEncoder, tile geometry) of 8-bit gray frames of ``shape``,
    lossless 5/3, 64x64 codeblocks, with DFS_TYPES signalled by a COC
    (tests/test_torch_dfs_encode.py builds its encoders so)."""
    from openjph_tpu_torch.core import markers as mk
    from openjph_tpu_torch.core.geometry import build_tile, build_tile_grid
    from openjph_tpu_torch.gpu.encode_pipeline import GpuEncoder
    siz = mk.Siz()
    siz.xsiz, siz.ysiz = shape[1], shape[0]
    siz.comps = [mk.CompInfo(8, False, 1, 1)]
    nd = len(DFS_TYPES)
    cod = mk.Cod(num_decomps=nd, wavelet_kern=mk.DWT_REV53)
    coc = mk.Cod(num_decomps=nd, wavelet_kern=mk.DWT_REV53, comp_idx=0,
                 dfs_idx=0)
    dfs = mk.Dfs.from_types(0, [getattr(mk.Dfs, t) for t in DFS_TYPES])
    enc = GpuEncoder(siz, cod, cocs={0: coc}, dfs_list=[dfs], device=dev)
    return enc, build_tile(enc.hdr, 0, build_tile_grid(enc.siz)[0])


def from_sot(stream: bytes) -> bytes:
    """The codestream from its first SOT marker (FF 90) on."""
    at = stream.find(b'\xff\x90')
    if at < 0:
        raise AssertionError('no SOT marker in the stream')
    return stream[at:]


# ---- the refinement-pass kernel (K4) ----

def k4_modes():
    """(name, wrapper, plain version, raw?) of both reader modes."""
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    return (('ht_refine_decode_raw', R.refine_raw, R.refine_raw_plain, True),
            ('ht_refine_decode_dense', R.refine, R.refine_plain, False))


def k4_groups(data: bytes, dev):
    """(plan, {raw?: [(group, dec, refine args)]}) of one frame's lane
    groups that have refinement passes: dec is the card's own cleanup
    kernel output, the args follow it as the runner passes them."""
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu.pipeline import _window
    plan, rsv, dsv = runner_views(data, dev)
    out = {}
    for raw, (src, views) in ((True, rsv), (False, dsv)):
        out[raw] = []
        for (g, args, c), (_, _, rc) in zip(cleanup_args(src, views, raw),
                                            views):
            if rc is None:
                continue
            d, _ = (K.decode_cleanup_raw if raw else K.decode_cleanup)(*args)
            if raw:
                kargs = (src, rc[0], rc[1], c[6], rc[4], rc[5], rc[6], g.w,
                         g.h)
            else:
                kargs = (_window(src, rc[0], rc[1], g.rwords[0], 0),
                         _window(src, rc[2], rc[3], g.rwords[1], 0), c[6],
                         rc[4], rc[5], rc[6], g.w, g.h)
            out[raw].append((g, d, kargs))
    return plan, out


def k4_gates(groups, raw: bool, npasses=None, flip=False, h_lim=None):
    """The same groups with every lane's npasses and h_lim set where
    given, and its causal flag flipped when ``flip``."""
    import torch
    i = 4 if raw else 3
    res = []
    for g, d, a in groups:
        a = list(a)
        if npasses is not None:
            a[i] = torch.full_like(a[i], npasses)
        if h_lim is not None:
            a[i + 1] = torch.full_like(a[i + 1], h_lim)
        if flip:
            a[i + 2] = (a[i + 2] == 0).to(torch.int32)
        res.append((g, d, tuple(a)))
    return res


def hold_k4(kname, kern, ref, groups, label: str):
    """The refinement kernel against its plain version on every lane of
    ``groups``: the same cleanup output, streams and gates.  The kernel
    refines a copy of dec in place.  Returns (plain ms, kernel outputs)."""
    import torch
    plain_ms = 0.0
    outs = []
    for g, d, a in groups:
        got = kern(d.clone(), *a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref(d, *a)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            bad = int((got != want).flatten(1).any(1).sum())
            raise AssertionError(f'{kname}: {bad} lanes differ from the '
                                 f'plain version in group {g.w}x{g.h} '
                                 f'({label})')
        outs.append(got)
    return plain_ms, outs


def k4_ms(kern, groups) -> float:
    """Device ms of the kernel on every group: each launch refines a fresh
    copy of dec, and the copy's own time is taken off."""
    import torch
    ms = 0.0
    for _, d, a in groups:
        work = torch.empty_like(d)
        ms += cuda_ms(lambda: kern(work.copy_(d), *a), 20) \
            - cuda_ms(lambda: work.copy_(d), 20)
    return ms


def other_k4(lib, raw: bool, per_block: int):
    """A launcher of another build of the refinement kernel's source
    (``lib``) that takes the wrapper's arguments; its launches are not
    counted."""
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    launch = R.launch_raw if raw else R.launch_dense
    return lambda *a: launch(lib, per_block, *a)


def k4_burst(groups, raw: bool):
    """The groups with every lane repeated BURST times, as the refine
    step of an 8-frame burst sees them (the raw blob is shared)."""
    res = []
    for g, d, a in groups:
        n = d.shape[0]
        a = tuple(t.repeat(BURST, *([1] * (t.dim() - 1)))
                  if hasattr(t, 'shape') and t.shape[0] == n
                  and not (raw and i == 0) else t
                  for i, t in enumerate(a))
        res.append((g, d.repeat(BURST, 1, 1), a))
    return res


def k4_chain_groups(groups, raw: bool) -> int:
    """SigProp groups of the longest chain: over the lanes with
    npasses >= 2, the stripes below h_lim times the groups a stripe."""
    import torch
    i = 4 if raw else 3
    best = 0
    for g, d, a in groups:
        h = d.shape[1]
        n_sy, n_gx = (h + 3) // 4, (d.shape[2] + 3) // 4
        hl = a[i + 1].to(torch.int64)
        st = ((hl.clamp(min=0, max=4 * n_sy) + 3) // 4)[a[i] >= 2]
        if st.numel():
            best = max(best, int(st.max()) * n_gx)
    return best


def k4_bound_round_trip(groups, raw: bool):
    """(bytes, ops) of the refinement of ``groups`` by the earlier, looser
    count, kept so that times compare with those measured against it: the
    dec round trip of every lane, the refinement bytes (raw) or all words
    of the dense rows, 32 bytes of meta a lane; REFINE_OPS_PER_SAMPLE a
    sample."""
    nbytes = ops = 0
    for g, d, a in groups:
        n = d.shape[0]
        nbytes += 2 * d.numel() * 4 + 32 * n
        if raw:
            nbytes += int(a[2].sum())
        else:
            nbytes += 4 * (a[0].numel() + a[1].numel())
        ops += d.numel() * REFINE_OPS_PER_SAMPLE
    return nbytes, ops


def k4_bound(groups, raw: bool, outs):
    """(bytes, ops) the refinement of ``groups`` must move and do, counted
    from this run's data (``outs``: the refined dec, equal to the plain
    version's): the rows below h_lim of each lane with npasses >= 2 read
    once; each sample the refinement changes written once; the
    refinement bits once: raw, those lanes' segments; dense, their
    SigProp rows up to the last nonzero word (the segment unstuffed;
    MagRef's row holds the same bits reversed); npasses of every lane and
    the other gates (raw also roff and len2) of those lanes;
    REFINE_OPS_PER_SAMPLE a sample read.  Samples are 4 bytes, 8 in the
    64-bit instantiation."""
    import torch
    i = 4 if raw else 3
    nbytes = ops = 0
    for (g, d, a), out in zip(groups, outs):
        n, h, w = d.shape
        sz = d.element_size()
        live = a[i] >= 2
        rows = a[i + 1].to(torch.int64).clamp(min=0, max=h)[live]
        read = int(rows.sum()) * w
        nbytes += sz * read + sz * int((out != d).sum())
        if raw:
            nbytes += int(a[2][live].to(torch.int64).clamp(min=0).sum())
        else:
            nz = a[0][live] != 0
            last = (nz.shape[1] - nz.flip(1).int().argmax(1)) * nz.any(1)
            nbytes += 4 * int(last.sum())
        nbytes += 4 * n + (20 if raw else 12) * int(live.sum())
        ops += read * REFINE_OPS_PER_SAMPLE
    return nbytes, ops


def hold_k4_burst(kname, kern, groups, outs, raw: bool, label: str) -> int:
    """The kernel on ``groups``' lanes repeated BURST times, as the
    burst's refine step launches them, against ``outs`` (their held
    outputs) repeated.  Returns the lanes that ran in launches whose
    SigProp chains share a warp (ht_refine_packs)."""
    import torch
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    lib = R.load()
    packed = 0
    for (g, d, a), want in zip(k4_burst(groups, raw), outs):
        got = kern(d.clone(), *a)
        torch.cuda.synchronize()
        if not torch.equal(got, want.repeat(BURST, 1, 1)):
            bad = int((got != want.repeat(BURST, 1, 1)).flatten(1).any(1)
                      .sum())
            raise AssertionError(f'{kname}: {bad} lanes of the burst-sized '
                                 f'launch differ from the frame\'s output in '
                                 f'group {g.w}x{g.h} ({label})')
        n, h, w = d.shape
        pk = lib.ht_refine_packs(n, w, h, R.PER_BLOCK)
        if pk < 0:
            raise RuntimeError(f'ht_refine_packs failed: CUDA error {-pk}')
        packed += n if pk else 0
    return packed


def k4_vs_plain(data: bytes, dev, name: str, card_id: str, rows=None):
    """Both reader modes of the refinement kernel against their plain
    versions on every lane of a multi-pass frame, as coded and with the
    gates forced (npasses 2 and 3 everywhere, causal flipped), each also
    on the lanes repeated as in a burst; the cleanup and refinement
    kernels together against the C++ scalar codeblock decoder on every
    live lane.  With ``rows`` (the 3-pass frame), times the kernel, fills
    in its kernels-line rows and requires the burst-sized launches to
    share warps between chains."""
    import numpy as np
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    plan, modes = k4_groups(data, dev)
    buf = np.frombuffer(data, np.uint8)
    for kname, kern, ref, raw in k4_modes():
        groups = modes[raw]
        if not groups:
            raise AssertionError(f'{name} has no multi-pass lane group')
        # each gate setting held on the frame's lanes, then on those lanes
        # repeated as in a burst: enough that a block's SigProp chains
        # share a warp, which must change nothing
        packed = {}
        for label, gg in (('as coded', groups),) + tuple(
                (f'npasses {k}, causal flipped',
                 k4_gates(groups, raw, npasses=k, flip=True))
                for k in (2, 3)):
            ms_, o = hold_k4(kname, kern, ref, gg, label)
            if label == 'as coded':
                plain_ms, outs = ms_, o
            packed[label] = hold_k4_burst(kname, kern, gg, o, raw, label)
        if rows is not None and not all(packed.values()):
            raise AssertionError(f'{kname}: no burst-sized launch of {name} '
                                 f'shared a warp between chains: {packed}')
        # the cleanup and refinement kernels against the scalar decoder
        live = scalar_lanes(plan, groups, outs, buf, kname)
        fields = {}
        if rows is not None:
            ms = k4_ms(kern, groups)
            nbytes, ops = k4_bound(groups, raw, outs)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / FP32_OPS_PER_S * 1e3
            rt_bytes, rt_ops = k4_bound_round_trip(groups, raw)
            bound_round_trip_ms = max(rt_bytes / HBM_BYTES_PER_S,
                                      rt_ops / FP32_OPS_PER_S) * 1e3
            rows[kname] = {
                'name': kname, 'route': 'cuda',
                'source': 'openjph_tpu_torch/gpu/csrc/ht_refine_decode.cu',
                'replaces': 'openjph_tpu/tpu/block_refine.py:215',
                'launches': 0, 'max_abs_err': 0, 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': max(bytes_ms, ops_ms),
                'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
                'library_ms': None, 'bit_exact': True,
                'bound_round_trip_ms': bound_round_trip_ms,
            }
            # where the time goes, by the kernel's own gates: npasses 1
            # (launch and lane exit), h_lim 0 (the block staged and
            # written back, the streams read, no pass), npasses 2 (no
            # MagRef); and the codeblocks per CUDA block
            split = {k: k4_ms(kern, k4_gates(groups, raw, **kw))
                     for k, kw in (('npasses1', dict(npasses=1)),
                                   ('hlim0', dict(h_lim=0)),
                                   ('npasses2', dict(npasses=2)))}
            # (on the frame and on its lanes repeated as in a burst)
            burst = k4_burst(groups, raw)
            sweep, bsweep = {}, {}
            default = R.PER_BLOCK
            try:
                for k in (1, 2, 4, 8):
                    R.PER_BLOCK = k
                    sweep[k] = k4_ms(kern, groups)
                    bsweep[k] = k4_ms(kern, burst)
            finally:
                R.PER_BLOCK = default
            chain = k4_chain_groups(groups, raw)
            sp_ms = split['npasses2'] - split['hlim0']
            emit('k4_split', frame=name, kernel=kname,
                 launch_ms=split['npasses1'],
                 stage_streams_writeback_ms=split['hlim0']
                 - split['npasses1'],
                 sigprop_and_significance_ms=sp_ms,
                 magref_ms=ms - split['npasses2'], all_ms=ms,
                 longest_chain_groups=chain,
                 sigprop_ns_per_group=sp_ms * 1e6 / max(chain, 1),
                 card=card_id)
            fields = dict(kernel_ms=ms, plain_ms=plain_ms,
                          bytes_moved=nbytes, bound_ms=rows[kname]['bound_ms'],
                          bytes_moved_round_trip=rt_bytes,
                          bound_round_trip_ms=bound_round_trip_ms,
                          warp_shared_bytes=R.load().ht_refine_warp_bytes(
                              groups[0][0].w, groups[0][0].h),
                          codeblocks_per_block=R.PER_BLOCK,
                          kernel_ms_by_codeblocks_per_block=sweep,
                          burst_ms_by_codeblocks_per_block=bsweep)
        emit('k4_vs_plain', frame=name, kernel=kname,
             groups=[(g.w, g.h, g.n_pad, list(g.rwords))
                     for g, _, _ in groups],
             gates=['as coded', 'npasses 2, causal flipped',
                    'npasses 3, causal flipped'],
             bit_exact=True, scalar_decoder_equal_lanes=live,
             burst_sized_bit_exact=True, burst_packed_lanes=packed,
             card=card_id, **fields)


K4_SHAPES = ((64, 64), (128, 32), (32, 128), (36, 20), (13, 7), (62, 33),
             (3, 64))


def k4_synthetic(dev, card_id: str, lanes: int = 256, shapes=K4_SHAPES,
                 seed: int = 4, packed: bool = False):
    """The refinement kernel against its plain version on seeded batches
    of 64x64, 128x32, 32x128 and 36x20 codeblocks, and of 13x7, 62x33 and
    3x64 ones (4x4 groups cut by the width and the height): random
    cleanup samples (any 32-bit value), mixed heights (h_lim), passes,
    causal flags and p (0 to 30, so shifts by p - 2 leave 0..31), and
    refinement segments of random bytes under 2,047, rich in 0xFF, 0x7F
    and bytes above 0x8F.  Both reader modes: the dense rows are the
    plain raw readers' output on the card.  With ``packed``, each launch
    must be one whose SigProp chains share a warp (ht_refine_packs)."""
    import types
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    from openjph_tpu_torch.gpu.block_decode import to_i32_bits
    from openjph_tpu_torch.gpu.unstuff import raw_refine_to_dense
    rng = np.random.RandomState(seed)
    alpha = np.array([0xFF, 0x7F, 0x8F, 0x90, 0xFE, 0x00, 0x80, 0xFF],
                     np.uint8)
    for w, h in shapes:
        pk = R.load().ht_refine_packs(lanes, w, h, R.PER_BLOCK)
        if pk != int(packed):
            raise AssertionError(f'{lanes} lanes of {w}x{h}: '
                                 f'ht_refine_packs gave {pk}, not '
                                 f'{int(packed)}')
        p = rng.randint(0, 31, lanes)
        on = rng.rand(lanes, h, w) < rng.choice([0.02, 0.3, 0.9],
                                                (lanes, 1, 1))
        vals = rng.randint(1, 1 << 32, (lanes, h, w), dtype=np.uint64)
        dec = np.where(on, vals, 0).astype(np.uint32)
        h_lim = rng.randint(0, h + 1, lanes)
        h_lim[:lanes // 4] = h
        npasses = rng.randint(1, 4, lanes)
        causal = rng.randint(0, 2, lanes)
        len2 = rng.randint(0, 2047, lanes)
        blob = np.zeros(int(len2.sum()) + 512, np.uint8)
        roff, at = [], 256
        for i in range(lanes):
            k = int(len2[i])
            blob[at:at + k] = np.where(rng.rand(k) < 0.5,
                                       rng.choice(alpha, k),
                                       rng.randint(0, 256, k))
            roff.append(at)
            at += k

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        d = torch.from_numpy(dec.view(np.int32)).to(dev)
        blob_t = torch.from_numpy(blob).to(dev)
        gates = (t(p), t(npasses), t(h_lim), t(causal), w, h)
        nw = (int(len2.max()) * 8 + 31) // 32 + 3
        spp, mrp = raw_refine_to_dense(blob_t, t(roff), t(len2), nw)
        args = {True: (blob_t, t(roff), t(len2)) + gates,
                False: (to_i32_bits(spp).contiguous(),
                        to_i32_bits(mrp).contiguous()) + gates}
        g = types.SimpleNamespace(w=w, h=h)
        for kname, kern, ref, raw in k4_modes():
            plain_ms, _ = hold_k4(kname, kern, ref, [(g, d, args[raw])],
                                  f'synthetic {w}x{h}')
            emit('k4_synthetic', block=[w, h], kernel=kname, lanes=lanes,
                 chains_share_warps=packed, bit_exact=True,
                 max_len2=int(len2.max()), plain_ms=plain_ms, card=card_id)


def against_refine(src: str, dev, card_id: str):
    """``--against-refine SRC``: another source of the refinement kernel
    with the same decode entries (launched with one codeblock per block;
    handed the column table only where it has the table entry) and this
    checkout's, on the 3-pass gray frame in both modes: equal outputs on
    every lane, then their times in turns (against, this, this,
    against) and SigProp's groups on the longest chain."""
    import torch
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    R.load()
    lib = R.build(os.path.abspath(src), 'ht_refine_decode_against')
    _, modes = k4_groups(open(GRAY3, 'rb').read(), dev)
    for kname, kern, _, raw in k4_modes():
        groups = modes[raw]
        other = other_k4(lib, raw, 1)
        for g, d, a in groups:
            got, want = kern(d.clone(), *a), other(d.clone(), *a)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f'{kname}: {src} and this checkout '
                                     f'differ in group {g.w}x{g.h}')
        times = {'against': [], 'this': []}
        for who in ('against', 'this', 'this', 'against'):
            times[who].append(k4_ms(other if who == 'against' else kern,
                                    groups))
        chain = k4_chain_groups(groups, raw)
        old = statistics.mean(times['against'])
        new = statistics.mean(times['this'])
        emit('against_refine', kernel=kname, source=src, equal=True,
             lanes=sum(d.shape[0] for _, d, _ in groups),
             against_ms=times['against'], this_ms=times['this'],
             speedup=old / new, longest_chain_groups=chain,
             against_ns_per_group=old * 1e6 / chain,
             this_ns_per_group=new * 1e6 / chain,
             this_codeblocks_per_block=R.PER_BLOCK, card=card_id)


def damaged_copies(data: bytes, dev, seed: int, tries: int = 64):
    """[(label, bytes)]: ``data`` cut at 1/4, 1/2 and 3/4 of its length,
    and one seeded flip of 8 bytes (^ 0xA5) in its last quarter, the
    first of ``tries`` seeded offsets whose strict decode on the card
    raises ValueError."""
    import numpy as np
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    n = len(data)
    out = [(f'cut_{k}_of_4', data[:n * k // 4]) for k in (1, 2, 3)]
    rng = np.random.RandomState(seed)
    for _ in range(tries):
        off = int(rng.randint(n * 3 // 4, n - 8))
        bad = bytearray(data)
        for j in range(8):
            bad[off + j] ^= 0xA5
        try:
            decode_gpu(bytes(bad), device=dev)
        except ValueError:
            out.append((f'flip_at_{off}', bytes(bad)))
            return out
    raise AssertionError(f'none of {tries} seeded flips was detected')


def resilient_phase(streams, dev, kernels, K, R):
    """Damaged copies of ``streams`` ((name, bytes, seed)) decoded on the
    card under resilience in both runner modes, each equal to the port's
    CPU decode of the same bytes and zeroing the same lanes; cuts of the
    2-pass causal stream against the committed host decode.  Every
    launch between the counts' reset and their reading is this phase's
    own; they are added to ``kernels``."""
    import numpy as np
    from openjph_tpu_torch.gpu.pipeline import GpuDecoder
    cases = []
    for name, data, seed in streams:
        for label, part in damaged_copies(data, dev, seed):
            t0 = time.perf_counter()
            cpu = GpuDecoder(part, device='cpu', raw=False, resilient=True)
            ref = cpu.decode()
            cases.append((name, label, part, ref, cpu.zeroed,
                          time.perf_counter() - t0))
    causal = open(CAUSAL2, 'rb').read()
    with np.load(CAUSAL2_REF) as z:
        causal_ref = {k: z[k] for k in z.files}
    K.reset_launches()
    R.reset_launches()
    for name, label, part, ref, zeroed, cpu_s in cases:
        for raw in (True, False):
            d = GpuDecoder(part, device=dev, raw=raw, resilient=True)
            out = d.decode()
            if len(out) != len(ref) or not all(
                    np.array_equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f'{name} {label} differs from the CPU '
                                     f'decode (raw={raw})')
            if d.zeroed != zeroed:
                raise AssertionError(f'{name} {label}: the card zeroed '
                                     f'{d.zeroed} lanes, the CPU {zeroed}')
            if label.startswith('flip') and d.zeroed[1] == 0:
                raise AssertionError(f'{name} {label}: no lane flagged')
            emit('resilient', stream=name, case=label, raw=raw,
                 bytes=len(part), zeroed_by_plan=d.zeroed[0],
                 zeroed_by_kernel_flags=d.zeroed[1], equal_to_cpu=True,
                 shape=list(out[0].shape), cpu_reference_s=cpu_s)
    for k in (1, 2, 3):
        part = causal[:len(causal) * k // 4]
        want = causal_ref[f'cut_{len(part)}']
        for raw in (True, False):
            d = GpuDecoder(part, device=dev, raw=raw, resilient=True)
            out = d.decode()
            if len(out) != 1 or not np.array_equal(out[0], want):
                raise AssertionError(f'causal cut {k}/4 differs from the '
                                     f'committed reference (raw={raw})')
            emit('resilient', stream='gray_512x256_rev_p2_causal',
                 case=f'cut_{k}_of_4', raw=raw, bytes=len(part),
                 zeroed_by_plan=d.zeroed[0],
                 zeroed_by_kernel_flags=d.zeroed[1],
                 equal_to_committed_reference=True)
    launches = launch_counts(K, R)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched on the resilient '
                                 f'decode path')
        kernels[k]['launches'] += v
    emit('resilient_path_launches', **launches)


def dfs_phase(gray_ref, dev, kernels, K, E):
    """The gray frame encoded on the card with DFS_TYPES, byte-equal to
    the port's CPU encode and decoding on the card to the frame.  Its
    launches are added to ``kernels``."""
    import numpy as np
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    t0 = time.perf_counter()
    ref = dfs_encoder(gray_ref.shape, 'cpu')[0].encode([gray_ref])
    cpu_s = time.perf_counter() - t0
    K.reset_launches()
    E.reset_launches()
    enc, geom = dfs_encoder(gray_ref.shape, dev)
    got = enc.encode([gray_ref])
    if got != ref:
        raise AssertionError('the DFS encode differs from the CPU encode')
    back = decode_gpu(got, device=dev)
    if len(back) != 1 or not np.array_equal(back[0], gray_ref):
        raise AssertionError('the DFS encode does not decode to the frame')
    launches = launch_counts(E, K)
    for k in ('ht_cleanup_encode', 'ht_cleanup_decode_raw'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched on the DFS path')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    plan = enc._build_enc_plan(geom)
    emit('dfs_encode', levels=list(DFS_TYPES), bytes=len(got),
         equal_to_cpu=True, decodes_to_source=True,
         lane_groups=[[g.w, len(g.lanes)] for g in plan.groups],
         cpu_reference_s=cpu_s)
    emit('dfs_path_launches', **launches)


def in_flight(v, bursts, collect, depth: int = 2):
    """Every burst through the video coder ``v`` with up to ``depth`` in
    flight; ``collect`` takes the oldest.  Returns the collected bursts
    in order."""
    out = []
    for b in bursts:
        if v.depth == depth:
            out.append(collect())
        v.submit(b)
    while v.depth:
        out.append(collect())
    return out


def video_frames(gray_ref):
    """VIDEO_FRAMES distinct frames: the gray frame rolled 37 columns
    further each."""
    import numpy as np
    return [np.ascontiguousarray(np.roll(gray_ref, 37 * k, axis=1))
            for k in range(VIDEO_FRAMES)]


def bursts_of(items):
    return [items[i:i + BURST] for i in range(0, len(items), BURST)]


def video_phase(gray, gray_ref, gray3, gray3_ref, dev, kernels, K, E, R):
    """The video paths on distinct frames, counted: VideoEncoder on
    VIDEO_FRAMES frames (bursts of BURST, two in flight) byte-identical to
    the per-frame encode, frame 0 to gray_2048x1080_rev.j2c from its first
    SOT; VideoDecoder on those streams to the host in both runner modes
    and to the device, bit-exact with the frames; two bursts of the 3-pass
    stream in each runner mode (K4) against its CPU decode;
    decode_gpu_batch of the 3-pass stream and 6 frames, encode_gpu_batch
    of 7 frames (bursts of 4, 2 and 1); a burst holding
    the seed-7 flipped gray copy raising in strict mode and equal to the
    per-frame resilient decodes, the same lanes zeroed.  Every launch
    between the counts' reset and their reading is this phase's own; they
    are added to ``kernels``.  Returns the encoded streams."""
    import numpy as np
    import torch
    from openjph_tpu_torch import (VideoDecoder, VideoEncoder,
                                   decode_gpu_batch, encode_gpu_batch)
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    from openjph_tpu_torch.gpu.pipeline import (GpuDecoder, _build_plan,
                                                _geometry_key)
    frames = video_frames(gray_ref)
    # references, not counted: the per-frame encodes on the card, and the
    # per-frame resilient decodes of the damaged burst
    t0 = time.perf_counter()
    refs = [encode_gpu(f, device=dev, reversible=True) for f in frames]
    flip_label, flip = damaged_copies(gray, dev, 7)[-1]
    damaged = list(refs[:BURST])
    damaged[BURST // 2] = flip
    singles = [GpuDecoder(s, device=dev, resilient=True) for s in damaged]
    single_out = [d.decode() for d in singles]
    zeroed = tuple(sum(z) for z in zip(*(d.zeroed for d in singles)))
    ref_s = time.perf_counter() - t0
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    ve = VideoEncoder(device=dev, reversible=True)
    streams = [st for b in in_flight(ve, bursts_of(frames), ve.collect)
               for st in b]
    if streams != refs:
        bad = [k for k, (a, b) in enumerate(zip(streams, refs)) if a != b]
        raise AssertionError(f'VideoEncoder streams {bad} differ from the '
                             f'per-frame encode')
    if from_sot(streams[0]) != from_sot(gray):
        raise AssertionError('VideoEncoder frame 0 differs from '
                             'gray_2048x1080_rev.j2c from its first SOT on')
    counts = {'encode': (ve.fused_bursts, ve.fallback_bursts)}
    ve.close()
    # how many bursts of these frames need their word buckets merged to
    # fuse (the reference decodes those frame by frame)
    keys = [_build_plan(GpuDecoder(st, device=dev)).key for st in streams]
    merged = sum(len(set(b)) > 1 for b in bursts_of(keys))
    for raw in (True, False):
        vd = VideoDecoder(device=dev, raw=raw)
        got = [f for b in in_flight(vd, bursts_of(streams), vd.collect)
               for f in b]
        for k, (g, f) in enumerate(zip(got, frames)):
            if len(g) != 1 or not np.array_equal(g[0], f):
                raise AssertionError(f'VideoDecoder frame {k} differs from '
                                     f'its source (raw={raw})')
        counts['decode_raw' if raw else 'decode_dense'] = (
            vd.fused_bursts, vd.fallback_bursts)
        vd.close()
    src = torch.from_numpy(np.stack(frames).astype(np.uint8)).to(dev)
    # two in flight; every burst in flight (the staging ring of three
    # buffers wraps while copies may run); pageable uploads
    for name, depth, stage in (('decode_to_device', 2, True),
                               ('decode_to_device_all_in_flight',
                                VIDEO_FRAMES // BURST, True),
                               ('decode_to_device_pageable', 2, False)):
        vd = VideoDecoder(device=dev, to_device=True, stage_uploads=stage)
        outs = in_flight(vd, bursts_of(streams), vd.collect_on_device,
                         depth)
        vd.drain_errors()
        for b, o in enumerate(outs):
            if not torch.equal(o[0][0], src[b * BURST:(b + 1) * BURST]):
                raise AssertionError(f'{name}: burst {b} differs from its '
                                     f'sources')
        counts[name] = (vd.fused_bursts, vd.fallback_bursts)
        vd.close()
    for raw in (True, False):
        vd = VideoDecoder(device=dev, raw=raw)
        for b in in_flight(vd, [[gray3] * BURST] * 2, vd.collect):
            if any(len(f) != 1 or not np.array_equal(f[0], gray3_ref[0])
                   for f in b):
                raise AssertionError(f'a 3-pass burst frame differs from '
                                     f'the CPU decode (raw={raw})')
        counts['multipass_raw' if raw else 'multipass_dense'] = (
            vd.fused_bursts, vd.fallback_bursts)
        vd.close()
    # the synchronous batch entry points: 7 items, bursts of 4, 2 and 1,
    # the 3-pass stream in the first (one geometry: the single-pass
    # frames take its refinement buckets and run K4 on no pass)
    got = decode_gpu_batch([gray3] + streams[:6], device=dev)
    if not np.array_equal(got[0][0], gray3_ref[0]) or any(
            not np.array_equal(g[0], f) for g, f in zip(got[1:], frames)):
        raise AssertionError('decode_gpu_batch differs from the sources')
    if encode_gpu_batch(frames[:7], device=dev, reversible=True) != refs[:7]:
        raise AssertionError('encode_gpu_batch differs from the per-frame '
                             'encode')
    vd = VideoDecoder(device=dev)
    vd.submit(damaged)
    try:
        vd.collect()
    except ValueError:
        pass
    else:
        raise AssertionError('the strict burst holding the damaged copy '
                             'did not raise')
    counts['damaged_strict'] = (vd.fused_bursts, vd.fallback_bursts)
    vd.close()
    vd = VideoDecoder(device=dev, resilient=True)
    vd.submit(damaged)
    got = vd.collect()
    if any(not np.array_equal(g[0], w[0]) for g, w in zip(got, single_out)):
        raise AssertionError('the resilient damaged burst differs from the '
                             'per-frame resilient decodes')
    if vd.zeroed != zeroed or zeroed[1] == 0:
        raise AssertionError(f'the resilient burst zeroed {vd.zeroed} '
                             f'lanes, frame by frame {zeroed}')
    counts['damaged_resilient'] = (vd.fused_bursts, vd.fallback_bursts)
    vd.close()
    launches = launch_counts(K, E, R)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched on the video path')
        kernels[k]['launches'] += v
    if any(n == 0 for n, _ in counts.values()):
        raise AssertionError(f'a video run fused no burst: {counts}')
    emit('video', frames=VIDEO_FRAMES, burst=BURST, in_flight=2,
         encode_equal_to_per_frame=True, frame0_equal_from_sot=True,
         decode_bit_exact=['raw', 'dense', 'to_device',
                           'to_device_all_in_flight',
                           'to_device_pageable'],
         multipass_bursts_bit_exact=True,
         batch_entry_points_equal=['decode_gpu_batch', 'encode_gpu_batch'],
         damaged_case=flip_label,
         damaged_strict_raised=True, damaged_resilient_equal=True,
         zeroed=list(zeroed), fused_and_fallback_bursts=counts,
         plan_keys=len(set(keys)),
         geometry_keys=len({_geometry_key(k) for k in keys}),
         bursts_with_merged_word_buckets=merged, references_s=ref_s)
    emit('video_path_launches', **launches)
    return streams


def video_timing(streams, gray_ref, dev, card_id: str, reps: int = 5):
    """Wall ms of VIDEO_FRAMES frames, the sequential per-burst path
    against the pipelined one (two bursts in flight), in turns (ABBA over
    the repeats), reps each: decode to the device (decode_frames against
    VideoDecoder(to_device=True)), decode to the host (decode_gpu_batch,
    which returns what collect returns, against VideoDecoder), and encode
    (encode_frames against VideoEncoder)."""
    import torch
    from openjph_tpu_torch import (VideoDecoder, VideoEncoder,
                                   decode_gpu_batch)
    frames = video_frames(gray_ref)
    sbursts, fbursts = bursts_of(streams), bursts_of(frames)
    vd_host = VideoDecoder(device=dev)
    vd_dev = VideoDecoder(device=dev, to_device=True)
    ve = VideoEncoder(device=dev, reversible=True)

    def seq_dev():
        for b in sbursts:
            decode_frames(b, dev)

    def seq_host():
        decode_gpu_batch(streams, device=dev)

    def pipe_dev():
        in_flight(vd_dev, sbursts, vd_dev.collect_on_device)
        vd_dev.drain_errors()
        torch.cuda.synchronize()

    def pipe_host():
        in_flight(vd_host, sbursts, vd_host.collect)

    def seq_enc():
        for b in fbursts:
            encode_frames(b, dev)

    def pipe_enc():
        in_flight(ve, fbursts, ve.collect)

    mp = VIDEO_FRAMES * gray_ref.size / 1e6
    for name, pair in (('decode_to_device', (seq_dev, pipe_dev)),
                       ('decode_to_host', (seq_host, pipe_host)),
                       ('encode', (seq_enc, pipe_enc))):
        for fn in pair:  # warm-up
            fn()
        ms = {'sequential': [], 'pipelined': []}
        for r in range(reps):
            order = pair if r % 2 == 0 else pair[::-1]
            for fn in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                key = 'sequential' if fn is pair[0] else 'pipelined'
                ms[key].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in ms.items()}
        emit('video_timing', path=name, frames=VIDEO_FRAMES, burst=BURST,
             in_flight=2, runs=reps, order='ABBA', wall_ms=ms,
             median_ms=med,
             mp_per_s={k: mp / (v / 1e3) for k, v in med.items()},
             pipelined_over_sequential=med['sequential'] / med['pipelined'],
             card=card_id)
    emit('video_timing_bursts', decode_to_host=[vd_host.fused_bursts,
                                                vd_host.fallback_bursts],
         decode_to_device=[vd_dev.fused_bursts, vd_dev.fallback_bursts],
         encode=[ve.fused_bursts, ve.fallback_bursts])
    for v in (vd_host, vd_dev, ve):
        v.close()


# ---------------------------------------------------------------------------
# The CLI apps, the stream receiver and tracing
# ---------------------------------------------------------------------------

# the stage names the traced runs of the trace phase must give (PERF.md
# section 3 pairs each with the port's code)
STAGES = ('decode.plan', 'decode.host_prep', 'decode.compile',
          'decode.device', 'decode.upload', 'decode.assemble',
          'decode.dispatch', 'decode.fetch', 'encode.plan',
          'encode.compile', 'encode.device', 'encode.upload',
          'encode.segment_pack', 'encode.pack.fetch', 'encode.pack.stuff',
          'encode.pack.fill', 'encode.t2', 'encode.host_prep',
          'encode.dev.upload_exec', 'encode.dev.aux_fetch')
# the kernels' names as the profiler shows them (their 32-bit
# instantiations)
K2_NAME = 'ojk::ht_cleanup_kernel<true, 32>'
K3_NAME = 'oje::ht_cleanup_encode_kernel<32>'
K4_NAME = 'ojr::ht_refine_kernel<true, 32>'
TRACE_DIR = os.path.join(ROOT, 'traces')
STREAM_MTU = 1400


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of fn() over reps runs (fn waits for its
    results)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def quiet_cli(main, argv):
    """main(argv) with its standard output (the 'Elapsed time' line)
    swallowed and its standard error kept; returns the exit code."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def apps_phase(gray, gray_ref, gray3, rgb, dev, kernels, K, E, R, card_id):
    """The port's CLIs on the card, from files: compress of the gray
    frame (.pgm, -reversible true, CLI defaults otherwise) byte-identical
    to gray_2048x1080_rev.j2c from its first SOT on; expand of it to .pgm
    bit-exact with the source; expand of the 3-pass stream equal to
    decode_gpu's; of the RGB 9/7 stream to .ppm equal to decode_gpu's
    clipped to 8 bits; -skip_res 1 (half size) equal to decode_gpu's with
    skip_res=1 clipped; -skip_res 2,1 equal to the port's CPU decode
    with those read / reconstruction values.  Counted; then each CLI run
    timed on the host clock (median of 5)."""
    import shutil
    import tempfile
    import numpy as np
    from openjph_tpu_torch.apps import compress, expand
    from openjph_tpu_torch.gpu.pipeline import GpuDecoder, decode_gpu
    from openjph_tpu_torch.utils import imageio
    tmp = tempfile.mkdtemp(prefix='ojph_apps_')
    try:
        src = os.path.join(tmp, 'gray.pgm')
        imageio.write_pnm(src, gray_ref.astype(np.uint8))
        paths = {'gray': os.path.join(tmp, 'gray.j2c'),
                 'gray3': os.path.join(tmp, 'gray3.j2c'),
                 'rgb': os.path.join(tmp, 'rgb.j2c')}
        for k, data in (('gray3', gray3), ('rgb', rgb)):
            with open(paths[k], 'wb') as f:
                f.write(data)
        # references, not counted
        t0 = time.perf_counter()
        ref3 = decode_gpu(gray3, device=dev)
        ref_rgb = np.stack(decode_gpu(rgb, device=dev), axis=-1)
        ref_skip1 = np.clip(decode_gpu(gray, device=dev, skip_res=1)[0], 0,
                            255).astype(np.uint8)
        ref_skip21 = np.clip(GpuDecoder(
            gray, device='cpu', skipped_res_for_read=2,
            skipped_res_for_recon=1).decode()[0], 0, 255).astype(np.uint8)
        ref_s = time.perf_counter() - t0
        runs = {
            'compress_gray': (compress.main,
                              ['-i', src, '-o', paths['gray'],
                               '-reversible', 'true']),
            'expand_gray_pgm': (expand.main,
                                ['-i', paths['gray'], '-o',
                                 os.path.join(tmp, 'gray_out.pgm')]),
            'expand_3pass_pgm': (expand.main,
                                 ['-i', paths['gray3'], '-o',
                                  os.path.join(tmp, 'gray3.pgm')]),
            'expand_rgb_ppm': (expand.main,
                               ['-i', paths['rgb'], '-o',
                                os.path.join(tmp, 'rgb.ppm')]),
            'expand_skip_1': (expand.main,
                              ['-i', paths['gray'], '-o',
                               os.path.join(tmp, 'skip1.pgm'),
                               '-skip_res', '1']),
            'expand_skip_2_1': (expand.main,
                                ['-i', paths['gray'], '-o',
                                 os.path.join(tmp, 'skip21.pgm'),
                                 '-skip_res', '2,1']),
        }
        K.reset_launches()
        E.reset_launches()
        R.reset_launches()
        for name, (main, argv) in runs.items():
            if quiet_cli(main, argv) != 0:
                raise AssertionError(f'{name} exited non-zero')
            if name == 'compress_gray':
                with open(paths['gray'], 'rb') as f:
                    if from_sot(f.read()) != from_sot(gray):
                        raise AssertionError(
                            'the compress CLI differs from '
                            'gray_2048x1080_rev.j2c from its first SOT on')
        launches = launch_counts(K, E, R)
        read = imageio.read_pnm
        checks = (
            ('expand_gray_pgm', read(runs['expand_gray_pgm'][1][3]),
             gray_ref.astype(np.uint8)),
            ('expand_3pass_pgm', read(runs['expand_3pass_pgm'][1][3]),
             ref3[0].astype(np.uint8)),
            ('expand_rgb_ppm', read(runs['expand_rgb_ppm'][1][3]),
             ref_rgb.astype(np.uint8)),
            ('expand_skip_1', read(runs['expand_skip_1'][1][3]), ref_skip1),
            ('expand_skip_2_1', read(runs['expand_skip_2_1'][1][3]),
             ref_skip21))
        for name, got, want in checks:
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f'{name}: {got.shape} differs from '
                                     f'the reference {want.shape}')
        half = tuple(-(-n // 2) for n in gray_ref.shape)
        if read(runs['expand_skip_1'][1][3]).shape != half:
            raise AssertionError(f'-skip_res 1 is not {half}')
        for k in ('ht_cleanup_decode_raw', 'ht_cleanup_encode',
                  'ht_refine_decode_raw'):
            if launches[k] == 0:
                raise AssertionError(f'{k} was not launched by the CLIs')
        for k, v in launches.items():
            kernels[k]['launches'] += v
        emit('apps', compress_equal_from_sot=True,
             expand_bit_exact=[name for name, _, _ in checks],
             skip_res_1_shape=list(half), references_s=ref_s)
        emit('apps_path_launches', **launches)
        ms = {name: host_ms(lambda m=main, a=argv: quiet_cli(m, a))
              for name, (main, argv) in runs.items()}
        emit('apps_timing', runs=5, median_ms=ms, card=card_id)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rtp_packet(seq, ts, payload, main=False, marked=False, pos=0):
    """One RTP packet of the layout the receiver parses (RFC 3550 header,
    the J2K payload header's packet type, ESEQ and position)."""
    import struct
    from openjph_tpu_torch.apps.stream_expand import RtpPacket
    hdr = bytearray(20)
    hdr[0] = 0x80
    hdr[1] = (0x80 if marked else 0) | 96
    struct.pack_into('>H', hdr, 2, seq & 0xFFFF)
    struct.pack_into('>I', hdr, 4, ts)
    struct.pack_into('>I', hdr, 8, 0x1234)
    hdr[12] = (RtpPacket.PT_MAIN_FOLLOWED_BY_BODY if main
               else RtpPacket.PT_BODY) << 6
    hdr[15] = (seq >> 16) & 0xFF
    if not main:
        hdr[16] = (pos >> 4) & 0xFF
        hdr[17] = (pos & 0xF) << 4
    return bytes(hdr) + payload


def packetize(stream: bytes, ts: int, seq0: int):
    """``stream`` in STREAM_MTU-byte packets: the first a main-header
    packet, the last marked.  Returns (packets, next sequence number)."""
    chunks = [stream[i:i + STREAM_MTU]
              for i in range(0, len(stream), STREAM_MTU)]
    pkts = [rtp_packet(seq0 + i, ts, ch, main=(i == 0),
                       marked=(i == len(chunks) - 1), pos=i)
            for i, ch in enumerate(chunks)]
    return pkts, seq0 + len(chunks)


def loopback(frames_packets, target, resilient=False):
    """serve() on the card, on a loopback port chosen free now, fed
    ``frames_packets`` (per frame its packets), paced so that neither the
    socket buffer nor the reorder window drops a packet; returns its
    (packets, frames) handlers and the wall seconds."""
    import socket
    from openjph_tpu_torch.apps.stream_expand import serve
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    result = {}

    def rx():
        try:
            result['out'] = serve('127.0.0.1', port, num_threads=2,
                                  num_packets=5, recv_buf_size=1 << 24,
                                  quiet=True, target=target,
                                  max_frames=len(frames_packets),
                                  resilient=resilient)
        except Exception as e:  # re-raised below, in the main thread
            result['error'] = e

    t = threading.Thread(target=rx, daemon=True)
    t0 = time.perf_counter()
    t.start()
    time.sleep(0.3)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for pkts in frames_packets:
            for i, p in enumerate(pkts):
                tx.sendto(p, ('127.0.0.1', port))
                if i % 16 == 15:
                    time.sleep(0.001)
            # the previous frame decodes while the socket is quiet
            time.sleep(0.05)
    t.join(timeout=60)
    if t.is_alive():
        raise AssertionError('the stream receiver is still running 60 s '
                             'after the last packet')
    if 'error' in result:
        raise result['error']
    return result['out'] + (time.perf_counter() - t0,)


def stream_phase(streams, gray_ref, dev, kernels, K, R, card_id):
    """The RTP receiver on the card: serve() with two decode workers
    receives 8 distinct frames (the video phase's streams, STREAM_MTU
    packets) on loopback and writes them as .ppm, each bit-exact with its
    source; then one more frame with a body packet dropped, received with
    resilient=True: full-size and equal to the port's resilient decode of
    the bytes the receiver assembled.  Counted."""
    import shutil
    import tempfile
    import numpy as np
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    from openjph_tpu_torch.utils.imageio import read_pnm
    frames = video_frames(gray_ref)[:BURST]
    sent, seq = [], 0
    for k, st in enumerate(streams[:BURST]):
        pkts, seq = packetize(st, 1000 + k, seq)
        sent.append(pkts)
    lossy_pkts, _ = packetize(streams[BURST], 5000, 0)
    drop = len(lossy_pkts) // 2
    lossy = (streams[BURST][:drop * STREAM_MTU]
             + streams[BURST][(drop + 1) * STREAM_MTU:])
    want = decode_gpu(lossy, device=dev, resilient=True)[0]
    tmp = tempfile.mkdtemp(prefix='ojph_stream_')
    try:
        K.reset_launches()
        R.reset_launches()
        packets, fh, wall_s = loopback(sent,
                                       os.path.join(tmp, 'frame_%03d.ppm'))
        stats = fh.get_stats()
        if stats != (BURST, 0, 0) or packets.get_num_lost_packets():
            raise AssertionError(f'the receiver saw (frames, truncated, '
                                 f'lost) = {stats}, '
                                 f'{packets.get_num_lost_packets()} packets '
                                 f'lost')
        for k, f in enumerate(frames):
            got = read_pnm(os.path.join(tmp, 'frame_%03d.ppm' % k))
            if not np.array_equal(got, f.astype(np.uint8)):
                raise AssertionError(f'received frame {k} differs from its '
                                     f'source')
        k2 = K.LAUNCHES['ht_cleanup_decode_raw']
        if k2 < BURST:
            raise AssertionError(f'{k2} K2 launches for {BURST} frames')
        packets, fh, lossy_s = loopback(
            [lossy_pkts[:drop] + lossy_pkts[drop + 1:]],
            os.path.join(tmp, 'lossy_%03d.ppm'), resilient=True)
        got = read_pnm(os.path.join(tmp, 'lossy_000.ppm'))
        if got.shape != gray_ref.shape or not np.array_equal(
                got, want.astype(np.uint8)):
            raise AssertionError('the frame with a dropped packet differs '
                                 'from the resilient decode')
        launches = launch_counts(K, R)
        for k, v in launches.items():
            kernels[k]['launches'] += v
        emit('stream', frames=BURST, mtu=STREAM_MTU, decode_workers=2,
             packets=sum(len(p) for p in sent), bit_exact=True,
             wall_s=wall_s, lossy_frame_full_size=True,
             lossy_equal_to_resilient_decode=True, lossy_dropped_packet=drop,
             lossy_packets_lost=packets.get_num_lost_packets(),
             lossy_wall_s=lossy_s, card=card_id)
        emit('stream_path_launches', **launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that fills with the interpreter's garbage-collection
    pauses inside the block, as (generation, ms)."""
    import gc
    pauses, t0 = [], [0.0]

    def cb(phase, info):
        if phase == 'start':
            t0[0] = time.perf_counter()
        else:
            pauses.append((info['generation'],
                           (time.perf_counter() - t0[0]) * 1e3))

    gc.callbacks.append(cb)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(cb)


def device_windows(events):
    """(window start, end) of the profiled region (its 'window' range)
    and the merged busy intervals of the card's kernels, copies and sets
    inside it, in trace microseconds."""
    win = [e for e in events if e.get('name') == 'window'
           and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    if len(win) != 1:
        raise AssertionError(f'{len(win)} window ranges in the trace')
    w0 = float(win[0]['ts'])
    w1 = w0 + float(win[0]['dur'])
    dev = sorted((max(float(e['ts']), w0),
                  min(float(e['ts']) + float(e['dur']), w1), e['name'])
                 for e in events
                 if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
                 and e.get('ph') == 'X')
    busy = []
    for a, b, _ in dev:
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return w0, w1, dev, busy


def window_report(path: str):
    """The busy share of the card over the profiled window of the Chrome
    trace ``path``, the 8 device ops of most total time, and the 3
    longest idle gaps with the innermost host range (op or stage) open at
    each gap's start on each host thread, and the stages that overlap the
    gap most (ms of overlap, summed over threads; nested stages count
    each)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    w0, w1, dev, busy = device_windows(events)
    if not dev:
        raise AssertionError(f'{path}: the profiler recorded no device '
                             f'event: the busy share is not measured')
    span = w1 - w0
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for a, b, name in dev:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += b - a
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    gaps, at = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            gaps.append((a - at, at))
        at = max(at, b)
    stages = [e for e in events if e.get('ph') == 'X'
              and e.get('cat') == 'user_annotation'
              and e.get('name') != 'window']

    def during(t, g):
        ov = {}
        for e in stages:
            a = max(t, float(e['ts']))
            b = min(t + g, float(e['ts']) + float(e['dur']))
            if b > a:
                ov[e['name']] = ov.get(e['name'], 0.0) + (b - a) / 1e3
        return dict(sorted(ov.items(), key=lambda kv: -kv[1])[:4])
    host = [e for e in events if e.get('ph') == 'X'
            and e.get('cat') in ('cpu_op', 'user_annotation')
            and e.get('name') != 'window']

    def open_at(t):
        inner = {}
        for e in host:
            if float(e['ts']) <= t < float(e['ts']) + float(e['dur']):
                cur = inner.get(e['tid'])
                if cur is None or float(e['dur']) < float(cur['dur']):
                    inner[e['tid']] = e
        return sorted(e['name'][:120] for e in inner.values())

    return {'wall_trace_ms': span / 1e3, 'device_busy_ms': busy_us / 1e3,
            'busy_share': busy_us / span, 'idle_share': 1 - busy_us / span,
            'device_events': len(dev),
            'top_device_ops': [{'name': n[:120], 'ms': v[0] / 1e3,
                                'calls': v[1]} for n, v in top],
            'idle_gaps': [{'ms': g / 1e3, 'at_ms': (t - w0) / 1e3,
                           'open_host_ranges': open_at(t),
                           'stages_ms': during(t, g)}
                          for g, t in sorted(gaps, reverse=True)[:3]],
            'names': set(by_name)}


def trace_phase(gray, gray_ref, gray3, streams, dev, kernels, K, E, R,
                card_id):
    """Tracing on the card: the stage timers over one-frame decode and
    encode, an 8-frame decode_gpu_batch and 16 frames through the video
    coders, every name of STAGES present; their cost (one-frame decode
    and encode with tracing disabled and enabled, ABBA, 20 runs each);
    and torch.profiler windows on the warm paths, each ending in a
    synchronise, with the card's busy share, its top ops, its longest
    idle gaps and the interpreter's garbage-collection pauses (per
    generation: count, total ms, longest ms).  Counted."""
    import gzip
    import shutil
    import torch
    from openjph_tpu_torch import (VideoDecoder, VideoEncoder, decode_gpu,
                                   decode_gpu_batch, encode_gpu,
                                   encode_gpu_batch, trace)
    frames = video_frames(gray_ref)
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    # 1. the stage timers
    trace.reset()
    trace.enable()
    try:
        decode_gpu(gray, device=dev)
        encode_gpu(gray_ref, device=dev, reversible=True)
        decode_gpu_batch([gray] * BURST, device=dev)
        vd = VideoDecoder(device=dev)
        in_flight(vd, bursts_of(streams[:2 * BURST]), vd.collect)
        vd.close()
        ve = VideoEncoder(device=dev, reversible=True)
        in_flight(ve, bursts_of(frames[:2 * BURST]), ve.collect)
        ve.close()
    finally:
        trace.disable()
    stats = trace.get_stats()
    missing = [s for s in STAGES if stats.get(s, {}).get('calls', 0) < 1]
    if missing:
        raise AssertionError(f'stages not timed: {missing}')
    print(trace.report(), flush=True)
    emit('trace_stages', stages=stats, card=card_id)

    # 2. the stage timers' cost, in turns
    runs = {('decode', False): [], ('decode', True): [],
            ('encode', False): [], ('encode', True): []}
    work = {'decode': lambda: decode_gpu(gray, device=dev),
            'encode': lambda: encode_gpu(gray_ref, device=dev,
                                         reversible=True)}
    for r in range(20):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            for path, fn in work.items():
                (trace.enable if on else trace.disable)()
                t0 = time.perf_counter()
                fn()
                runs[(path, on)].append((time.perf_counter() - t0) * 1e3)
    trace.disable()
    trace.reset()
    for path in work:
        off = statistics.median(runs[(path, False)])
        on = statistics.median(runs[(path, True)])
        emit('trace_overhead', path=path, runs=20, order='ABBA',
             median_ms_disabled=off, median_ms_enabled=on,
             enabled_over_disabled=on / off, card=card_id)

    # 3. profiler windows on the warm paths; the video coders are made
    # before them (encode_gpu_batch makes one, and its worker threads,
    # each call: that call is timed outside the profiler)
    emit('encode_gpu_batch_timing', frames=BURST, runs=5,
         median_ms=host_ms(lambda: encode_gpu_batch(
             frames[:BURST], device=dev, reversible=True)), card=card_id)
    vd = VideoDecoder(device=dev, to_device=True)
    ve = VideoEncoder(device=dev, reversible=True)

    def vdec():
        in_flight(vd, bursts_of(streams), vd.collect_on_device)
        vd.drain_errors()

    def venc():
        for _ in range(3):
            ve.submit(frames[:BURST])
            ve.collect()

    windows = (
        ('decode_1x10', lambda: [decode_gpu(gray, device=dev)
                                 for _ in range(10)], K2_NAME),
        ('decode_burst8x3', lambda: [decode_gpu_batch([gray] * BURST,
                                                      device=dev)
                                     for _ in range(3)], K2_NAME),
        ('encode_1x10', lambda: [encode_gpu(gray_ref, device=dev,
                                            reversible=True)
                                 for _ in range(10)], K3_NAME),
        ('encode_burst8x3', venc, K3_NAME),
        ('video_decoder_to_device_32', vdec, K2_NAME),
        ('decode_3pass_1x10', lambda: [decode_gpu(gray3, device=dev)
                                       for _ in range(10)], K4_NAME))
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    trace.enable()  # the stages show as host ranges in the traces
    try:
        for name, fn, kernel in windows:
            fn()  # warm
            trace.reset()
            with trace.torch_trace(TRACE_DIR, device=dev, name=name), \
                    gc_pauses() as gcs:
                t0 = time.perf_counter()
                with torch.profiler.record_function('window'):
                    fn()
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            path = os.path.join(TRACE_DIR, name + '.json')
            rep = window_report(path)
            with open(path, 'rb') as f, gzip.open(path + '.gz', 'wb') as g:
                shutil.copyfileobj(f, g)
            os.remove(path)
            names = rep.pop('names')
            if not any(kernel in n for n in names):
                raise AssertionError(f'{name}: {kernel} is not among the '
                                     f'device events')
            emit('trace_window', window=name, wall_ms=wall_ms,
                 kernel_seen=kernel, trace=os.path.relpath(path, ROOT)
                 + '.gz', card=card_id,
                 gc_pauses={g: [sum(1 for h, _ in gcs if h == g),
                                sum(ms for h, ms in gcs if h == g),
                                max([ms for h, ms in gcs if h == g],
                                    default=0.0)] for g in (0, 1, 2)},
                 **rep)
    finally:
        trace.disable()
        trace.reset()
        vd.close()
        ve.close()
    launches = launch_counts(K, E, R)
    for k in ('ht_cleanup_decode_raw', 'ht_cleanup_encode',
              'ht_refine_decode_raw'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the trace phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('trace_path_launches', **launches)


MOSAIC_97_FUSED = 'mosaic_gray_128x128_97_t64_fused.npz'
# the mosaic_scale phase: 1024x1024 tiles, gray 8-bit, lossless 5/3, 2
# levels, sub-batches of 32 tiles (BASELINE.json config 5, cut to 8K, 32K
# and, with --mosaic-100k, 100K)
MOSAIC_TILE = 1024
MOSAIC_BATCH = 32
MOSAIC_SIZES = (8192, 32768)  # the in-memory and the streamed run
MOSAIC_100K = 100000
MOSAIC_CHECKED = 64  # seeded tiles checked of the 32K and 100K mosaics


def cleanup_blocks(dev):
    """The full-size 64x64 codeblocks of a seeded 256x256 5/3 stream (the
    port's card encode, parsed by the port's Tier-2), each with the C++
    scalar decoder's output."""
    import numpy as np
    from openjph_tpu_torch import native
    from openjph_tpu_torch.entry import _full_blocks
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    img = np.random.RandomState(1234).randint(0, 256, (256, 256)) \
        .astype(np.int32)
    stream = encode_gpu(img, device=dev, reversible=True, num_decomps=2)
    return [(d, mm, lc, native.decode_codeblock(d, mm, 1, lc, 0, 64, 64))
            for d, mm, lc in _full_blocks(stream)]


def mosaic_phase(dev, kernels, K, E, R, R5, card_id):
    """The committed mosaic fixtures through MosaicDecoder (K2, and K1 in
    the dense runner mode; K4 on the 3-pass one) against their sources,
    the CPU decode and the JAX package's fused 9/7 decode, re-encoded
    through MosaicEncoder (K3, and K5 on the 3-pass one) byte-equal to
    the JAX package's streams; decode_blocks_sharded (K1) on the 64x64
    blocks of a 256x256 stream against the C++ scalar decoder.
    Counted."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    from openjph_tpu_torch.native import prep_cleanup_streams
    from openjph_tpu_torch.parallel import (MosaicDecoder, MosaicEncoder,
                                            decode_blocks_sharded, make_mesh)
    from openjph_tpu_torch.parallel._testing import (
        MOSAIC_FIXTURES, mosaic_fixture_sources)
    t_phase = time.perf_counter()
    # the committed fixtures' sources, made from the seeds that made them
    sources = mosaic_fixture_sources()
    streams = {n: open(os.path.join(TESTDATA, n + '.j2c'), 'rb').read()
               for n in MOSAIC_FIXTURES}
    with np.load(os.path.join(TESTDATA, MOSAIC_97_FUSED)) as z:
        fused97 = z['plane']
    p3_name = 'mosaic_gray_128x128_rev_p3_t64'
    p3_cpu = decode_gpu(streams[p3_name], device='cpu', raw=False)
    blocks = cleanup_blocks(dev)
    mesh = make_mesh()
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    R5.reset_launches()
    for name in MOSAIC_FIXTURES:
        planes, kw = sources[name]
        for raw in (True, False):
            md = MosaicDecoder(streams[name], mesh, raw=raw)
            got = md.decode()
            if name == 'mosaic_gray_128x128_97_t64':
                diff = int(np.abs(got[0].astype(np.int64) - fused97).max())
                if diff > 1:
                    raise AssertionError(f'{name} differs from the JAX '
                                         f'fused decode by {diff}')
                held = dict(max_abs_diff_vs_jax_fused=diff, tolerance=1)
            else:
                want = ([np.clip(p, 0, 255) for p in planes]
                        if name == p3_name else planes)
                if len(got) != len(want) or not all(
                        np.array_equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f'{name} differs from its source '
                                         f'(raw={raw})')
                if name == p3_name and not np.array_equal(got[0],
                                                          p3_cpu[0]):
                    raise AssertionError(f'{name} differs from the CPU '
                                         f'decode (raw={raw})')
                held = dict(equal_to_source=True)
            emit('mosaic_decode', stream=name, raw=raw,
                 classes=[len(c['tiles']) for c in md.classes],
                 refine=any(c['top'].has_refine for c in md.classes),
                 **held)
        me = MosaicEncoder(mesh, **kw)
        if me.encode(planes) != streams[name]:
            raise AssertionError(f'{name}: MosaicEncoder differs from the '
                                 f'JAX package\'s stream')
        emit('mosaic_encode', stream=name, bytes=len(streams[name]),
             equal_to_jax_stream=True)
    # decode_blocks_sharded: the cleanup decoder's dense readers (K1)
    datas = [b[0] for b in blocks]
    lcups = np.array([b[2] for b in blocks], np.int64)
    miss = np.array([b[1] for b in blocks], np.int32)
    scups = np.array([(d[lc - 1] << 4) + (d[lc - 2] & 0xF)
                      for d, lc in zip(datas, lcups)], np.int64)
    dec, err = decode_blocks_sharded(
        mesh, prep_cleanup_streams(datas, lcups, scups), 30 - miss, 64, 64)
    dec = dec.cpu().numpy().view(np.uint32)
    if bool(err.any()) or not all(np.array_equal(dec[i], b[3])
                                  for i, b in enumerate(blocks)):
        raise AssertionError('decode_blocks_sharded differs from the C++ '
                             'scalar decoder')
    emit('decode_blocks_sharded', blocks=len(blocks), mesh=mesh.size,
         equal_to_scalar_decoder=True)
    torch.cuda.synchronize()
    launches = launch_counts(K, R, E, R5)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched in the mosaic phase')
        kernels[k]['launches'] += v
    emit('mosaic_path_launches', **launches)
    emit('mosaic_phase_s', seconds=time.perf_counter() - t_phase,
         card=card_id)


def host_rss_mb():
    """(RssAnon, VmRSS) of this process in MB; RssAnon None where the
    kernel does not report it."""
    anon, total = None, 0.0
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith('VmRSS:'):
                total = int(line.split()[1]) / 1024.0
            elif line.startswith('RssAnon:'):
                anon = int(line.split()[1]) / 1024.0
    return anon, total


def mapped_rss_mb(path):
    """Resident MB of this process's mappings of the file ``path``
    (/proc/self/smaps), 0 when it has none; None where smaps is not
    readable."""
    try:
        total, inside = 0.0, False
        with open('/proc/self/smaps') as f:
            for line in f:
                head = line.split(None, 1)[0]
                if '-' in head and not head.endswith(':'):
                    inside = line.rstrip().endswith(path)
                elif inside and head == 'Rss:':
                    total += int(line.split()[1]) / 1024.0
        return total
    except OSError:
        return None


@contextlib.contextmanager
def rss_peak(path=None):
    """Samples (RssAnon, VmRSS) every 0.2 s while open, and VmRSS less
    the resident pages of the mapped file ``path``; yields a dict that
    holds, on exit, the peak deltas over the values at entry (MB), and
    whose ``mark(name)`` records VmRSS less those pages at that moment
    under ``marks``."""
    anon0, tot0 = host_rss_mb()
    peak = [anon0, tot0, 0.0]
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            a, t = host_rss_mb()
            if a is not None:
                peak[0] = max(peak[0], a)
            peak[1] = max(peak[1], t)
            m = mapped_rss_mb(path) if path else 0.0
            peak[2] = None if m is None or peak[2] is None else max(
                peak[2], t - tot0 - m)
            stop.wait(0.2)

    def mark(name):
        """VmRSS less the stream's pages now, over the value at entry."""
        t = host_rss_mb()[1]
        m = mapped_rss_mb(path) if path else 0.0
        out['marks'][name] = None if m is None else t - tot0 - m

    th = threading.Thread(target=sampler, daemon=True)
    th.start()
    out = {'marks': {}, 'mark': mark}
    try:
        yield out
    finally:
        stop.set()
        th.join(timeout=2)
        a, t = host_rss_mb()
        out['anon_delta_mb'] = (None if a is None
                                else max(peak[0], a) - anon0)
        out['rss_delta_mb'] = max(peak[1], t) - tot0
        out['rss_less_stream_delta_mb'] = peak[2]


def trim_host_heap() -> bool:
    """Collect garbage and hand the C allocator's free memory back to the
    system (glibc ``malloc_trim``); False where there is no such call."""
    gc.collect()
    try:
        ctypes.CDLL('libc.so.6').malloc_trim(0)
    except (OSError, AttributeError):
        return False
    return True


def tile_content(y0, x0, h, w):
    """The 8K mosaic's per-tile pixels (tests/test_mosaic_scale.py:29-35),
    made on demand."""
    import numpy as np
    yy = np.arange(y0, y0 + h, dtype=np.int64)[:, None]
    xx = np.arange(x0, x0 + w, dtype=np.int64)[None, :]
    return ((yy * 31 + xx * 17 + ((yy * xx) >> 6)) % 256).astype(np.int32)


def smooth_tile(y0, x0, h, w):
    """The 32K and 100K mosaics' low-entropy pixels
    (tests/test_mosaic_scale.py:160-169)."""
    import numpy as np
    yy = np.arange(y0, y0 + h, dtype=np.int64)[:, None]
    xx = np.arange(x0, x0 + w, dtype=np.int64)[None, :]
    return (((yy * 5 + xx * 3) >> 6) % 256).astype(np.int32)


def mosaic_run(n_img, content, dev, check, path=None):
    """One mosaic of n_img x n_img, MOSAIC_TILE tiles, through
    encode_chunked (to bytes, or streamed to the file ``path``) and
    MosaicDecoder.decode_to (from the bytes, or an mmap of the file), the
    tiles in ``check`` (None: all) held equal to ``content``.  Peak host
    RSS and device memory are reset before and read after: the host heap
    is trimmed first, and the device peak is counted over what was
    allocated at the reset.  Returns (the
    stream bytes or None, figures)."""
    import mmap
    import torch
    from openjph_tpu_torch import trace
    from openjph_tpu_torch.parallel import MosaicDecoder, MosaicEncoder
    fig = {'image': f'{n_img}x{n_img}', 'tile': MOSAIC_TILE,
           'batch_tiles': MOSAIC_BATCH}

    read_s = [0.0]
    ntiles = (-(-n_img // MOSAIC_TILE)) ** 2
    # VmRSS less the stream's pages at each eighth of the tiles, each
    # way, and after the decode: where the host memory goes
    eighth = max(ntiles // 8, 1)
    done = [0, 0]

    def reader(ti, geom):
        t0 = time.perf_counter()
        r = geom.comps[0].rect
        tile = [content(r.y0, r.x0, r.h, r.w)]
        read_s[0] += time.perf_counter() - t0
        done[0] += 1
        if done[0] % eighth == 0:
            rss['mark'](f'encode_{done[0]}')
        return tile

    torch.cuda.synchronize()
    # what the allocator kept of earlier phases' freed memory goes back
    # first, so that each run's RSS delta starts from the same state
    trim_host_heap()
    torch.cuda.reset_peak_memory_stats(dev)
    # what earlier phases left allocated (cached runners, tensors): the
    # peak counts it too, so the mosaic's own peak is the excess over it
    base_device = torch.cuda.memory_allocated(dev)
    trace.reset()
    trace.enable()  # the mosaic.* stages; ~1% of a frame (PERF.md)
    with rss_peak(path) as rss:
        me = MosaicEncoder(batch_tiles=MOSAIC_BATCH, reversible=True,
                           num_decomps=2,
                           tile_size=(MOSAIC_TILE, MOSAIC_TILE))
        t0 = time.perf_counter()
        if path is None:
            stream = me.encode_chunked(reader, (n_img, n_img), num_comps=1)
            size = len(stream)
        else:
            stream = None
            with open(path, 'wb') as f:
                me.encode_chunked(reader, (n_img, n_img), num_comps=1, out=f)
            size = os.path.getsize(path)
        fig['encode_s'] = time.perf_counter() - t0
        rss['mark']('encoded')
        fig['tile_reader_s'] = read_s[0]  # the source, in encode_s
        fh = mm = None
        if path is not None:
            fh = open(path, 'rb')
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            t0 = time.perf_counter()
            md = MosaicDecoder(stream if mm is None else mm,
                               batch_tiles=MOSAIC_BATCH)
            # every tile's Tier-2 and plan, for its class
            fig['decoder_init_s'] = time.perf_counter() - t0
            rss['mark']('decoder_built')
            seen = [0, 0]

            def sink(ti, planes):
                seen[0] += 1
                if seen[0] % eighth == 0:
                    rss['mark'](f'decode_{seen[0]}')
                if check is None or ti in check:
                    r = md.dec.tile_rects[ti]
                    if not (planes[0] == content(r.y0, r.x0, r.h,
                                                 r.w)).all():
                        raise AssertionError(f'{fig["image"]} tile {ti} '
                                             f'differs from its source')
                    seen[1] += 1

            md.decode_to(sink)
            torch.cuda.synchronize()
            fig['decode_s'] = time.perf_counter() - t0
            fig['classes'] = [len(c['tiles']) for c in md.classes]
            del md
            # what the allocator keeps of freed memory
            gc.collect()
            rss['mark']('after_gc')
            if trim_host_heap():
                rss['mark']('after_malloc_trim')
        finally:
            trace.disable()
            if mm is not None:
                mm.close()
                fh.close()
    fig['stages_s'] = {k: v['seconds'] for k, v in trace.get_stats().items()}
    trace.reset()
    if seen[0] != ntiles:
        raise AssertionError(f'{fig["image"]}: {seen[0]} of {ntiles} tiles '
                             f'reached the sink')
    fig.update(tiles=ntiles, tiles_checked=seen[1], stream_bytes=size,
               stream_on_disk=path is not None,
               encode_tiles_per_s=ntiles / fig['encode_s'],
               decode_tiles_per_s=ntiles / fig['decode_s'],
               encode_mp_per_s=n_img * n_img / 1e6 / fig['encode_s'],
               decode_mp_per_s=n_img * n_img / 1e6 / fig['decode_s'],
               device_allocated_before_mb=base_device / 2**20,
               peak_device_mb=(torch.cuda.max_memory_allocated(dev)
                               - base_device) / 2**20,
               peak_host_rss_delta_mb=rss['rss_delta_mb'],
               peak_host_anon_delta_mb=rss['anon_delta_mb'],
               peak_host_rss_less_stream_delta_mb=rss[
                   'rss_less_stream_delta_mb'],
               host_rss_less_stream_marks_mb=rss['marks'])
    return stream, fig


def mosaic_scale_phase(dev, kernels, K, E, R, card_id, with_100k=False):
    """BASELINE config 5 on the card: an 8192x8192 mosaic (64 tiles)
    through encode_chunked and decode_to, every tile lossless and the
    stream byte-equal to encode_gpu of the whole image; a 32768x32768
    one (1,024 tiles, one gigapixel) streamed to a file and decoded from
    an mmap of it, the first, the last and MOSAIC_CHECKED seeded tiles
    lossless, the peak host RSS delta under 2 GB and the peak device
    memory over what was allocated before within 1.25x the 8K run's; with
    ``with_100k``, a 100000x100000 one (9,604 tiles) the same way, its
    peak host RSS less the stream's pages within 1.35x the 32K run's.
    Counted."""
    import shutil
    import tempfile
    import numpy as np
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    t_phase = time.perf_counter()
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    n8, n32 = MOSAIC_SIZES
    stream8, fig8 = mosaic_run(n8, tile_content, dev, None)
    emit('mosaic_scale', card=card_id, **fig8)
    launches = launch_counts(K, E)
    # the whole image through encode_gpu, outside the measured window and
    # the counts
    t0 = time.perf_counter()
    whole = np.empty((n8, n8), np.uint8)
    for y in range(0, n8, MOSAIC_TILE):
        whole[y:y + MOSAIC_TILE] = tile_content(y, 0, MOSAIC_TILE, n8)
    ref = encode_gpu(whole, device=dev, reversible=True, num_decomps=2,
                     tile_size=(MOSAIC_TILE, MOSAIC_TILE))
    if ref != stream8:
        raise AssertionError('the 8K mosaic stream differs from encode_gpu '
                             'of the whole image')
    emit('mosaic_8k_vs_encode_gpu', equal=True, bytes=len(ref),
         encode_gpu_s=time.perf_counter() - t0)
    del whole, ref, stream8
    K.reset_launches()
    E.reset_launches()
    tmp = tempfile.mkdtemp(prefix='ojph_mosaic_')
    try:
        for n_img in (n32, MOSAIC_100K) if with_100k else (n32,):
            ntiles = (-(-n_img // MOSAIC_TILE)) ** 2
            rng = np.random.RandomState(9)
            check = set(rng.choice(ntiles, MOSAIC_CHECKED,
                                   replace=False).tolist()) | {0, ntiles - 1}
            before = launch_counts(K, E)
            _, fig = mosaic_run(n_img, smooth_tile, dev, check,
                                path=os.path.join(tmp, f'm{n_img}.j2c'))
            fig['device_over_8k'] = fig['peak_device_mb'] / \
                fig8['peak_device_mb']
            for k, v in launch_counts(K, E).items():
                fig.setdefault('launches', {})[k] = v - before[k]
            less_stream = fig['peak_host_rss_less_stream_delta_mb']
            if n_img != n32 and less_stream is not None:
                # the flat-memory property: 9.4x the tiles of the 32K
                # run, within the JAX package's 1.35x (without its slack)
                fig['host_rss_less_stream_over_32k'] = \
                    less_stream / less_stream32
            emit('mosaic_scale', card=card_id, **fig)
            if fig.get('host_rss_less_stream_over_32k', 0) > 1.35:
                raise AssertionError(
                    f'{fig["image"]}: peak host RSS less the stream '
                    f'{less_stream} MB, '
                    f'{fig["host_rss_less_stream_over_32k"]}x the 32K '
                    f'run\'s')
            less_stream32 = less_stream
            # the mmap'd stream's pages count in VmRSS: the 2 GB hold is
            # the 1 GP run's (a 1.3 GB stream alone would break it at 100K)
            if n_img == n32 and fig['peak_host_rss_delta_mb'] >= 2048:
                raise AssertionError(f'{fig["image"]}: peak host RSS delta '
                                     f'{fig["peak_host_rss_delta_mb"]} MB')
            if fig['device_over_8k'] > 1.25:
                raise AssertionError(f'{fig["image"]}: peak device memory '
                                     f'{fig["device_over_8k"]}x the 8K '
                                     f'run\'s')
            os.remove(os.path.join(tmp, f'm{n_img}.j2c'))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: v + launches[k] for k, v in launch_counts(K, E).items()}
    for k in ('ht_cleanup_decode_raw', 'ht_cleanup_encode'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the mosaic_scale '
                                 f'phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('mosaic_scale_path_launches', **launches)
    emit('mosaic_scale_phase_s', seconds=time.perf_counter() - t_phase,
         card=card_id)


def run_ranks(module: str, n: int, args, timeout: int = 300):
    """n processes of ``python -m module`` as gloo ranks sharing cuda:0 on
    a free localhost port; returns their outputs.  Every process is
    waited for, and killed at the time limit."""
    from openjph_tpu_torch.parallel._testing import start_ranks, wait_ranks
    return wait_ranks(start_ranks(module, n, ['--backend', 'gloo', *args],
                                  device='cuda'), timeout=timeout)


def rank_result(out: str, tag: str) -> dict:
    line = next((ln for ln in out.splitlines() if ln.startswith(tag)), None)
    if line is None:
        raise AssertionError(f'no "{tag}" line in:\n{out[-4000:]}')
    return json.loads(line[len(tag):])


def parallel_phase(card_id):
    """The row-sharded DWT in two processes sharing cuda:0 over gloo (halo
    rows staged through host memory): 5/3 and 9/7, one analysis and one
    synthesis level of a seeded 2048x1080 plane split in rows, each
    process's rows equal to the unsharded gpu/dwt.py on the card.  It
    checks the exchange; it does not time it."""
    t0 = time.perf_counter()
    outs = run_ranks('openjph_tpu_torch.parallel.dwt_sharded', 2,
                     ['--size', '2048x1080', '--seed', '3'])
    res = [rank_result(o, 'dwt_sharded OK ') for o in outs]
    emit('parallel_dwt', processes=2, backend='gloo', ranks=res,
         wall_s=time.perf_counter() - t0, card=card_id)


def multihost_phase(kernels, card_id):
    """decode_frames / encode_frames in two processes sharing cuda:0 over
    gloo: the 8 video frames of the headline stream (the gray frame
    rolled 37*k columns) encoded and decoded spread across them, each
    gathered burst byte-identical to encode_gpu_batch and bit-exact with
    decode_gpu_batch of one process, and equal to the frames.  Counted:
    each process reports the launches of its spread coding."""
    t0 = time.perf_counter()
    outs = run_ranks('openjph_tpu_torch.parallel.multihost', 2,
                     ['--frames', str(BURST), '--npy', GRAY_NPY])
    res = [rank_result(o, 'multihost OK ') for o in outs]
    launches = {}
    for r in res:
        for k, v in r['launches'].items():
            if not k.endswith('64'):  # 8-bit frames: no 64-bit launch
                launches[k] = launches.get(k, 0) + v
    for k in ('ht_cleanup_decode_raw', 'ht_cleanup_encode'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the multihost '
                                 f'phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('multihost', processes=2, backend='gloo', frames=BURST,
         equal_to_single_process=True, ranks=res,
         wall_s=time.perf_counter() - t0, card=card_id)
    emit('multihost_path_launches', **launches)


# ---- codeblocks of more than 30 bit planes (ROADMAP 7c) ----

WIDE = (1080, 2048)       # the headline geometry, at 32 and 29 bits
WIDE_RGB = (540, 1024)    # the 32-bit RGB frame through the RCT
WIDE_FIXTURES = ('wide_gray_s32_l2', 'wide_rgb_u32_rct_l5',
                 'wide_gray_u29_l5')
WIDE_P3 = 'wide_gray_u32_p3'
WIDE_CODEBLOCKS = os.path.join(TESTDATA, 'wide_multipass_codeblocks.npz')
# the 64-bit decode tables: dec_vlc0|1, dec_uvlc0|1, dec_uvlc0_bias
WIDE_TABLE_WORDS = 2944
# the C++ lines the 64-bit instantiations stand for: no TPU kernel is
# behind them, the JAX package codes such codeblocks on its host
WIDE_REPLACES = {
    'ht_cleanup_decode_raw64': 'openjph_tpu/coding/decoder.py:197',
    'ht_cleanup_decode_dense64': 'openjph_tpu/coding/decoder.py:197',
    'ht_refine_decode_raw64': 'openjph_tpu/coding/decoder.py:426',
    'ht_refine_decode_dense64': 'openjph_tpu/coding/decoder.py:426',
    'ht_cleanup_encode64': 'openjph_tpu/coding/encoder.py:176',
}


def wide_frame(seed: int, shape, bd: int):
    """A ``bd``-bit frame: smooth full-range content plus seeded noise in
    the low 12 bits, and a flat band of 3x3 checker patches of 0 and the
    top value, whose lone high-band coefficients pass 2**32 where the
    64-bit coders extend u_q past 32."""
    import numpy as np
    h, w = shape
    rng = np.random.RandomState(seed)
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    s = (np.sin(x / 97.0) + np.cos(y / 61.0) + 2.0) / 4.0 \
        * float((1 << bd) - 1 - 4096)
    img = s.astype(np.int64) + rng.randint(0, 4096, shape)
    y0, band = h // 2, min(64, h // 2)
    img[y0:y0 + band] = 1 << (bd - 1)
    patch = np.where(np.indices((3, 3)).sum(0) % 2 == 0, 0, (1 << bd) - 1)
    for yy in range(y0 + 2, y0 + band - 2, 9):
        for xx in range(3, w - 8, 13):
            img[yy:yy + 3, xx:xx + 3] = patch
    return img


def wide_row(name: str, source: str, ms, plain_ms, nbytes, ops) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {'name': name, 'route': 'cuda',
            'source': f'openjph_tpu_torch/gpu/csrc/{source}.cu',
            'replaces': WIDE_REPLACES[name], 'launches': 0,
            'max_abs_err': 0, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None, 'bit_exact': True}


def wide_decode_rows(data: bytes, dev, name: str, card_id: str) -> dict:
    """K1-64 and K2-64 against their plain versions on every lane of one
    frame, K2-64 against the C++ scalar decoder lane by lane, each timed;
    the quads whose u_q takes the 64-bit extension counted.  Returns the
    kernels-line rows."""
    import numpy as np
    import torch
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import block_decode as plain
    plan, rviews, dviews = frame_views(data, dev)
    if not all(g.bits == 64 for g in plan.groups):
        raise AssertionError(f'{name}: a lane group is not 64-bit')
    buf = np.frombuffer(data, np.uint8)
    starts, s0 = {}, 0
    for g in plan.groups:
        starts[g.gid] = s0
        s0 += g.n_pad
    rows = {}
    for kname, kern, ref, raw in kernel_modes():
        kname += '64'
        views = rviews if raw else dviews
        plain_ms, outs = hold(kname, kern, ref, views, True)
        ms = sum(cuda_ms(lambda: kern(*a), 20) for _, a, _ in views)
        coded = out_bytes = samples = live = 0
        for (g, args, c), (d, _) in zip(views, outs):
            qhl = c[7].to(torch.int64)
            n = g.n_pad
            samples += int((2 * qhl).clamp(max=g.h).sum()) * g.w
            if raw:
                coded += int((c[1] + c[2]).sum()) + n * 5 * 4
            else:
                coded += 4 * int((c[1] + c[3] + c[5]).sum()) + n * 8 * 4
            out_bytes += n * g.h * g.w * 8 + n
            if not raw:
                continue
            got = d.cpu().numpy().view(np.uint64)
            for i in range(len(g.members)):
                pos, lcup, _, p, _, _, _, h, _ = \
                    (int(x[starts[g.gid] + i]) for x in plan.lanes)
                if pos < 0:
                    continue
                want = native.decode_codeblock(buf[pos:pos + lcup], 62 - p,
                                               1, lcup, 0, g.w, h)
                if not np.array_equal(got[i, :h], want):
                    raise AssertionError(f'{kname}: lane {i} of group '
                                         f'{g.w}x{g.h} of {name} differs '
                                         f'from the scalar decoder')
                live += 1
        nbytes = coded + out_bytes + WIDE_TABLE_WORDS * 4
        rows[kname] = wide_row(kname, 'ht_cleanup_decode', ms, plain_ms,
                               nbytes, samples * OPS_PER_SAMPLE)
        emit('wide_kernel_vs_plain', frame=name, kernel=kname,
             lanes=sum(g.n_pad for g in plan.groups), bit_exact=True,
             scalar_decoder_equal_lanes=live if raw else None,
             kernel_ms=ms, plain_ms=plain_ms, bytes_moved=nbytes,
             samples=samples, bound_ms=rows[kname]['bound_ms'],
             card=card_id)
    ext = 0
    for g, a, _ in dviews:
        _, u = plain._step1(a[0], a[1], (g.w + 1) // 2, (g.h + 1) // 2,
                            wide=True)
        # a non-initial quad row's u_q past 32 took four more bits
        ext += int((u[:, 1:] >= 33).sum())
    if ext == 0:
        raise AssertionError(f'{name}: no quad extends u_q')
    emit('wide_uq_extension', frame=name, quads=ext)
    return rows


def wide_encode_row(planes, dev, name: str, card_id: str, **kwargs):
    """K3-64 against its plain version on every lane of one frame's group
    batches (bit counts, flags, every word), each lane's stuffed segment
    against the C++ scalar encoder's (bits=64), timed.  Returns its
    kernels-line row."""
    import numpy as np
    import torch
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import block_encode as plain
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    plan, groups = k3_groups(planes, dev, **kwargs)
    ms = plain_ms = 0.0
    nbytes = samples = segs = 0
    for g, args in groups:
        if g.bits != 64:
            raise AssertionError(f'{name}: group {g.w}x{g.h} is not 64-bit')
        cat, bits, ovf = E.encode_cleanup(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain.encode_cleanup_core(*args)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(x, y) for x, y in zip((cat, bits, ovf),
                                                     want)) or ovf.any():
            raise AssertionError(f'ht_cleanup_encode64: differs from the '
                                 f'plain version in group {g.w}x{g.h} of '
                                 f'{name}')
        ms += cuda_ms(lambda: E.encode_cleanup(*args), 20)
        buf, qhl = args[0], args[5]
        n = buf.shape[0]
        samples += int((2 * qhl.to(torch.int64)).clamp(max=g.h).sum()) * g.w
        b = bits.cpu().numpy().astype(np.int64)
        used = (b + 31) // 32
        nbytes += buf.numel() * 8 + n * 8 + int(used.sum()) * 4 + n * 16
        # each lane's words stuffed, against the scalar encoder
        words = cat.cpu().numpy().view(np.uint32)
        off = np.cumsum([0] + list(g.caps))
        dense, meta, at = [], np.zeros((n, 6), np.int64), 0
        for i in range(n):
            for k in range(3):
                dense.append(words[i, off[k]:off[k] + used[i, k]])
                meta[i, 2 * k], meta[i, 2 * k + 1] = at, b[i, k]
                at += used[i, k]
        out, lens = native.pack_from_dense(
            np.concatenate(dense), meta, int(b.sum(1).max()) // 7 + 64)
        host = buf.cpu().numpy().view(np.uint64)
        for i, (bid, _, h_t) in enumerate(g.lanes):
            kmax = plan.bands[bid][3]
            want = native.encode_codeblock(host[i], kmax - 1, g.w, h_t, 64)
            if bytes(out[i, :lens[i]]) != want:
                raise AssertionError(f'ht_cleanup_encode64: lane {i} of '
                                     f'group {g.w}x{g.h} of {name} differs '
                                     f'from the scalar encoder')
            segs += 1
    row = wide_row('ht_cleanup_encode64', 'ht_cleanup_encode', ms, plain_ms,
                   nbytes, samples * ENC_OPS_PER_SAMPLE)
    emit('wide_k3_vs_plain', frame=name, bit_exact=True,
         scalar_encoder_equal_segments=segs, kernel_ms=ms,
         plain_ms=plain_ms, bytes_moved=nbytes, samples=samples,
         bound_ms=row['bound_ms'], card=card_id)
    return row


def codeblock_batches(path: str, dev, bits: int):
    """The committed multi-pass codeblocks of ``path`` (the layout of
    testdata/wide_multipass_codeblocks.npz), one batch of lanes a shape
    (each codeblock repeated over 64 lanes, as k4_synthetic packs its
    batches), to decode at ``bits``: per shape (width, height,
    codeblocks, raw cleanup arguments, raw refinement arguments, dense
    cleanup arguments, dense refinement arguments), every tensor on the
    card."""
    import numpy as np
    import torch
    from openjph_tpu_torch.native import (prep_cleanup_streams,
                                         prep_refine_streams)
    z = np.load(path)
    by_shape = {}
    for i in range(len(z['w'])):
        w, h = int(z['w'][i]), int(z['h'][i])
        cb = {k: int(z[k][i]) for k in ('mm', 'npasses', 'causal', 'len1',
                                         'len2')}
        cb['data'] = z['data'][z['off'][i]:z['off'][i + 1]].tobytes()
        cb['samples'] = z['samples'][z['soff'][i]:z['soff'][i + 1]] \
            .reshape(h, w)
        by_shape.setdefault((w, h), []).append(cb)
    out = []
    for (w, h), cbs in by_shape.items():
        lanes = [cbs[k % len(cbs)] for k in range(64)]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
                .to(dev)

        # the runner's raw layout: d[0:lcup-1] (byte lcup-2 OR'd 0xF),
        # then the refinement segment
        blob, base, at = bytearray(256), [], 256
        for c in lanes:
            d = bytearray(c['data'])
            seg = d[:c['len1'] - 1]
            seg[-1] |= 0x0F
            base.append(at)
            blob += seg + d[c['len1']:c['len1'] + c['len2']]
            at = len(blob)
        blob += bytes(512)
        blob_t = torch.from_numpy(np.frombuffer(bytes(blob), np.uint8)
                                  .copy()).to(dev)
        lc = np.array([c['len1'] for c in lanes])
        sc = np.array([(c['data'][c['len1'] - 1] << 4)
                       + (c['data'][c['len1'] - 2] & 0xF) for c in lanes])
        p = t([(62 if bits == 64 else 30) - c['mm'] for c in lanes])
        qhl = t([(h + 1) // 2] * 64)
        gates = (p, t([c['npasses'] for c in lanes]), t([h] * 64),
                 t([c['causal'] for c in lanes]), w, h)
        base = np.array(base)
        words = tuple(int(x) for x in ((sc.max() * 8 + 31) // 32 + 8,
                                       (sc.max() * 8 + 31) // 32 + 8,
                                       ((lc - sc).max() * 8 + 31) // 32 + 8))
        raw_c = (blob_t, t(base), t(lc - sc), t(sc - 1), p, w, h, qhl,
                 words, bits)
        raw_r = (blob_t, t(base + lc - 1), t([c['len2'] for c in lanes])) \
            + gates
        datas = [c['data'] for c in lanes]
        st = prep_cleanup_streams(datas, lc, sc)
        rs = prep_refine_streams(datas, lc,
                                 np.array([c['len2'] for c in lanes]))

        def words_t(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) \
                .to(dev)

        dense_c = (words_t(st['mel']), words_t(st['vlc']), words_t(st['ms']),
                   p, w, h, qhl, bits)
        dense_r = (words_t(rs['spp']), words_t(rs['mrp'])) + gates
        out.append((w, h, lanes, raw_c, raw_r, dense_c, dense_r))
    return out


def k4_codeblocks(path: str, dev, bits: int) -> int:
    """K2 then K4 and K1 then K4, at ``bits``, on the stored multi-pass
    codeblocks of ``path`` (codeblock_batches): each kernel against its
    plain version, the result against the codeblocks' stored samples
    (the JAX package's decode; at 64 bits a codeblock of fewer than 30
    missing MSBs shifted down by 32, as _Runner.mask reads it) and the
    C++ scalar decoder.  Returns the lanes held a mode."""
    import numpy as np
    import torch
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import block_decode as plain
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    name = os.path.basename(path)
    lanes_total = 0
    for w, h, lanes, raw_c, raw_r, dense_c, dense_r in \
            codeblock_batches(path, dev, bits):
        for raw in (True, False):
            kern_c = K.decode_cleanup_raw if raw else K.decode_cleanup
            ref_c = K.decode_cleanup_raw_plain if raw \
                else plain.decode_cleanup_core
            kern_r, ref_r = (R.refine_raw, R.refine_raw_plain) if raw \
                else (R.refine, R.refine_plain)
            ca, ra = (raw_c, raw_r) if raw else (dense_c, dense_r)
            d, e = kern_c(*ca)
            dp, ep_ = ref_c(*ca)
            torch.cuda.synchronize()
            if not (torch.equal(d, dp) and torch.equal(e, ep_)) or e.any():
                raise AssertionError(f'{bits}-bit cleanup on the {w}x{h} '
                                     f'codeblocks of {name} differs '
                                     f'(raw={raw})')
            got = kern_r(d.clone(), *ra)
            want = ref_r(d, *ra)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f'{bits}-bit refinement on the {w}x{h} '
                                     f'codeblocks of {name} differs from '
                                     f'the plain version (raw={raw})')
            got = got.cpu().numpy().view(np.uint64 if bits == 64
                                         else np.uint32)
            for i, c in enumerate(lanes):
                scalar = native.decode_codeblock(
                    c['data'], c['mm'], c['npasses'], c['len1'],
                    c['len2'], w, h, bool(c['causal']))
                mine = got[i]
                if bits == 64 and c['samples'].dtype == np.uint32:
                    mine = (mine >> np.uint64(32)).astype(np.uint32)
                if not (np.array_equal(mine, c['samples'])
                        and np.array_equal(scalar, c['samples'])):
                    raise AssertionError(f'{bits}-bit refinement: lane {i} '
                                         f'of the {w}x{h} codeblocks of '
                                         f'{name} differs from the stored '
                                         f'samples (raw={raw})')
        lanes_total += len(lanes)
    return lanes_total


def wide_k4_codeblocks(dev, card_id: str):
    """K2-64 then K4-64 (and K1-64 then K4-64) on the committed multi-pass
    codeblocks: each against its plain version, the result against the
    codeblocks' stored samples (the JAX package's decoder) and the C++
    scalar decoder."""
    lanes = k4_codeblocks(WIDE_CODEBLOCKS, dev, 64)
    emit('wide_k4_codeblocks', lanes=lanes, bit_exact=True,
         equal_to_stored_and_scalar=True, card=card_id)


def k4_padding_lanes(dev, card_id: str):
    """K4 raw and dense, 32- and 64-bit, after the card's own K2 / K1,
    on the committed lanes whose cleanup makes a padding sample
    significant (testdata/refine_padding_lanes.npz: 7 and 5 wide, 15 and
    13 tall; 2 and 3 passes; causal or not): each launch bit-exact with
    its plain version, with the JAX package's decode_cleanup_refine
    stored beside the lanes, and with the port's C++ scalar decoder."""
    import numpy as np
    t0 = time.perf_counter()
    with np.load(REFINE_PADDING) as z:
        shapes = sorted({(int(w), int(h)) for w, h in zip(z['w'], z['h'])})
        codeblocks = len(z['w'])
    lanes = {bits: k4_codeblocks(REFINE_PADDING, dev, bits)
             for bits in (32, 64)}
    emit('k4_padding_lanes', codeblocks=codeblocks, shapes=shapes,
         lanes_per_mode=lanes, modes=['raw', 'dense'], bit_exact=True,
         equal_to_jax_refine_and_scalar=True,
         seconds=time.perf_counter() - t0, card=card_id)


def wide_refine_rows(data: bytes, ref, dev, card_id: str) -> dict:
    """K4-64 in both modes on every lane of the 32-bit 3-pass stream
    (after the card's own K2-64 / K1-64): against the plain version and,
    lane by lane, the C++ scalar decoder; timed.  Returns its rows."""
    import numpy as np
    from openjph_tpu_torch import native
    plan, modes = k4_groups(data, dev)
    buf = np.frombuffer(data, np.uint8)
    starts, s0 = {}, 0
    for g in plan.groups:
        starts[g.gid] = s0
        s0 += g.n_pad
    rows = {}
    for kname, kern, refk, raw in k4_modes():
        kname += '64'
        groups = modes[raw]
        plain_ms, outs = hold_k4(kname, kern, refk, groups, 'as coded')
        live = 0
        for (g, _, _), got in zip(groups, outs):
            got = got.cpu().numpy().view(np.uint64)
            for i in range(len(g.members)):
                pos, lcup, _, p, _, npass, l2, h, cs = \
                    (int(x[starts[g.gid] + i]) for x in plan.lanes)
                if pos < 0:
                    continue
                want = native.decode_codeblock(
                    buf[pos:pos + lcup + l2], 62 - p, npass, lcup, l2, g.w,
                    h, bool(cs))
                if not np.array_equal(got[i, :h], want):
                    raise AssertionError(f'{kname}: lane {i} of group '
                                         f'{g.w}x{g.h} differs from the '
                                         f'scalar decoder')
                live += 1
        ms = k4_ms(kern, groups)
        nbytes, ops = k4_bound(groups, raw, outs)
        rows[kname] = wide_row(kname, 'ht_refine_decode', ms, plain_ms,
                               nbytes, ops)
        emit('wide_k4_vs_plain', stream=WIDE_P3, kernel=kname,
             bit_exact=True, scalar_decoder_equal_lanes=live, kernel_ms=ms,
             plain_ms=plain_ms, bytes_moved=nbytes,
             bound_ms=rows[kname]['bound_ms'], card=card_id)
    return rows


def wide_phase(gray, gray_ref, dev, kernels, K, E, R, card_id):
    """Codeblocks of more than 30 bit planes (ROADMAP 7c) on the 64-bit
    instantiations of K1/K2, K4 and K3: each against its plain version on
    every lane of the 2048x1080 32-bit frame (K4 on the committed 3-pass
    stream and codeblocks), against the C++ scalar coders lane by lane;
    then the main path, counted: the 32-bit and 29-bit headline frames and
    the RCT frame encoded and decoded on the card against the port's CPU
    encode and decode (and the sources), the committed fixtures against
    their JAX-package decodes and streams, the 3-pass stream, a burst
    each way; then wide and 8-bit frames timed in turns."""
    import numpy as np
    from openjph_tpu_torch.gpu.encode_pipeline import (encode_gpu,
                                                       encode_gpu_batch)
    from openjph_tpu_torch.gpu.pipeline import decode_gpu, decode_gpu_batch
    t_phase = time.perf_counter()
    frames = {'u32': (wide_frame(1, WIDE, 32), dict(bit_depth=32)),
              'u29': (wide_frame(2, WIDE, 29), dict(bit_depth=29)),
              'rgb_u32_rct': ([wide_frame(3 + c, WIDE_RGB, 32)
                               for c in range(3)], dict(bit_depth=32))}
    # the references: the port's CPU encode and decode (plain versions of
    # every stage); they launch no kernel
    cpu = {}
    for key, (planes, kw) in frames.items():
        t0 = time.perf_counter()
        s = encode_gpu(planes, device='cpu', reversible=True, **kw)
        t1 = time.perf_counter()
        cpu[key] = (s, decode_gpu(s, device='cpu'))
        emit('wide_cpu_reference', frame=key, encode_s=t1 - t0,
             decode_s=time.perf_counter() - t1, bytes=len(s))
    with open(os.path.join(TESTDATA, WIDE_P3 + '.j2c'), 'rb') as f:
        p3 = f.read()
    p3_ref = np.load(os.path.join(TESTDATA, WIDE_P3 + '.npz'))['c0']

    # the kernels against their plain versions and the scalar coders
    rows = wide_decode_rows(cpu['u32'][0], dev, 'u32_2048x1080', card_id)
    rows['ht_cleanup_encode64'] = wide_encode_row(
        [frames['u32'][0]], dev, 'u32_2048x1080', card_id, reversible=True,
        bit_depth=32)
    rows.update(wide_refine_rows(p3, p3_ref, dev, card_id))
    wide_k4_codeblocks(dev, card_id)

    # the main path, counted
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    for key, (planes, kw) in frames.items():
        s, dec = cpu[key]
        got = encode_gpu(planes, device='cuda', reversible=True, **kw)
        if from_sot(got) != from_sot(s):
            raise AssertionError(f'wide {key}: the card\'s encode differs '
                                 f'from the CPU encode')
        src = planes if isinstance(planes, list) else [planes]
        for raw in (True, False):
            out = decode_gpu(got, device='cuda', raw=raw)
            if not all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(out, dec)) or len(out) != len(dec):
                raise AssertionError(f'wide {key}: the card\'s decode '
                                     f'differs from the CPU decode '
                                     f'(raw={raw})')
            if not all(np.array_equal(a, b) for a, b in zip(out, src)):
                raise AssertionError(f'wide {key}: not lossless')
        emit('wide_e2e', frame=key, shape=list(src[0].shape),
             dtype=str(dec[0].dtype), bytes=len(got),
             encode_equal_to_cpu=True, decode_equal_to_cpu=True,
             lossless=True)
    for name in WIDE_FIXTURES:
        with open(os.path.join(TESTDATA, name + '.j2c'), 'rb') as f:
            s = f.read()
        z = np.load(os.path.join(TESTDATA, name + '.npz'))
        kw = json.loads(str(z['kwargs']))
        ref = [z[f'c{c}'] for c in range(len(z.files) - 1)]
        out = decode_gpu(s, device='cuda')
        if not all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(out, ref)) or len(out) != len(ref):
            raise AssertionError(f'{name}: the card\'s decode differs from '
                                 f'the committed host decode')
        if from_sot(encode_gpu(ref, device='cuda', **kw)) != from_sot(s):
            raise AssertionError(f'{name}: the card\'s encode differs from '
                                 f'the committed stream')
        emit('wide_fixture', name=name, decode_equal=True,
             encode_equal_from_sot=True)
    for raw in (True, False):
        out = decode_gpu(p3, device='cuda', raw=raw)
        if len(out) != 1 or out[0].dtype != p3_ref.dtype or \
                not np.array_equal(out[0], p3_ref):
            raise AssertionError(f'{WIDE_P3}: the card\'s decode differs '
                                 f'from the committed host decode '
                                 f'(raw={raw})')
    emit('wide_fixture', name=WIDE_P3, decode_equal=True, modes=2)
    s32, dec32 = cpu['u32']
    outs = decode_gpu_batch([s32] * BURST, device='cuda')
    if any(not np.array_equal(o[0], dec32[0]) or o[0].dtype != dec32[0].dtype
           for o in outs):
        raise AssertionError('a frame of the wide decode burst differs')
    f32 = frames['u32'][0]
    streams = encode_gpu_batch([f32] * BURST, device='cuda', bit_depth=32,
                               reversible=True)
    if any(from_sot(st) != from_sot(s32) for st in streams):
        raise AssertionError('a stream of the wide encode burst differs')
    emit('wide_burst', frames=BURST, decode_equal=True, encode_equal=True)
    launches = launch_counts(K, E, R, wide=True)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched on the wide path')
        rows[k]['launches'] = v
    kernels.update(rows)
    # the narrow bands of the 29-bit frame (kmax 30) run the 32-bit ones
    narrow = launch_counts(K, E, R)
    for k, v in narrow.items():
        kernels[k]['launches'] += v
    emit('wide_path_launches', **launches, **narrow)

    # wide and 8-bit frames in turns (host stages vary between calls)
    def wide_enc(shape, dev):
        return encoder(shape, 1, dev, reversible=True, bit_depth=32)

    runs = {'gray': (gray, gray_ref, dfs_free), 'u32': (s32, f32, wide_enc)}
    for n in (1, BURST):
        res = {}
        for who in ('gray', 'u32', 'u32', 'gray'):
            data, img, make = runs[who]
            dmed, _ = timed(lambda: decode_frames([data] * n, dev), 10)
            emed, _ = timed(lambda: encode_frames([img] * n, dev, make=make),
                            10)
            res.setdefault(who, []).append((dmed['total'], emed['total']))
        for who, pairs in res.items():
            mp = runs[who][1].size / 1e6
            emit('wide_timing', frame=who, frames=n, runs=10,
                 decode_ms=[d for d, _ in pairs],
                 encode_ms=[e for _, e in pairs],
                 decode_mp_per_s=n * mp / (statistics.mean(
                     d for d, _ in pairs) / 1e3),
                 encode_mp_per_s=n * mp / (statistics.mean(
                     e for _, e in pairs) / 1e3), card=card_id)
    emit('wide_phase_s', seconds=time.perf_counter() - t_phase,
         card=card_id)


# ---------------------------------------------------------------------------
# multi-pass encode (ROADMAP 12): K3 and the refinement-pass encoder K5
# ---------------------------------------------------------------------------

# the 3-pass fixture's keywords (testdata/README.md), and the causal
# fixture's on the frame's top-left 512x256
P3_KW = dict(reversible=True, num_decomps=5, ht_passes=3)
P2C_KW = dict(reversible=True, num_decomps=5, ht_passes=2, vert_causal=True)
# integer operations per codeblock sample of the refinement-pass encoder,
# counted off ht_refine_encode.cu on a dense 64x64 block: ~10 for phase A
# (a sample's three tests, shifts and ORs), ~13 for SigProp's decisions (a
# group's inputs, its map walked on five packed spreads and its replay:
# ~215 ops over 16 samples), ~8 for the maps' scan (four steps of ~30 ops
# a group), ~10 for the records (three bit gathers of ~45 ops, popcounts,
# the placing ORs, over 16 samples) and ~15 for the packers (~12.5 a
# coded bit: a chunk's event masks and 16 states, the tables' composition
# and scan, two byte-by-byte replays; ~1.2 coded bits a sample)
REFINE_ENC_OPS_PER_SAMPLE = 56


def k5_groups(frames, dev, passes=None, causal=None, **kwargs):
    """(plan, [(group label, encode_refine's arguments)]) of the lane
    groups with multi-pass lanes of one runner call on ``frames`` (each a
    list of planes), as the runner builds them; ``passes`` / ``causal``
    override the plan's on those lanes."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu.encode_pipeline import (_make_enc_runner,
                                                       _narrow_tile_plane)
    nc = len(frames[0])
    enc, geom = encoder(frames[0][0].shape, nc, dev, **kwargs)
    plan = enc._build_enc_plan(geom)
    runner = _make_enc_runner(plan, len(frames), dev)
    tpl = [torch.from_numpy(np.stack([
        _narrow_tile_plane(enc.siz, geom, c, f[c]) for f in frames])).to(dev)
        for c in range(nc)]
    out = []
    for g, (buf, _), ref in zip(plan.groups, runner.graph(*tpl),
                                runner.lane_refine):
        if ref is None:
            continue
        pm, h_lim, npasses = ref
        if passes is not None:
            npasses = torch.where(npasses > 0, passes, 0).to(torch.int32)
        out.append((f'{g.w}x{g.h}', (buf, pm, h_lim, npasses,
                                     plan.causal if causal is None
                                     else causal, g.w, g.h, g.rcap)))
    return plan, out


def hold_k5(groups, label: str):
    """K5 against its plain version on every lane of ``groups``: the
    segments' words, both byte counts and the overflow flags.  Returns
    (plain ms, kernel outputs per group)."""
    import torch
    from openjph_tpu_torch.gpu import block_refine_encode as plain
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    plain_ms = 0.0
    outs = []
    for gname, a in groups:
        got = R5.encode_refine(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain.encode_refine_core(*a)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        for x, y, what in zip(got, want, ('segments', 'byte counts',
                                          'overflow flags')):
            if not torch.equal(x, y):
                bad = int((x != y).reshape(x.shape[0], -1).any(1).sum())
                raise AssertionError(f'ht_refine_encode: {what} of {bad} '
                                     f'lanes differ from the plain version '
                                     f'in group {gname} ({label})')
        if bool(got[2].any()):
            raise AssertionError(f'ht_refine_encode: a lane of group '
                                 f'{gname} overflowed ({label})')
        outs.append(got)
    return plain_ms, outs


def k5_bound(groups, outs):
    """(bytes, operations) K5 needs on ``groups``: every lane reads its
    pass count and writes its byte counts and flag; a lane of 2 or 3
    passes also reads its p, its height and its rows below that height
    once, and writes its segment's bytes."""
    import torch
    nbytes = ops = 0
    for (_, a), (_, lens, _) in zip(groups, outs):
        h_lim, npasses, w = a[2], a[3], a[5]
        on = npasses >= 2
        samples = int(torch.where(on, h_lim, 0).sum()) * w
        nbytes += npasses.numel() * 13 + int(on.sum()) * 8 + samples * 4 \
            + int(torch.where(on, lens.sum(1), 0).sum())
        ops += samples * REFINE_ENC_OPS_PER_SAMPLE
    return nbytes, ops


def k5_lanes(rng, w: int, h: int, lanes: int):
    """Seeded lanes of w x h in a [lanes, hp, wp] batch for K5, each with
    its own p (2 to 30): noise of every plane count, blocks whose last
    plane is all ones around sparse significant samples (runs of ones:
    0xFF bytes in SigProp, 0x7F in MagRef) and sparse blocks."""
    import numpy as np
    hp, wp = (h + 1) // 2 * 2, (w + 3) // 4 * 4
    buf = np.zeros((lanes, hp, wp), np.uint32)
    ps = rng.randint(2, 31, lanes)
    for i, p in enumerate(ps):
        lsb = 1 << (int(p) - 1)  # the magnitude's last plane, p - 1
        if i % 3 == 0:
            mag = rng.randint(0, 1 << min(32 - int(p), 16), (h, w)) \
                .astype(np.uint64) * lsb
            mag[rng.rand(h, w) < rng.rand()] = 0
        elif i % 3 == 1:
            mag = np.full((h, w), lsb, np.uint64)
            mag[rng.rand(h, w) < 0.05] |= 2 * lsb
        else:
            mag = ((rng.rand(h, w) < 0.3) * 3 * lsb).astype(np.uint64)
        neg = rng.rand(h, w) < (0.95 if i % 3 == 1 else 0.5)
        buf[i, :h, :w] = (np.minimum(mag, (1 << 31) - 1)
                          | (neg & (mag != 0)).astype(np.uint64) << 31)
    return buf, ps.astype(np.int32)


def k5_synthetic(dev, card_id: str, lanes: int = 192, seed: int = 13):
    """K5 against its plain version on seeded lanes of eight codeblock
    shapes, odd ones among them: each lane with its own p, passes (0 to
    3) and height (half of them below the group's), causal off and
    on."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu import block_refine_encode as plain
    rng = np.random.RandomState(seed)
    res = {}
    for w, h in ((64, 64), (128, 32), (32, 128), (1024, 4), (4, 1024),
                 (13, 7), (64, 1), (1, 1)):
        buf, ps = k5_lanes(rng, w, h, lanes)
        hp = buf.shape[1]
        h_lim = np.where(rng.rand(lanes) < 0.5, h,
                         rng.randint(1, h + 1, lanes)).astype(np.int32)
        npasses = rng.choice([0, 1, 2, 3, 3, 2], lanes).astype(np.int32)
        cap = plain.cap_words(w, hp)
        t = [torch.from_numpy(x).to(dev)
             for x in (buf.view(np.int32), ps, h_lim, npasses)]
        for causal in (False, True):
            _, outs = hold_k5([(f'{w}x{h}', (*t, causal, w, hp, cap))],
                              f'synthetic, causal={causal}')
            lens = outs[0][1]
            res[f'{w}x{h}'] = [int(lens[:, 0].max()), int(lens[:, 1].max()),
                               int((lens.sum(1) == 0).sum())]
    emit('k5_synthetic', lanes_per_shape=lanes, bit_exact=True,
         causal=[False, True],
         max_spp_bytes_max_mrp_bytes_empty_lanes=res, card=card_id)


def k5_ms(groups, launch=None) -> float:
    """K5's device time on ``groups`` (one launch a group, summed), by
    default through the wrapper at its PER_BLOCK."""
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    fn = launch or R5.encode_refine
    return sum(cuda_ms(lambda: fn(*a), 20) for _, a in groups)


def k5_vs_plain(frames, name: str, dev, card_id: str, row: bool = False):
    """K5 against its plain version on every lane of a runner call on
    ``frames`` (the 3-pass fixture's keywords) at 2 and 3 passes, causal
    off and on; then its time on the frames' lanes as coded, at 1, 2 and
    4 codeblocks a CUDA block too.  With ``row``, also the k5_split
    line (the lanes at npasses 0, 2 and 3: the output alone; phase A,
    SigProp and its packer; all) and its kernels-line row."""
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    checked = []
    for passes in (3, 2):
        for causal in (False, True):
            plan, groups = k5_groups(frames, dev, passes=passes,
                                     causal=causal, **P3_KW)
            plain_ms, outs = hold_k5(groups, f'{name}, {passes} passes, '
                                             f'causal={causal}')
            if passes == 3 and not causal:
                coded = (groups, plain_ms, outs)
            elif passes == 2 and not causal:
                two = groups
            checked.append([passes, causal,
                            sum(int(o[1].sum()) for o in outs)])
    groups, plain_ms, outs = coded
    lanes = sum(a[0].shape[0] for _, a in groups)
    ms = k5_ms(groups)
    sweep = {}
    default = R5.PER_BLOCK
    try:
        for k in (1, 2, 4):
            R5.PER_BLOCK = k
            sweep[k] = k5_ms(groups)
    finally:
        R5.PER_BLOCK = default
    nbytes, ops = k5_bound(groups, outs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    emit('k5_vs_plain', frame=name, frames=len(frames), lanes=lanes,
         groups=[gname for gname, _ in groups], bit_exact=True,
         passes_causal_segment_bytes=checked, plain_ms=plain_ms,
         kernel_ms=ms, bytes_moved=nbytes, bound_ms=max(bytes_ms, ops_ms),
         codeblocks_per_block=R5.PER_BLOCK,
         kernel_ms_by_codeblocks_per_block=sweep, card=card_id)
    if not row:
        return None
    # where the time goes, by the kernel's own gate: npasses 0 (launch,
    # lane exit and the zeroed segments), 2 (phase A, SigProp's decisions,
    # records and packer), 3 (MagRef's records and packer too)
    _, none = k5_groups(frames, dev, passes=0, **P3_KW)
    split = {0: k5_ms(none), 2: k5_ms(two), 3: ms}
    emit('k5_split', frame=name, lanes=lanes, npasses0_ms=split[0],
         npasses2_ms=split[2], npasses3_ms=split[3],
         phase_a_sigprop_packer_ms=split[2] - split[0],
         magref_ms=split[3] - split[2], card=card_id)
    return {
        'name': 'ht_refine_encode', 'route': 'cuda',
        'source': 'openjph_tpu_torch/gpu/csrc/ht_refine_encode.cu',
        # no TPU kernel is behind it: the JAX package's host coder
        'replaces': 'openjph_tpu/coding/encoder.py:460',
        'launches': 0, 'max_abs_err': 0, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': max(bytes_ms, ops_ms),
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': None, 'bit_exact': True,
    }


def against_refine_encode(src: str, dev, card_id: str):
    """``--against-refine-encode SRC``: another source of the
    refinement-pass encoder with the same C interface (launched with four
    codeblocks a CUDA block) and this checkout's, on the 3-pass frame's
    lanes and on an 8-frame burst's: equal outputs on every lane, then
    their times in turns (against, this, this, against); on the frame
    also both split by the npasses gate, as k5_split splits this one."""
    import numpy as np
    import torch
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    lib = R5.build(os.path.abspath(src), 'ht_refine_encode_against')

    def other(*a):
        return R5.launch(lib, 4, *a)

    def this(*a):
        return R5.launch(R5.load(), R5.PER_BLOCK, *a)

    frames = [[f] for f in video_frames(np.load(GRAY_NPY))[:BURST]]
    for name, ff in (('gray_2048x1080', frames[:1]),
                     ('gray_2048x1080_rolled_burst', frames)):
        _, groups = k5_groups(ff, dev, **P3_KW)
        for gname, a in groups:
            got, want = this(*a), other(*a)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f'ht_refine_encode: {src} and this '
                                     f'checkout differ in group {gname} '
                                     f'of {name}')

        def turns(gg):
            t = {'against': [], 'this': []}
            for who in ('against', 'this', 'this', 'against'):
                t[who].append(k5_ms(gg, other if who == 'against' else this))
            return t

        times = turns(groups)
        split = {}
        if len(ff) == 1:
            for k in (0, 2):
                t = turns(k5_groups(ff, dev, passes=k, **P3_KW)[1])
                split[f'npasses{k}'] = {w: statistics.mean(v)
                                        for w, v in t.items()}
            split['npasses3'] = {w: statistics.mean(v)
                                 for w, v in times.items()}
        old = statistics.mean(times['against'])
        new = statistics.mean(times['this'])
        emit('against_refine_encode', kernel='ht_refine_encode', frame=name,
             source=src, equal=True,
             lanes=sum(a[0].shape[0] for _, a in groups),
             against_ms=times['against'], this_ms=times['this'],
             speedup=old / new, split_ms=split,
             this_codeblocks_per_block=R5.PER_BLOCK, card=card_id)


def k3_multipass_vs_scalar(gray_ref, dev, card_id: str):
    """The cleanup encoder's first launches at p = 32 - kmax (the kept
    multi-pass lanes' cleanup), and at 31 - kmax, against its plain
    version and, stuffed, against the C++ scalar encoder at kmax - 2 and
    kmax - 1 missing MSBs, on every lane of the 3-pass frame; the chosen
    segments as the fused path fills them."""
    import numpy as np
    import torch
    from openjph_tpu_torch import native
    from openjph_tpu_torch.gpu import block_encode as plain
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    from openjph_tpu_torch.gpu.encode_pipeline import (_empty_coded,
                                                       _fetch_outs)
    plan, runner, batches = enc_batches([gray_ref], dev, **P3_KW)
    enc, geom = encoder(gray_ref.shape, 1, dev, **P3_KW)
    k3_ms = {'p_32_minus_kmax': 0.0, 'p_31_minus_kmax': 0.0}
    for g, (buf, _), p, qhl, ref in zip(plan.groups, batches, runner.lane_p,
                                        runner.lane_qhl, runner.lane_refine):
        if ref is None:
            raise AssertionError(f'group {g.w}x{g.h} of the 3-pass frame '
                                 f'has no multi-pass lane')
        for key, lane_p in (('p_32_minus_kmax', ref[0]),
                            ('p_31_minus_kmax', p)):
            args = (buf, lane_p, g.w, g.h, g.caps, qhl)
            got, want = E.encode_cleanup(*args), \
                plain.encode_cleanup_core(*args)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f'ht_cleanup_encode at {key} differs '
                                     f'from the plain version in group '
                                     f'{g.w}x{g.h}')
            k3_ms[key] += cuda_ms(lambda: E.encode_cleanup(*args), 20)
    coded = _empty_coded(geom, 1)
    enc._stuff(plan, *_fetch_outs(plan, *runner.tier1(batches), 1), [coded])
    kinds = {}
    for g, (buf, nz) in zip(plan.groups, batches):
        host = buf.cpu().numpy().view(np.uint32)
        for lane, (bid, bi, h_t) in enumerate(g.lanes):
            (c, r, b, kmax, _, _, _, _) = plan.bands[bid]
            cb = coded[c][r][b][bi]
            if not bool(nz[0, lane]):
                continue
            kinds[cb.num_passes] = kinds.get(cb.num_passes, 0) + 1
            want = native.encode_codeblock(host[lane], cb.missing_msbs, g.w,
                                           h_t)
            if cb.missing_msbs != kmax - (2 if cb.num_passes > 1 else 1) \
                    or cb.data[:cb.pass_length[0]] != want:
                raise AssertionError(f'lane {lane} of group {g.w}x{g.h}: '
                                     f'the cleanup segment differs from the '
                                     f'scalar encoder\'s')
    emit('k3_multipass_vs_scalar', frame='gray_2048x1080', bit_exact=True,
         coded_lanes_by_passes=kinds, kernel_ms=k3_ms, card=card_id)


def scalar_lanes(plan, groups, outs, buf, kname: str) -> int:
    """The cleanup and refinement kernels' output ``outs`` on every live
    lane of a frame's ``groups`` (k4_groups) against the C++ scalar
    codeblock decoder; returns the lanes held."""
    import numpy as np
    from openjph_tpu_torch import native
    starts = {}
    s0 = 0
    for g in plan.groups:
        starts[g.gid] = s0
        s0 += g.n_pad
    live = 0
    for (g, _, _), got in zip(groups, outs):
        got = got.cpu().numpy().view(np.uint32)
        for i in range(len(g.members)):
            pos, lcup, _, p, qhl, npass, l2, h, cs = \
                (int(x[starts[g.gid] + i]) for x in plan.lanes)
            if pos < 0:
                continue
            want = native.decode_codeblock(
                buf[pos:pos + lcup + l2], 30 - p, npass, lcup, l2, g.w,
                h, bool(cs))
            if not np.array_equal(got[i, :h], want):
                raise AssertionError(f'{kname}: lane {i} of group '
                                     f'{g.w}x{g.h} differs from the '
                                     f'scalar decoder')
            live += 1
    return live


def hold_vs_scalar_decoder(data: bytes, dev, name: str) -> int:
    """The cleanup and refinement kernels (both reader modes) on every
    live lane of a multi-pass stream against the C++ scalar codeblock
    decoder; returns the lanes held."""
    import numpy as np
    plan, modes = k4_groups(data, dev)
    buf = np.frombuffer(data, np.uint8)
    live = 0
    for kname, kern, _, raw in k4_modes():
        outs = [kern(d.clone(), *a) for _, d, a in modes[raw]]
        live = scalar_lanes(plan, modes[raw], outs, buf, kname)
    if not live:
        raise AssertionError(f'{name} has no live multi-pass lane')
    return live


def multipass_encode_phase(gray_ref, gray3_ref, rgb_planes, dev, kernels, K,
                           E, R, R5, card_id):
    """Multi-pass encode (ROADMAP 12) on the card: K5 held bit-exact
    against its plain version on the 3-pass frame's lanes, an 8-frame
    burst's and seeded synthetic lanes, at 2 and 3 passes, causal off and
    on; K3's launches at p = 32 - kmax against its plain version and the
    scalar encoder; then, counted, the 3-pass frame equal to
    gray_2048x1080_rev_p3.j2c and the causal crop to
    gray_512x256_rev_p2_causal.j2c from the first SOT, the mixed-choice
    fixture, the 3-pass mosaic fixture through MosaicEncoder, an 8-frame
    burst through encode_gpu_batch equal to the per-frame encodes, and a
    256x256 RGB 9/7 3-pass frame equal to the CPU encode; each stream
    decoded on the card (K2 and K1, then K4) against the CPU decode, the
    3-pass frame's lanes against the scalar decoder; then the 3-pass
    encode timed in turns with the 1-pass one.  The counted launches are
    added to ``kernels``."""
    import numpy as np
    from openjph_tpu_torch import encode_gpu_batch
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    from openjph_tpu_torch.parallel import MosaicEncoder, make_mesh
    from openjph_tpu_torch.parallel._testing import (
        MIXED_PASSES, MIXED_PASSES_KWARGS, mixed_passes_source,
        mosaic_fixture_sources)
    t_phase = time.perf_counter()
    frames = [[f] for f in video_frames(gray_ref)[:BURST]]
    # K5 and K3 held, not counted
    kernels['ht_refine_encode'] = k5_vs_plain(frames[:1], 'gray_2048x1080',
                                              dev, card_id, row=True)
    k5_vs_plain(frames, 'gray_2048x1080_rolled_burst', dev, card_id)
    k5_synthetic(dev, card_id)
    k3_multipass_vs_scalar(gray_ref, dev, card_id)
    # references, not counted: the fixtures and the CPU encode of the RGB
    # crop
    gray3 = open(GRAY3, 'rb').read()
    causal2 = open(CAUSAL2, 'rb').read()
    mixed = open(os.path.join(TESTDATA, MIXED_PASSES + '.j2c'), 'rb').read()
    p3_name = 'mosaic_gray_128x128_rev_p3_t64'
    mosaic_planes, mosaic_kw = mosaic_fixture_sources()[p3_name]
    mosaic_p3 = open(os.path.join(TESTDATA, p3_name + '.j2c'), 'rb').read()
    rgb = [np.ascontiguousarray(p[:256, :256]) for p in rgb_planes]
    rgb_kw = dict(reversible=False, num_decomps=5, ht_passes=3)
    t0 = time.perf_counter()
    rgb_cpu = encode_gpu(rgb, device='cpu', **rgb_kw)
    rgb_cpu_s = time.perf_counter() - t0
    K.reset_launches()
    E.reset_launches()
    R.reset_launches()
    R5.reset_launches()
    streams = {}
    streams['gray_2048x1080_rev_p3'] = encode_gpu(gray_ref, device=dev,
                                                  **P3_KW)
    streams['gray_512x256_rev_p2_causal'] = encode_gpu(
        np.ascontiguousarray(gray_ref[:256, :512]), device=dev, **P2C_KW)
    streams[MIXED_PASSES] = encode_gpu(mixed_passes_source(), device=dev,
                                       **MIXED_PASSES_KWARGS)
    for name, want in (('gray_2048x1080_rev_p3', gray3),
                       ('gray_512x256_rev_p2_causal', causal2),
                       (MIXED_PASSES, mixed)):
        if from_sot(streams[name]) != from_sot(want):
            raise AssertionError(f'the {name} encode differs from its '
                                 f'fixture from the first SOT on')
    streams[p3_name] = MosaicEncoder(make_mesh(), **mosaic_kw).encode(
        mosaic_planes)
    if streams[p3_name] != mosaic_p3:
        raise AssertionError(f'{p3_name}: MosaicEncoder differs from the '
                             f'JAX package\'s stream')
    burst = encode_gpu_batch([f[0] for f in frames], device=dev, **P3_KW)
    singles = [encode_gpu(f[0], device=dev, **P3_KW) for f in frames]
    if burst != singles or from_sot(burst[0]) != from_sot(gray3):
        raise AssertionError('a 3-pass burst stream differs from the '
                             'per-frame encode')
    streams['rgb_256x256_97_ict_p3'] = encode_gpu(rgb, device=dev, **rgb_kw)
    if streams['rgb_256x256_97_ict_p3'] != rgb_cpu:
        raise AssertionError('the RGB 9/7 3-pass encode differs from the '
                             'CPU encode')
    # decoded back on the card, both runner modes
    held = {}
    for name, s in streams.items():
        want = gray3_ref if name == 'gray_2048x1080_rev_p3' \
            else decode_gpu(s, device='cpu', raw=False)
        for raw in (True, False):
            got = decode_gpu(s, device=dev, raw=raw)
            if len(got) != len(want) or not all(
                    np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f'{name} does not decode on the card '
                                     f'to its CPU decode (raw={raw})')
        held[name] = len(s)
    launches = launch_counts(E, R5, K, R)
    for k in ('ht_cleanup_encode', 'ht_refine_encode',
              'ht_cleanup_decode_raw', 'ht_cleanup_decode_dense',
              'ht_refine_decode_raw', 'ht_refine_decode_dense'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched on the multi-pass '
                                 f'encode path')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    live = hold_vs_scalar_decoder(streams['gray_2048x1080_rev_p3'], dev,
                                  'gray_2048x1080_rev_p3')
    emit('e2e_multipass_encode', streams_bytes=held,
         equal_to_fixtures_from_sot=['gray_2048x1080_rev_p3',
                                     'gray_512x256_rev_p2_causal',
                                     MIXED_PASSES],
         mosaic_equal_to_jax_stream=True, burst_equal_to_single=True,
         rgb_97_equal_to_cpu=True, rgb_cpu_reference_s=rgb_cpu_s,
         decodes_to_cpu_decode=True, scalar_decoder_equal_lanes=live)
    emit('multipass_encode_path_launches', **launches)

    # 3-pass encode stage times in turns with the 1-pass one, one frame and
    # a burst (median of the runs), then encode_gpu_batch of 8 distinct
    # frames
    mp = gray_ref.size / 1e6
    make = {1: dfs_free,
            3: lambda shape, d: encoder(shape, 1, d, **P3_KW)}
    for passes in (1, 3, 3, 1):
        for n in (1, BURST):
            med, p75 = timed(lambda: encode_frames([gray_ref] * n, dev,
                                                   make=make[passes]), 40)
            emit('multipass_encode_timing', passes=passes, frames=n, runs=40,
                 median_ms=med, total_p75_ms=p75,
                 mp_per_s=n * mp / (med['total'] / 1e3), card=card_id)
    walls = {1: [], 3: []}
    for passes in (1, 3, 3, 1):
        kw = P3_KW if passes == 3 else dict(reversible=True)
        walls[passes].append(host_ms(lambda: encode_gpu_batch(
            [f[0] for f in frames], device=dev, **kw), 10))
    emit('multipass_encode_batch_timing', frames=BURST, runs=10,
         turns='1, 3, 3, 1 passes', median_wall_ms=walls,
         mp_per_s={k: BURST * mp / (statistics.mean(v) / 1e3)
                   for k, v in walls.items()}, card=card_id)
    emit('multipass_encode_phase_s', seconds=time.perf_counter() - t_phase,
         card=card_id)


# ---- the fuzz harnesses over the OpenJPH corpus (ROADMAP 13) and the
# entry point (ROADMAP 14) ----

FUZZ_MUTATIONS = 96       # mutated streams a runner mode, RandomState(0)
FUZZ_GRAY_MUTATIONS = 4   # mutations of the gray frame, RandomState(1)
FUZZ_PARAM_SETS = 48      # random_params sets, RandomState(0)
FUZZ_CHILD_TIMEOUT = 300
# codeblock shapes of the encode checks: (rows, columns) of the image,
# block_size (width, height)
FUZZ_BLOCK_ENCODES = (((16, 2048), (1024, 4)), ((2048, 16), (4, 1024)),
                      ((64, 80), (4, 4)))


def start_fuzz_child(dense: bool):
    """The decode fuzzer's FUZZ_MUTATIONS mutations on the card in a
    process of its own (one runner mode), its output to a file."""
    import tempfile
    log = tempfile.TemporaryFile(mode='w+')
    cmd = [sys.executable, '-m', 'openjph_tpu_torch.fuzzing.fuzz_decode',
           str(FUZZ_MUTATIONS), '0', '--device', 'cuda']
    # two CPU threads each: the two processes and this one share the
    # host's cores for their CPU references
    env = dict(os.environ, OMP_NUM_THREADS='2')
    return subprocess.Popen(cmd + (['--dense'] if dense else []), cwd=ROOT,
                            env=env, stdout=log, stderr=subprocess.STDOUT,
                            text=True), log


def fuzz_child_stats(proc, log, label: str) -> dict:
    """The stats line of a start_fuzz_child process, waited for at most
    FUZZ_CHILD_TIMEOUT seconds and killed after."""
    try:
        proc.wait(timeout=FUZZ_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f'the {label} mutations of seed 0 ran over '
                             f'{FUZZ_CHILD_TIMEOUT} s') from None
    log.seek(0)
    out = log.read()
    log.close()
    lines = [ln for ln in out.splitlines() if ln.startswith('done: ')]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f'the {label} mutations exited '
                             f'{proc.returncode}:\n{out[-6000:]}')
    return json.loads(lines[-1][len('done: '):])


def fuzz_phase(gray, dev, kernels, K, E, R, card_id):
    """The decode fuzzer over the card (ROADMAP 13): the 52 streams of
    fuzzing/seed_corpus/ and the 6 of make_seeds in both runner modes,
    strict and resilient, against one CPU decode each; FUZZ_MUTATIONS
    mutated streams a runner mode in two processes (fuzz_decode.run, the
    JAX harness's draw) with the card's peak memory after 25 streams and
    after all; FUZZ_GRAY_MUTATIONS mutations of the gray 2048x1080 frame;
    the encode fuzzer's FUZZ_PARAM_SETS sets against the CPU encode and
    FUZZ_BLOCK_ENCODES.  Counted: K1, K2, K3 and K4 must each launch."""
    import numpy as np
    import torch
    from openjph_tpu_torch.fuzzing import fuzz_decode as FD
    from openjph_tpu_torch.fuzzing import fuzz_encode as FE
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    from openjph_tpu_torch.gpu.pipeline import decode_gpu
    t_phase = time.perf_counter()
    children = [(start_fuzz_child(dense), 'dense' if dense else 'raw')
                for dense in (False, True)]
    try:
        names = [f[:-4] for f in sorted(os.listdir(FD.CORPUS))
                 if f.endswith('.j2c')]
        seeds = FD.make_seeds(dev)
        names += [f'make_seeds_{k}' for k in range(len(seeds) - len(names))]
        t0 = time.perf_counter()
        refs = [FD.decode_or_error(s, 'cpu', False, False) for s in seeds]
        seeds_cpu_s = time.perf_counter() - t0
        bad = [n for n, (_, err) in zip(names, refs) if err is not None]
        if bad:
            raise AssertionError(f'the CPU decode rejects seeds {bad}')
        rng = np.random.RandomState(1)
        gray_cases = []
        for k in range(FUZZ_GRAY_MUTATIONS):
            data = FD.mutate(rng, gray)
            gray_cases.append((data, FD.cpu_reference(data)))
        sets = []
        rng = np.random.RandomState(0)
        for _ in range(FUZZ_PARAM_SETS):
            sets.append(FE.random_params(rng))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        R.reset_launches()
        E.reset_launches()
        t0 = time.perf_counter()
        for name, data, ref in zip(names, seeds, refs):
            for raw in (True, False):
                FD.check_stream(data, dev, raw, (ref, ref), name)
        emit('fuzz_seeds', streams=len(seeds), corpus=len(FD.load_corpus()),
             modes=['raw', 'dense'], strict_and_resilient=True,
             equal_to_cpu=True, card_s=time.perf_counter() - t0,
             cpu_reference_s=seeds_cpu_s)
        outcomes = []
        for k, (data, ref) in enumerate(gray_cases):
            for raw in (True, False):
                got = FD.check_stream(data, dev, raw, ref,
                                      f'gray mutation {k} of seed 1')
            outcomes.append(['accepted' if e is None else type(e).__name__
                             for _, e in got])
        emit('fuzz_gray_mutations', stream='gray_2048x1080_rev',
             mutations=FUZZ_GRAY_MUTATIONS, seed=1,
             strict_resilient=outcomes, equal_to_cpu=True)
        n_ok = n_rej = 0
        t0 = time.perf_counter()
        for it, (planes, kw) in enumerate(sets):
            if FE.check_params(planes, kw, dev, f'set {it} of seed 0') \
                    is None:
                n_rej += 1
            else:
                n_ok += 1
        emit('fuzz_encode', sets=FUZZ_PARAM_SETS, seed=0, encoded=n_ok,
             rejected=n_rej, equal_to_cpu=True,
             wall_s=time.perf_counter() - t0)
        img_rng = np.random.RandomState(4)
        for shape, bs in FUZZ_BLOCK_ENCODES:
            img = img_rng.randint(0, 256, shape).astype(np.int32)
            kw = dict(reversible=True, block_size=bs)
            got = encode_gpu(img, device=dev, **kw)
            if got != encode_gpu(img, device='cpu', **kw):
                raise AssertionError(f'{shape} with codeblocks {bs} encodes '
                                     f'unlike the CPU encode')
            back = decode_gpu(got, device=dev)
            if len(back) != 1 or not np.array_equal(back[0], img):
                raise AssertionError(f'{shape} with codeblocks {bs} does '
                                     f'not decode back to the image')
            emit('fuzz_block_encode', shape=list(shape), block_size=list(bs),
                 bytes=len(got), equal_to_cpu=True, decodes_to_source=True)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = launch_counts(K, R, E)
        for proc, label in children:
            st = fuzz_child_stats(*proc, label)
            n = st['ok'] + st['valueerror'] + st['eof']
            if n != FUZZ_MUTATIONS:
                raise AssertionError(f'{label}: {n} of {FUZZ_MUTATIONS} '
                                     f'mutations counted')
            if st['peak_bytes'] > 1.25 * st['peak_bytes_at_25']:
                raise AssertionError(
                    f'{label}: the card\'s peak memory grew from '
                    f'{st["peak_bytes_at_25"]} bytes after 25 streams to '
                    f'{st["peak_bytes"]}')
            if st['allocated_bytes'] > st['allocated_bytes_at_25']:
                raise AssertionError(
                    f'{label}: the memory held between streams grew from '
                    f'{st["allocated_bytes_at_25"]} bytes after 25 streams '
                    f'to {st["allocated_bytes"]}')
            for k, v in st['launches'].items():
                if k in launches:
                    launches[k] += v
            emit('fuzz_mutations', mode=label, seed=0, **st,
                 peak_growth=st['peak_bytes'] / st['peak_bytes_at_25'])
    finally:
        for (proc, log), _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if not log.closed:
                log.close()
    for k in ('ht_cleanup_decode_dense', 'ht_cleanup_decode_raw',
              'ht_cleanup_encode', 'ht_refine_decode_dense',
              'ht_refine_decode_raw'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the fuzz phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('fuzz_path_launches', **launches)
    emit('fuzz_phase_s', seconds=time.perf_counter() - t_phase,
         peak_device_mb=peak / 2**20, card=card_id)


def entry_phase(dev, kernels, K, E, card_id):
    """openjph_tpu_torch.entry on the card (ROADMAP 14): entry()'s runner
    (K1, the dense layout) decodes the sample to its image, and
    dryrun_multichip(1) runs its five stages (K1, the sharded DWT, K2,
    K3, the two-process fan-out).  Counted in this process."""
    import numpy as np
    from openjph_tpu_torch import entry as EN
    t0 = time.perf_counter()
    K.reset_launches()
    E.reset_launches()
    runner, args = EN.entry()
    errs, outs = runner(*args)
    _, img = EN._sample_stream()
    if bool(errs.any()) or len(outs) != 1 or not np.array_equal(
            outs[0][0][0].cpu().numpy().astype(np.int32), img):
        raise AssertionError('entry() does not decode to the sample image')
    emit('entry', shape=list(outs[0][0].shape), equal_to_image=True)
    t1 = time.perf_counter()
    EN.dryrun_multichip(1)
    emit('dryrun_multichip', devices=1, stages=5, passed=True,
         wall_s=time.perf_counter() - t1)
    launches = launch_counts(K, E)
    for k in ('ht_cleanup_decode_dense', 'ht_cleanup_decode_raw',
              'ht_cleanup_encode'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the entry phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('entry_path_launches', **launches)
    emit('entry_phase_s', seconds=time.perf_counter() - t0, card=card_id)


def ab_upload_phase(dev, kernels, K, E, card_id):
    """The upload A/B tool (openjph_tpu_torch.tools.ab_upload) at full
    size: 2 sets of 8 gray 2048x1080 frames encoded on the card (K3),
    one warm-up, then 3 rounds of the staged, unstaged and synchronous
    strategies in turns, 6 bursts each through VideoDecoder (K2); a line
    of MP/s a round, every strategy's last burst equal to its frames.
    Counted in this process."""
    from openjph_tpu_torch.tools import ab_upload
    t0 = time.perf_counter()
    K.reset_launches()
    E.reset_launches()
    res = ab_upload.main(device=dev, log=lambda m: print(
        'ab_upload:', m, file=sys.stderr, flush=True))
    if not res['last_equal']:
        raise AssertionError('ab_upload: a strategy\'s last burst differs '
                             'from the frames it was coded from')
    for r, row in enumerate(res['rounds']):
        emit('ab_upload_round', round=r, frames_per_burst=ab_upload.NFRAMES,
             bursts=ab_upload.NBURST, mp_per_s=row, card=card_id)
    launches = launch_counts(K, E)
    for k in ('ht_cleanup_decode_raw', 'ht_cleanup_encode'):
        if launches[k] == 0:
            raise AssertionError(f'{k} was not launched in the ab_upload '
                                 f'phase')
    for k, v in launches.items():
        kernels[k]['launches'] += v
    emit('ab_upload', rounds=len(res['rounds']), strategies=list(
        ab_upload.STRATEGIES), last_bursts_equal=True,
         warmup_s=res['warmup_s'], encode_s=res['encode_s'])
    emit('ab_upload_path_launches', **launches)
    emit('ab_upload_phase_s', seconds=time.perf_counter() - t0,
         card=card_id)


# what the rest_graph phase takes of a benchmark configuration besides
# its size, components and depth: the encode keywords it states
CONFIG_ENCODE_KEYS = ('bit_depth', 'is_signed', 'reversible', 'num_decomps',
                      'block_size', 'prog_order', 'color_transform',
                      'base_delta', 'ht_passes', 'tile_size')


def config_streams(name: str, dev, seed: int, n: int):
    """``n`` distinct frames of the geometry of the benchmark
    configuration ``name`` (gpubench/configs/<name>.json, read as data),
    drifting sines plus film grain of sigma 6, further components offset
    by sines of their own, each encoded on the card with the
    configuration's encode keywords."""
    import numpy as np
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    with open(os.path.join(ROOT, 'gpubench', 'configs',
                           name + '.json')) as f:
        cfg = json.load(f)
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
          for k in CONFIG_ENCODE_KEYS if k in cfg}
    h, w, nc = cfg['height'], cfg['width'], cfg['components']
    top = (1 << cfg['bit_depth']) - 1
    rng = np.random.default_rng(seed)
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    out = []
    for k in range(n):
        t = np.float32(k)
        base = (127 + 60 * np.sin(x / 97.0 + t * 0.8)
                * np.cos(y / 83.0 - t * 0.35)
                + 40 * np.sin((x + y) / 211.0 + t))
        planes = [np.clip(base + 20 * c * np.sin(x / 53.0 + c + t)
                          + rng.standard_normal((h, w), dtype=np.float32)
                          * 6, 0, top).astype(np.int32)
                  for c in range(nc)]
        out.append(encode_gpu(planes, device=dev, **kw))
    return out


def rest_graph_phase(dev, card_id):
    """The rest of graph replayed from its CUDA graph, bit-equal to its
    eager launches: each benchmark geometry (config_streams) in bursts
    A, B, A, B through one VideoDecoder (B is A's frames reversed, or for
    a one-frame burst the next frame, whose word buckets may differ: one
    graph takes both: eager, capture, replay, replay); the video decoder's
    five modes; two VideoDecoders on two streams and threads sharing one
    graph with bursts in flight; a MosaicDecoder pass, three times.  Every
    replayed output is held to a one-call runner's eager output of the
    same burst.  Then, per geometry, a sequence of distinct frames that
    does not loop (128 gray frames in bursts of 8, two in flight; 48 RGB
    frames one at a time), from no graph and no runner, as the benchmark
    cells decode them: the runner keys and graph keys it meets, the share
    of dispatches that replayed a graph captured before them, and the
    card's peak memory, allocated and reserved.  Prints each graph's
    capture ms and pool bytes, the host's enqueue ms eager and replayed
    and the kernels a profiler sees of each."""
    import numpy as np
    import torch
    from openjph_tpu_torch import VideoDecoder, trace
    from openjph_tpu_torch.gpu import pipeline as tp
    from openjph_tpu_torch.parallel import MosaicDecoder
    t_phase = time.perf_counter()
    rdev = tp.resolve_device(dev)

    def fresh():
        """No runner and no graph, the card's caches emptied."""
        with tp._RUNNERS._lock:
            tp._RUNNERS._entries.clear()
        with tp._REST_GRAPHS._lock:
            entries = list(tp._REST_GRAPHS._entries.values())
            tp._REST_GRAPHS._entries.clear()
        for e in entries:
            if e.graph is not None:
                e.graph.close()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def plan(streams):
        """The plan of a burst's runner."""
        return tp._burst_plans(tp._decoders(streams, dev, True, False,
                                            0))[0]

    def prepared(streams, raw=True):
        """A burst's plans and its arguments on the card."""
        decs = tp._decoders(streams, dev, raw, False, 0)
        plans = tp._burst_plans(decs)
        return plans, tp.upload(tp._pack(list(zip(decs, plans)), raw), dev)

    def eager(streams, raw=True):
        """A one-call runner's (eager) outputs of one burst, on the card."""
        plans, args = prepared(streams, raw)
        runner = tp._make_runner(plans[0], len(streams), dev, raw)
        if runner.graphs:
            raise AssertionError('a one-call runner replays graphs')
        return runner(*args)[1]

    def equal(got, want, label):
        host = not isinstance(got[0][0], torch.Tensor)
        for t, (g_t, w_t) in enumerate(zip(got, want)):
            for c, (g, w) in enumerate(zip(g_t, w_t)):
                w = w.cpu().numpy() if host else w
                ok = (np.array_equal(g, w) if host else
                      g.dtype == w.dtype and torch.equal(g, w))
                if not ok:
                    raise AssertionError(f'{label}: tile {t} component {c} '
                                         f'differs from the eager launch')

    def frames_host(bursts_out):
        # collect() gives per frame its components; as per tile [F, h, w]
        return [[tuple(np.stack([f[c] for f in b]) for c in range(len(b[0])))]
                for b in bursts_out]

    def graphs():
        with tp._REST_GRAPHS._lock:
            return [e.graph for e in tp._REST_GRAPHS._entries.values()
                    if e.graph is not None]

    def calls(st):
        return {k: st.get(f'decode.rest_graph.{k}', {}).get('calls', 0)
                for k in ('eager', 'capture', 'replay')}

    def failed():
        bad = [repr(e.error) for e in tp._REST_GRAPHS._entries.values()
               if e.error is not None]
        if bad:
            raise AssertionError(f'captures failed: {bad}')

    fresh()
    trace.reset()
    trace.enable()
    try:
        bursts = {}
        for name in ('gray8_2k_rev53', 'rgb8_2k_97ict'):
            n = BURST if name.startswith('gray') else 1
            a = config_streams(name, dev, 2147483659, max(n, 2))
            b = a[n - 1::-1] if n > 1 else a[1:]
            a = a[:n]
            bursts[name] = (a, b)
            pa, pb = plan(a), plan(b)
            want = {id(a): eager(a), id(b): eager(b)}
            vd = VideoDecoder(device=dev, to_device=True)
            for k, s in enumerate((a, b, a, b)):
                vd.submit(s)
                equal(vd.collect_on_device(), want[id(s)], f'{name} burst {k}')
            vd.drain_errors()
            vd.close()
            # the host's enqueue, eager and replayed, and what a profiler
            # sees of each on the card
            runner = tp._burst_runner(pa, n, rdev, True)
            graph = tp._REST_GRAPHS._entries[runner.rest_key].graph
            decs, _ = runner.tier1(*prepared(a)[1])
            seen = {}
            for label, fn in (('eager', runner._ops),
                              ('replay', graph.replay)):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(5):
                    fn(decs)
                host_ms = (time.perf_counter() - t0) / 5 * 1e3
                torch.cuda.synchronize(dev)
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    fn(decs)
                    torch.cuda.synchronize(dev)
                ev = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
                seen[label] = dict(host_ms=host_ms, kernels=len(ev),
                                   device_ms=sum(e.device_time_total
                                                 for e in ev) / 1e3)
            emit('rest_graph_geometry', config=name, frames=n,
                 bit_equal_bursts=4, runner_keys_of_a_b=len({pa.key,
                                                             pb.key}),
                 pool_bytes=graph.nbytes,
                 **{f'{k}_{m}': v for k, d in seen.items()
                    for m, v in d.items()}, card=card_id)

        # the video decoder's five modes on the gray geometry
        a, b = bursts['gray8_2k_rev53']
        for label, kw, depth in (
                ('raw', dict(raw=True), 2), ('dense', dict(raw=False), 2),
                ('to_device', dict(to_device=True), 2),
                ('all_in_flight', dict(to_device=True), 4),
                ('pageable', dict(to_device=True, stage_uploads=False), 2)):
            raw = kw.get('raw', True)
            want = {id(a): eager(a, raw), id(b): eager(b, raw)}
            vd = VideoDecoder(device=dev, **kw)
            order = (a, b, a, b)
            if kw.get('to_device'):
                got = in_flight(vd, order, vd.collect_on_device, depth)
                vd.drain_errors()
            else:
                got = frames_host(in_flight(vd, order, vd.collect, depth))
            vd.close()
            for k, (g, s) in enumerate(zip(got, order)):
                equal(g, want[id(s)], f'video {label} burst {k}')
            emit('rest_graph_video', mode=label, bursts=len(order),
                 bit_equal=True)

        # two decoders, two streams and two threads, one graph
        want = {id(a): eager(a), id(b): eager(b)}
        errors, got = [], {}

        def drive(k):
            try:
                vd = VideoDecoder(device=dev, to_device=True)
                order = [(a, b)[(k + i) % 2] for i in range(8)]
                outs = in_flight(vd, order, vd.collect_on_device, 3)
                vd.drain_errors()
                torch.cuda.current_stream(dev).synchronize()
                vd.close()
                got[k] = list(zip(order, outs))
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for k, pairs in got.items():
            for i, (s, o) in enumerate(pairs):
                equal(o, want[id(s)], f'decoder {k} burst {i}')
        emit('rest_graph_shared', decoders=2, bursts_each=8, in_flight=3,
             bit_equal=True)

        # a MosaicDecoder pass, three times: eager, capture, replay
        data = open(os.path.join(TESTDATA, 'mosaic_rgb_320x256_rct_t128.j2c'),
                    'rb').read()
        first = MosaicDecoder(data).decode()
        for k in range(2):
            again = MosaicDecoder(data).decode()
            if not all(np.array_equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f'mosaic pass {k + 2} differs from the '
                                     f'eager pass')
        emit('rest_graph_mosaic', passes=3, bit_equal=True)
    finally:
        trace.disable()
    st = trace.get_stats()
    trace.reset()
    failed()
    n = calls(st)
    emit('rest_graph', calls=n,
         capture_ms_per_graph=st.get('decode.rest_graph.capture', {})
         .get('ms_per_call'),
         graphs=len(graphs()), pool_bytes=[g.nbytes for g in graphs()],
         budget_bytes=tp._RestGraph.budget(rdev),
         peak_bytes=torch.cuda.max_memory_allocated(dev),
         peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
         card=card_id)

    # sequences that do not loop, decoded as the benchmark cells do
    for name, frames, burst, depth in (('gray8_2k_rev53', 128, BURST, 2),
                                       ('rgb8_2k_97ict', 48, 1, 1)):
        streams = config_streams(name, dev, 2147483677, frames)
        seq = [streams[i:i + burst] for i in range(0, frames, burst)]
        runner_keys = {plan(s).key for s in seq}
        fresh()
        trace.reset()
        trace.enable()
        try:
            vd = VideoDecoder(device=dev, to_device=True)
            in_flight(vd, seq, vd.collect_on_device, depth)
            vd.drain_errors()
            vd.close()
        finally:
            trace.disable()
        st = trace.get_stats()
        trace.reset()
        failed()
        n = calls(st)
        rest = st['decode.dispatch.rest']['calls']
        with tp._RUNNERS._lock:
            rest_keys = {r.rest_key for r in tp._RUNNERS._entries.values()}
        emit('rest_graph_sequence', config=name, frames=frames,
             bursts=len(seq), runner_keys=len(runner_keys),
             graph_keys=len(rest_keys), calls=n,
             replayed_share=max(0, n['replay'] - n['capture']) / rest,
             runner_misses=st.get('decode.compile', {}).get('calls', 0),
             pool_bytes=[g.nbytes for g in graphs()],
             peak_bytes=torch.cuda.max_memory_allocated(dev),
             peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
             card=card_id)
    fresh()
    emit('rest_graph_phase', seconds=time.perf_counter() - t_phase,
         card=card_id)


def main() -> int:
    import argparse
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--against', metavar='SRC',
                    help='only time the decode kernel built from SRC (same '
                         'C interface) against this checkout\'s')
    ap.add_argument('--against-encode', metavar='SRC',
                    help='only time the encode kernel built from SRC (same '
                         'C interface) against this checkout\'s')
    ap.add_argument('--against-refine', metavar='SRC',
                    help='only time the refinement kernel built from SRC '
                         '(same decode entries) against this checkout\'s')
    ap.add_argument('--against-refine-encode', metavar='SRC',
                    help='only time the refinement-pass encoder built from '
                         'SRC (same C interface) against this checkout\'s')
    ap.add_argument('--mosaic-100k', action='store_true',
                    help='also run the 100000x100000 mosaic (9,604 tiles, '
                         '~1.3 GB streamed to a file) in the mosaic_scale '
                         'phase')
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run',
              file=sys.stderr)
        return 1
    from openjph_tpu_torch.gpu import block_decode_cuda as K
    from openjph_tpu_torch.gpu import block_encode_cuda as E
    from openjph_tpu_torch.gpu import block_refine_cuda as R
    from openjph_tpu_torch.gpu import block_refine_encode_cuda as R5
    from openjph_tpu_torch.gpu.encode_pipeline import encode_gpu
    from openjph_tpu_torch.gpu.pipeline import decode_gpu

    card_id = card()
    print(card_id, flush=True)
    dev = torch.device('cuda', 0)
    if opts.against:
        against(opts.against, dev, card_id)
        return 0
    if opts.against_encode:
        against_encode(opts.against_encode, dev, card_id)
        return 0
    if opts.against_refine:
        against_refine(opts.against_refine, dev, card_id)
        return 0
    if opts.against_refine_encode:
        against_refine_encode(opts.against_refine_encode, dev, card_id)
        return 0
    build_s, per_lib = build_all()
    emit('setup', card=card_id, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_s=build_s, build_s_per_library=per_lib)

    gray = open(GRAY, 'rb').read()
    gray_ref = np.load(GRAY_NPY)
    rgb = open(RGB, 'rb').read()

    # 1. the kernel against its plain version, every lane of the frame
    kernels = kernel_vs_plain(gray, dev, 'gray_2048x1080_rev', card_id)
    # ... on codeblocks wider and taller than 64, and on damaged lanes
    shapes_vs_plain(dev, card_id)
    corrupted_vs_plain(gray, dev, card_id)

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
    launches = launch_counts(K)
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
    # gray frame's, the RGB 9/7 frame's and the 12-bit frame's group
    # batches.  The RGB input is the port's card decode of
    # rgb_2048x1080_97.j2c (8-bit planes).
    rgb_planes = [a.astype(np.int32) for a in out]
    kernels['ht_cleanup_encode'] = k3_vs_plain(
        [gray_ref], dev, 'gray_2048x1080', card_id, sweep=True,
        reversible=True)
    k3_vs_plain(rgb_planes, dev, 'rgb_2048x1080_97_ict', card_id,
                sweep=True, reversible=False)
    frame12 = np.random.RandomState(12).randint(0, 4096, NOISE12) \
        .astype(np.int32)
    k3_vs_plain([frame12], dev, 'noise12_2047x1079', card_id,
                reversible=True, bit_depth=12)
    # ... and 10 columns narrower: edge codeblocks 58, 61 and 62 wide, an
    # odd number of quads a row (2047's edge codeblocks are 63 wide, 32
    # quads)
    k3_vs_plain([np.ascontiguousarray(frame12[:, :NOISE12[1] - 10])], dev,
                'noise12_2037x1079', card_id, reversible=True, bit_depth=12)

    # references for the RGB and 12-bit encodes: the port's own CPU
    # encode (plain versions of every stage); it launches no kernel
    t0 = time.perf_counter()
    rgb_enc_cpu = encode_gpu(rgb_planes, device='cpu', reversible=False)
    rgb_enc_cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc12_cpu = encode_gpu(frame12, device='cpu', reversible=True,
                           bit_depth=12)
    enc12_cpu_s = time.perf_counter() - t0

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
    enc12 = encode_gpu(frame12, device='cuda', reversible=True,
                       bit_depth=12)
    if enc12 != enc12_cpu:
        raise AssertionError('12-bit frame encode differs from the CPU '
                             'encode')
    streams, _ = encode_frames([gray_ref] * BURST, dev)
    if any(st != gray_j2c for st in streams):
        raise AssertionError('an 8-frame burst stream differs from the '
                             'single-frame stream')
    enc_launches = launch_counts(E)
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
    back = decode_gpu(enc12, device='cuda')
    if len(back) != 1 or not np.array_equal(back[0], frame12):
        raise AssertionError('the 12-bit encode does not decode to the '
                             'frame')
    emit('e2e_encode_noise12', shape=list(frame12.shape), bytes=len(enc12),
         equal_to_cpu=True, decodes_to_source=True,
         cpu_reference_s=enc12_cpu_s)
    emit('encode_burst', frames=BURST, equal_to_single=True)
    emit('encode_path_launches', **enc_launches)

    # 6. encode stage times, one frame and a burst (median of the runs)
    for n in (1, BURST):
        med, p75 = timed(lambda: encode_frames([gray_ref] * n, dev), 40)
        emit('encode_timing', frames=n, runs=40, median_ms=med,
             total_p75_ms=p75, mp_per_s=n * mp / (med['total'] / 1e3),
             card=card_id)

    # 7. the refinement kernel against its plain version, every lane of
    # both multi-pass streams and of seeded synthetic batches; the
    # cleanup and refinement kernels against the scalar decoder
    gray3 = open(GRAY3, 'rb').read()
    causal2 = open(CAUSAL2, 'rb').read()
    k4_vs_plain(gray3, dev, 'gray_2048x1080_rev_p3', card_id, rows=kernels)
    k4_vs_plain(causal2, dev, 'gray_512x256_rev_p2_causal', card_id)
    k4_synthetic(dev, card_id)
    # ... and on launches large enough (over 16 codeblocks an SM) that a
    # block's SigProp chains share its first warp: odd shapes, forced
    # gates and chains of every length side by side in that warp
    k4_synthetic(dev, card_id, lanes=9 * 256, shapes=((64, 64), (62, 33),
                                                      (13, 7)),
                 seed=5, packed=True)
    # ... and on lanes whose cleanup makes a padding sample significant
    # (the fused semantics: significance from the samples inside the block)
    k4_padding_lanes(dev, card_id)

    # references of the multi-pass streams: the port's own CPU decode
    # (plain versions of every stage); it launches no kernel
    refs = {}
    for name, data in (('gray_2048x1080_rev_p3', gray3),
                       ('gray_512x256_rev_p2_causal', causal2)):
        t0 = time.perf_counter()
        refs[name] = decode_gpu(data, device='cpu', raw=False)
        refs[name + '_s'] = time.perf_counter() - t0

    # 8. the multi-pass decode path, counted: every launch from here to
    # the reading below is its own
    K.reset_launches()
    R.reset_launches()
    for name, data in (('gray_2048x1080_rev_p3', gray3),
                       ('gray_512x256_rev_p2_causal', causal2)):
        ref = refs[name]
        for raw in (True, False):
            out = decode_gpu(data, device='cuda', raw=raw)
            if len(out) != len(ref) or not all(
                    np.array_equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f'{name} differs from the CPU decode '
                                     f'(raw={raw})')
            emit('e2e_multipass', stream=name, raw=raw,
                 bit_exact_vs_cpu=True, shape=list(out[0].shape),
                 cpu_reference_s=refs[name + '_s'])
    outs, _ = decode_frames([gray3] * BURST, dev)
    ref_t = torch.from_numpy(
        refs['gray_2048x1080_rev_p3'][0].astype(np.uint8)).to(dev)
    frames = outs[0][0]
    if tuple(frames.shape) != (BURST,) + tuple(ref_t.shape) or any(
            not torch.equal(frames[f], ref_t) for f in range(BURST)):
        raise AssertionError('a frame of the 3-pass burst differs')
    emit('burst_multipass', frames=BURST, bit_exact_vs_cpu=True)
    mp_launches = launch_counts(K, R)
    for k, v in mp_launches.items():
        if v == 0:
            raise AssertionError(f'{k} was not launched on the multi-pass '
                                 f'decode path')
    for k in launch_counts(R):
        kernels[k]['launches'] = mp_launches[k]
    emit('multipass_path_launches', **mp_launches)

    # 9. multi-pass stage times, one frame and a burst (median of the runs)
    for n in (1, BURST):
        med, p75 = timed(lambda: decode_frames([gray3] * n, dev), 40)
        emit('timing_multipass', frames=n, runs=40, median_ms=med,
             total_p75_ms=p75, mp_per_s=n * mp / (med['total'] / 1e3),
             card=card_id)

    # 9a. multi-pass encode (ROADMAP 12): K5 and K3 held, the multi-pass
    # encode paths counted, then timed in turns with the 1-pass encode
    multipass_encode_phase(gray_ref, refs['gray_2048x1080_rev_p3'],
                           rgb_planes, dev, kernels, K, E, R, R5, card_id)

    # 9b. codeblocks of more than 30 bit planes: the 64-bit kernels held,
    # the wide paths counted, then timed in turns with the 8-bit frame
    wide_phase(gray, gray_ref, dev, kernels, K, E, R, card_id)

    # 10. damaged streams, counted: cuts and a detected flip of the gray
    # frame and of the 3-pass frame, cuts of the causal stream
    resilient_phase((('gray_2048x1080_rev', gray, 7),
                     ('gray_2048x1080_rev_p3', gray3, 8)), dev, kernels, K,
                    R)
    # ... and the resilient decode of the gray frame's 3/4 cut, timed
    cut = gray[:len(gray) * 3 // 4]
    med, p75 = timed(lambda: decode_frames([cut], dev, resilient=True), 10)
    emit('timing_resilient', stream='gray_2048x1080_rev', case='cut_3_of_4',
         frames=1, runs=10, median_ms=med, total_p75_ms=p75,
         mp_per_s=mp / (med['total'] / 1e3), card=card_id)

    # 11. Part-2 DFS encode, counted, then timed
    dfs_phase(gray_ref, dev, kernels, K, E)
    med, p75 = timed(lambda: encode_frames([gray_ref], dev,
                                           make=dfs_encoder), 10)
    emit('timing_dfs_encode', levels=list(DFS_TYPES), frames=1, runs=10,
         median_ms=med, total_p75_ms=p75,
         mp_per_s=mp / (med['total'] / 1e3), card=card_id)

    # 12. video: the burst coders on distinct frames, counted, then timed
    # against the sequential per-burst path
    t0 = time.perf_counter()
    streams = video_phase(gray, gray_ref, gray3,
                          refs['gray_2048x1080_rev_p3'], dev, kernels, K, E,
                          R)
    video_timing(streams, gray_ref, dev, card_id)
    emit('video_phase_s', seconds=time.perf_counter() - t0)

    # 13. the CLI apps, the stream receiver and tracing, each counted
    t0 = time.perf_counter()
    apps_phase(gray, gray_ref, gray3, rgb, dev, kernels, K, E, R, card_id)
    emit('apps_phase_s', seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    stream_phase(streams, gray_ref, dev, kernels, K, R, card_id)
    emit('stream_phase_s', seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    trace_phase(gray, gray_ref, gray3, streams, dev, kernels, K, E, R,
                card_id)
    emit('trace_phase_s', seconds=time.perf_counter() - t0)

    # 14. mosaics and scale-out, each counted: the fixtures through the
    # mosaic coders and decode_blocks_sharded; BASELINE config 5 at 8K and
    # 32K; the sharded DWT and the frame fan-out in two processes
    mosaic_phase(dev, kernels, K, E, R, R5, card_id)
    mosaic_scale_phase(dev, kernels, K, E, R, card_id,
                       with_100k=opts.mosaic_100k)
    t0 = time.perf_counter()
    parallel_phase(card_id)
    multihost_phase(kernels, card_id)
    emit('scale_out_phase_s', seconds=time.perf_counter() - t0)

    # 15. the fuzz harnesses over the OpenJPH corpus and mutated streams,
    # and the entry point, each counted
    fuzz_phase(gray, dev, kernels, K, E, R, card_id)
    entry_phase(dev, kernels, K, E, card_id)

    # 16. the upload A/B tool: VideoDecoder's upload strategies in turns
    ab_upload_phase(dev, kernels, K, E, card_id)

    # 17. the rest of graph replayed from its CUDA graph against its
    # eager launches
    rest_graph_phase(dev, card_id)

    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
