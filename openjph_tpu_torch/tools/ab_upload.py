"""A/B the VideoDecoder upload strategies in one process (one set of
runners, one warm-up), in turns: the JAX package's tools/ab_upload.py on
the port.

- staged: ``VideoDecoder(to_device=True)``; its prep worker uploads each
  burst from a ring of pinned buffers on a side stream;
- unstaged: ``stage_uploads=False``; the prep worker uploads from
  pageable memory on the decoder's stream;
- sync: the unstaged decoder with each burst prepared (parse, plan,
  pack, upload, enqueue) on the caller's thread and handed in as a done
  future, the behaviour before submit went to a worker.

The frames are the benchmark's: 2 sets of 8 gray 2048x1080 frames
(drifting sines and film grain, seeded), encoded lossless 5/3 with the
port's ``encode`` on the same device.  A round submits 6 bursts with two
in flight, collects them with ``collect_on_device``, waits for the
device and gives decoded MP/s.

    python -m openjph_tpu_torch.tools.ab_upload [--device cuda|cpu]
"""
import argparse
import sys
import time
from concurrent.futures import Future

import numpy as np
import torch

from .. import encode
from ..gpu.pipeline import VideoDecoder, resolve_device

W, H, NFRAMES = 2048, 1080, 8
MP = W * H * NFRAMES / 1e6
ENCODE_KWARGS = dict(bit_depth=8, reversible=True, num_decomps=5,
                     block_size=(64, 64))
STRATEGIES = ('staged', 'unstaged', 'sync')
NBURST = 6          # bursts a round


def make_frames():
    """Distinct natural-ish frames: drifting 2D sines + film grain.  Two
    independent bursts so successive uploads carry different bytes (no
    transport-level dedup of repeated buffers)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rng = np.random.RandomState(42)
    sets = []
    for s in range(2):
        frames = []
        for k in range(NFRAMES):
            t = s * NFRAMES + k
            img = (127 + 60 * np.sin(xx / 97.0 + t * 0.8)
                   * np.cos(yy / 83.0 - t * 0.35)
                   + 40 * np.sin((xx + yy) / 211.0 + t)
                   + rng.normal(0, 6, (H, W)))
            frames.append(np.clip(img, 0, 255).astype(np.int32))
        sets.append(frames)
    return sets


def sync_submit(vd: VideoDecoder, streams) -> None:
    """Prepare and enqueue a burst on the caller's thread, as a done
    future in the decoder's queue."""
    f = Future()
    f.set_result(vd._prep(list(streams)))
    vd._inflight.append((f, None))


def run_once(vd: VideoDecoder, stream_sets, mp: float, submit=None):
    """Submit NBURST bursts, alternating the sets, two in flight; collect
    each on the device and wait for it.  Returns (MP/s, the last burst's
    frames)."""
    submit = submit or vd.submit
    t0 = time.perf_counter()
    submit(stream_sets[0])
    submit(stream_sets[1])
    last = None
    for i in range(NBURST - 2):
        last = vd.collect_on_device()
        submit(stream_sets[i % 2])
    while vd.depth:
        last = vd.collect_on_device()
    if vd.device.type == 'cuda':
        torch.cuda.synchronize(vd.device)
    vd.drain_errors()
    return mp * NBURST / (time.perf_counter() - t0), last


def main(frames=None, rounds: int = 3, device='cuda', log=print) -> dict:
    """Run the A/B; ``frames`` (two sets of frames of one geometry, a
    burst each) replaces the benchmark's.  Returns {'rounds': per round
    {strategy: MP/s}, 'warmup_s', 'encode_s', 'mp_per_burst',
    'last_equal': whether every strategy's last burst equals the frames
    it was coded from}."""
    dev = resolve_device(device)
    frame_sets = make_frames() if frames is None else frames
    mp = sum(f.size for f in frame_sets[0]) / 1e6
    t0 = time.perf_counter()
    stream_sets = [[encode([f], device=dev, **ENCODE_KWARGS) for f in fs]
                   for fs in frame_sets]
    encode_s = time.perf_counter() - t0
    log(f'encoded {sum(map(len, stream_sets))} frames in {encode_s:.1f}s')
    staged = VideoDecoder(to_device=True, device=dev)
    unstaged = VideoDecoder(to_device=True, stage_uploads=False, device=dev)
    try:
        t0 = time.perf_counter()
        staged.submit(stream_sets[0])
        staged.collect_on_device()
        staged.drain_errors()
        warmup_s = time.perf_counter() - t0
        log(f'warmup/compile {warmup_s:.1f}s')
        runs = {'staged': (staged, None), 'unstaged': (unstaged, None),
                'sync': (unstaged, lambda s: sync_submit(unstaged, s))}
        results, last = [], {}
        for r in range(rounds):
            log(f'-- round {r}')
            row = {}
            for name in STRATEGIES:
                vd, submit = runs[name]
                row[name], last[name] = run_once(vd, stream_sets, mp,
                                                 submit)
                log(f'  {name:<9} {row[name]:8.2f} MP/s')
            results.append(row)
        # the last burst of every round is the second set
        want = torch.from_numpy(np.stack(frame_sets[(NBURST - 1) % 2])
                                .astype(np.uint8)).to(dev)
        equal = all(torch.equal(last[k][0][0], want) for k in STRATEGIES)
    finally:
        staged.close()
        unstaged.close()
    return {'rounds': results, 'warmup_s': warmup_s, 'encode_s': encode_s,
            'mp_per_burst': mp, 'last_equal': equal}


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    res = main(device=ap.parse_args(argv).device)
    if not res['last_equal']:
        print('the strategies\' last bursts differ from their frames',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(_cli())
