"""One run of one cell: inputs from the seed, the coder and its warm-up
(set-up), the measured window, then, with the window closed, the
device's peak memory, the correctness check against the reference, and
the metrics."""
from __future__ import annotations

import functools
import gc
import importlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..inputs.frames import rng_for
from ..inputs.streams import ring_inputs
from ..reference import compare
from . import metrics as metric_readers
from .coders import CODERS, trace_module
from .manifest import ROOT, Cell
from .profiling import Stretch, Window, warm_profiler
from .result import check_lines, checks_pass, result_line
from .roofline import Workload

TRACE_PATH = os.path.join(ROOT, 'build', 'gpubench', 'trace',
                          'stretch.json.gz')
PROFILE_SECONDS = 2.0   # the traced stretch: at most this, mid-window
WARM_SECONDS = 3.0      # the loop run before the window, in set-up


@dataclass
class Record:
    """What the metric readers read."""
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    loop: object                      # loops' LoopRecord
    mpix: float                       # megapixels a frame
    stages: Optional[dict] = None     # trace.get_stats() of the window
    window: Optional[Window] = None   # the profiled stretch
    workload: Optional[Workload] = None


@dataclass
class Outcome:
    line: str
    check_lines: list
    correct: bool


def power_limit_w(device) -> Optional[float]:
    """The card's power limit (nvidia-smi), or None where unread."""
    idx = torch.device(device).index or 0
    try:
        r = subprocess.run(['nvidia-smi', '-i', str(idx), '--query-gpu=' +
                            'power.limit', '--format=csv,noheader,nounits'],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device='cuda', t_start: Optional[float] = None,
             log=lambda m: print(m, file=sys.stderr, flush=True)
             ) -> Outcome:
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, trf = cell.config, cell.traffic
    direction = trf['direction']
    dev = torch.device(device)
    # set-up: the inputs from the seed, the coder, every burst warmed
    marks = [('start', t_start), ('imports', time.perf_counter())]
    ring = ring_inputs(cfg, seed, trf['ring'], direction)
    marks.append(('inputs', time.perf_counter()))
    coder = CODERS[direction](cfg, dev, ring)
    loop = importlib.import_module(f'gpubench.loops.{trf["loop"]}')
    bursts = loop.bursts_of(trf)

    def warm_pass():
        for slots in bursts:
            coder.submit(slots)
            coder.collect(True)
        coder.finish()

    warm_pass()
    marks.append(('first_pass', time.perf_counter()))
    # a steady stretch of the loop itself, discarded: the host's
    # allocators and caches reach the state the window runs in
    loop.run(coder, trf, WARM_SECONDS, rng_for(seed, 'warm'))
    marks.append(('warm_loop', time.perf_counter()))
    trace = trace_module()
    stretch = None
    if traced and dev.type == 'cuda':
        warm_profiler(dev, warm_pass)
        marks.append(('profiler_warm', time.perf_counter()))
        span = min(PROFILE_SECONDS, seconds / 3)
        stretch = Stretch(time.perf_counter() + (seconds - span) / 2, span,
                          TRACE_PATH, dev)
    if traced:
        trace.reset()
        trace.enable()
    gc.collect()  # every window starts with the collector's counts at 0
    setup_s = time.perf_counter() - t_start
    log('setup ' + ', '.join(f'{n} {b - a:.3f}' for (_, a), (n, b)
                             in zip(marks, marks[1:])) + ' s')
    log(f'setup {setup_s:.3f} s; window {seconds} s')
    gcs = []
    t_gc = [0.0]

    def on_gc(phase, info):
        if phase == 'start':
            t_gc[0] = time.perf_counter()
        else:
            gcs.append((info['generation'],
                        round((time.perf_counter() - t_gc[0]) * 1e3, 3)))
    gc.callbacks.append(on_gc)
    try:
        rec = loop.run(coder, trf, seconds, rng_for(seed, 'kept'), stretch)
    finally:
        gc.callbacks.remove(on_gc)
        if traced:
            trace.disable()
    gcs = {g: [sum(1 for h, _ in gcs if h == g),
               sum(ms for h, ms in gcs if h == g)] for g in (0, 1, 2)}
    stages = trace.get_stats() if traced else None
    # the window has closed: the device's peak, then the outputs kept
    # for the check read back, and the program's state freed
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    kept = [(slots, coder.to_host(outs)) for slots, outs in rec.kept]
    rec.kept = []
    coder.close()
    del coder
    window = stretch.read() if stretch is not None else None
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    log(f'window {rec.window_s:.3f} s, {rec.frames} frames, '
        f'{rec.failed} failed; checking {sum(len(s) for s, _ in kept)} '
        f'kept frames')
    t_check = time.perf_counter()
    expected = functools.lru_cache(maxsize=None)(
        compare.expected_fn(direction, cfg, ring))
    checks = compare.check(direction, cfg['limits'][direction], expected,
                           kept, rec.failed)
    correct = checks_pass(checks) and rec.attempted > 0
    log(f'check {time.perf_counter() - t_check:.3f} s')
    record = Record(cfg, trf, seconds, setup_s, rec,
                    cfg['width'] * cfg['height'] / 1e6, stages, window)
    notes = {}
    if traced:
        record.workload = Workload(
            (lambda s: ring[s]) if direction == 'decode' else expected,
            trf['ring'])
    metrics = metric_readers.compute(
        cell.per_layer if traced else cell.end_to_end, record)
    if traced:  # the tracing's cost: the same metrics, traced
        notes['end_to_end_traced'] = metric_readers.compute(
            cell.end_to_end, record)
    devinfo = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
               'kind': (torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else 'cpu'),
               'count': cell.chips, 'memory_peak_bytes': int(peak)}
    breakdown = None
    if traced and window is not None:
        devinfo['busy_s'] = window.busy_s
        devinfo['window_s'] = window.span_s
        breakdown = {'device_ops': window.top_ops,
                     'idle_gaps': window.idle_gaps}
        notes['profiled_frames'] = window.frames
        wl = record.workload
        notes['k2_bytes_per_frame'] = (wl.k2_bytes_per_frame()
                                       if direction == 'decode' else None)
        notes['k3_bytes_per_frame'] = (wl.k3_bytes_per_frame()
                                       if direction == 'encode' else None)
    if dev.type == 'cuda':
        notes['power_limit_w'] = power_limit_w(dev)
    notes['frames_by_second'] = [
        sum(1 for t in rec.done_at_s if i <= t < i + 1) * trf['burst']
        for i in range(int(rec.window_s) + 1)]
    notes['gc'] = gcs
    if rec.errors:
        notes['errors'] = rec.errors[:5]
    return Outcome(result_line(correct, rec.attempted, rec.failed, metrics,
                               devinfo, checks, breakdown, notes),
                   check_lines(checks), correct)
