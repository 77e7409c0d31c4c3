"""The traced run's profiled stretch: ``torch.profiler`` over a short
steady stretch in the middle of the window, written gzipped inside the
checkout, read and deleted.

``device_windows`` and ``window_report`` are frozen copies of
chip_smoke.py's (the busy intervals of the card inside the 'window'
range; the top device ops; the longest idle gaps with the host ranges
open at each), changed to return the whole list of device events and
the gaps' host ranges as one name each.
"""
from __future__ import annotations

import gzip
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_windows(events):
    """(window start, end) of the profiled region (its 'window' range)
    and the merged busy intervals of the card's kernels, copies and sets
    inside it, in trace microseconds."""
    win = [e for e in events if e.get('name') == 'window'
           and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    if len(win) != 1:
        raise ValueError(f'{len(win)} window ranges in the trace')
    w0 = float(win[0]['ts'])
    w1 = w0 + float(win[0]['dur'])
    dev = sorted((max(float(e['ts']), w0),
                  min(float(e['ts']) + float(e['dur']), w1), e['name'],
                  e['cat'])
                 for e in events
                 if e.get('cat') in DEVICE_CATS and e.get('ph') == 'X')
    dev = [d for d in dev if d[1] > d[0]]
    busy = []
    for a, b, _, _ in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return w0, w1, dev, busy


@dataclass
class Window:
    """A parsed profiled stretch (seconds)."""
    span_s: float
    busy_s: float
    frames: int                       # frames collected in the stretch
    device: List[tuple] = field(default_factory=list)  # (s, name, cat)
    top_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def seconds(self, match, cats=('kernel',)) -> float:
        """Device seconds of the events of ``cats`` whose name
        ``match(name)`` accepts."""
        return sum(s for s, n, c in self.device if c in cats and match(n))


def window_report(path: str, frames: int, top: int = 10) -> Window:
    """The profiled stretch of the gzipped Chrome trace ``path``: busy
    share, the ``top`` device ops by total time, and the ``top`` longest
    idle gaps, each named by the host ranges open at its start (the
    innermost on each thread; stages before ops)."""
    with gzip.open(path, 'rt') as f:
        doc = json.load(f)
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    w0, w1, dev, busy = device_windows(events)
    if not dev:
        raise ValueError(f'{path}: the profiler recorded no device event')
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    gaps, at = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            gaps.append((a - at, at))
        at = max(at, b)
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
        names = sorted({e['name'][:60] for e in inner.values()},
                       key=lambda n: (not n.startswith(('decode.',
                                                        'encode.')), n))
        return ' | '.join(names)[:200] or '(no host range open)'

    return Window(
        span_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        frames=frames,
        device=[((b - a) / 1e6, n, c) for a, b, n, c in dev],
        top_ops=[[n[:200], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[open_at(t), g / 1e6]
                   for g, t in sorted(gaps, reverse=True)[:top]])


def _profiler(device):
    """torch.profiler over every thread's host ops and, on a CUDA
    device, the card's kernels, copies and sets."""
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    # an experimental option of torch.profiler (private module): without
    # it only the calling thread's host ops are recorded, not the video
    # coders' workers
    from torch._C._profiler import _ExperimentalConfig
    return profile(activities=acts, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))


def warm_profiler(device, work) -> None:
    """Profile ``work()`` once and discard it: the profiler's first start
    in a process (CUPTI's set-up, seconds) then falls in set-up, not in
    the window."""
    with _profiler(torch.device(device)):
        work()


class Stretch:
    """Profiles for ``span`` seconds from the first tick at or after
    ``start_at`` (host clock), counted from when the profiler has
    started; ``read`` parses what it recorded."""

    def __init__(self, start_at: float, span: float, path: str, device):
        self.start_at, self.span = start_at, span
        self.path = path
        self.device = torch.device(device)
        self.state = 'idle'
        self.frames = 0
        self._prof = self._range = None
        self.stop_at = float('inf')

    def tick(self, now: float, frames_done: int) -> None:
        if self.state == 'idle' and now >= self.start_at:
            self._prof = _profiler(self.device)
            self._prof.__enter__()
            self._range = record_function('window')
            self._range.__enter__()
            self._f0 = frames_done
            self.stop_at = time.perf_counter() + self.span
            self.state = 'on'
        elif self.state == 'on' and now >= self.stop_at:
            self._stop(frames_done)

    def _stop(self, frames_done: int) -> None:
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.frames = frames_done - self._f0
        self.state = 'done'

    def close(self, frames_done: int) -> None:
        if self.state == 'on':
            self._stop(frames_done)

    def read(self) -> Optional[Window]:
        """The parsed stretch (None if it never started); the trace file
        is deleted once read."""
        if self.state != 'done':
            return None
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        try:
            self._prof.export_chrome_trace(self.path)
            return window_report(self.path, self.frames)
        finally:
            if os.path.exists(self.path):
                os.remove(self.path)
            self._prof = None
