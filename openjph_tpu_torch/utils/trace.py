"""Per-stage timers, burst spans, collector pauses and the device
profiler hook.

- ``stage('name')``: context manager accumulating wall time and a call
  count per pipeline stage, under the JAX package's stage names
  (``decode.plan``, ``encode.t2``, ...; PERF.md section 3 lists them).
  When tracing is disabled a stage is one branch; when it is enabled a
  stage is also a ``torch.profiler.record_function`` range, so a
  profile shows the stages on the host's timeline.  Stages nest: a
  stack per thread gives each stage its parent (the enclosing stage on
  the same thread), and a stage's self time is its time less the time
  of its child stages.  Stats are safe across threads via a lock (the
  video coders time stages from their workers).
- ``add(name, seconds)``: records a stage whose start was taken on
  another thread, a wait that no thread spends working; it has no
  parent and no range.
- Bursts: ``open_burst(name)`` (at a submit) returns a burst, or None
  while tracing is disabled; the stages run inside ``burst(b)`` are
  also summed under it; ``since(b, name)`` records the wait from its
  open to now; ``close_burst(b)`` records the burst's own span under
  its ``name`` and keeps one row of it (its span and its stages) in a
  table of the last ``BURST_ROWS`` bursts closed while tracing was on.
  Every call takes None and does nothing with it.  ``burst_stage(name)``
  is a stage only inside a burst's context: a stage of the decode path
  in code that other paths share (the staging ring).
- Collector pauses: while tracing is enabled, a ``gc.callbacks`` hook
  records every collection as stage ``host.gc`` (and a range), on the
  thread that ran it, inside that thread's innermost stage (its parent)
  and under that thread's burst.  A collection still open at a
  ``disable()`` or ``reset()`` is dropped.
- ``enable()/disable()/reset()/get_stats()/report()``: collector
  control.  ``get_stats()`` gives each stage its ``seconds``, ``calls``,
  ``ms_per_call``, ``self_seconds``, its ``parents``, ``burst_seconds``
  (its seconds under the bursts of the table) and, once at least
  ``TAIL_MIN_BURSTS`` bursts have closed, ``tail_seconds``: the stage's
  mean seconds a burst over the bursts whose span is at or above the
  95th percentile of the table's.
- ``torch_trace(dir)``: runs ``torch.profiler`` around a region (host
  ops, and CUDA kernels, copies and sets on a CUDA device), writes a
  Chrome trace into ``dir`` and yields the profiler for
  ``key_averages()`` / ``events()``.

A stage never synchronises the device.  It times what its region
already waits for: a stage around enqueued device work without a sync
inside measures the enqueue only, so the pipelines time their device
stages around the region that fetches the results.
"""
from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from collections import deque
from typing import Dict, Optional, TextIO

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

BURST_ROWS = 8192        # closed bursts kept for the tail attribution
TAIL_MIN_BURSTS = 20     # fewer closed bursts give no tail_seconds
TAIL_PERCENTILE = 95.0

# reentrant: a collection may run, and its hook record, between any two
# bytecodes of a thread that holds the lock
_lock = threading.RLock()
_enabled = False
# name -> [total seconds, calls, self seconds, set of parent names]
_stats: Dict[str, list] = {}
_bursts: deque = deque(maxlen=BURST_ROWS)   # (span seconds, {stage: s})
_gen = 0     # bumped by disable() / reset(): collections open then drop
_NOOP = contextlib.nullcontext()


class _Local(threading.local):
    def __init__(self):
        self.stack = []     # the thread's open stages, innermost last
        self.burst = None   # the thread's current burst
        self.gc = None      # a collection's (generation, start, range)


_local = _Local()


def _record(name: str, dt: float, self_dt: float, parent, burst) -> None:
    with _lock:
        s = _stats.get(name)
        if s is None:
            s = _stats[name] = [0.0, 0, 0.0, set()]
        s[0] += dt
        s[1] += 1
        s[2] += self_dt
        if parent is not None:
            s[3].add(parent)
        if burst is not None and burst.stages is not None:
            burst.stages[name] = burst.stages.get(name, 0.0) + dt


class _Stage:
    """An open stage: a range, a clock and the time of its children."""
    __slots__ = ('name', 't0', 'child', 'range', 'burst')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        loc = _local
        self.burst = loc.burst
        self.child = 0.0
        self.t0 = time.perf_counter()
        loc.stack.append(self)
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(None, None, None)
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        # innermost as a rule; a stage held open by a suspended
        # generator may close out of order
        stack.remove(self)
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child += dt
        _record(self.name, dt, dt - self.child,
                None if parent is None else parent.name, self.burst)


class _Burst:
    """One burst: its span's name, its open time and its stages' seconds
    (None once closed)."""
    __slots__ = ('name', 't0', 'stages')

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.stages = {}


class _Within:
    __slots__ = ('b', 'prev')

    def __init__(self, b: _Burst):
        self.b = b

    def __enter__(self):
        self.prev = _local.burst
        _local.burst = self.b
        return self.b

    def __exit__(self, *exc):
        _local.burst = self.prev


def _on_gc(phase: str, info: dict) -> None:
    """The collector's hook (installed while tracing is enabled).  A
    collection is a leaf of the thread's stages, kept off its stack, so
    a stop lost to a ``disable()`` leaves no stage open."""
    loc = _local
    if phase == 'start':
        if loc.gc is not None:   # its stop was lost: drop it
            loc.gc[2].__exit__(None, None, None)
        rng = record_function('host.gc')
        rng.__enter__()
        loc.gc = (_gen, time.perf_counter(), rng)
    elif loc.gc is not None:
        (gen, t0, rng), loc.gc = loc.gc, None
        rng.__exit__(None, None, None)
        if gen != _gen or not _enabled:
            return
        dt = time.perf_counter() - t0
        parent = loc.stack[-1] if loc.stack else None
        if parent is not None:
            parent.child += dt
        _record('host.gc', dt, dt, None if parent is None else parent.name,
                loc.burst)


def enable() -> None:
    global _enabled
    _enabled = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable() -> None:
    global _enabled, _gen
    _enabled = False
    _gen += 1
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def reset() -> None:
    global _gen
    with _lock:
        _gen += 1
        _stats.clear()
        _bursts.clear()


def is_enabled() -> bool:
    return _enabled


def stage(name: str):
    """Time a pipeline stage.  Cheap no-op unless tracing is enabled."""
    if not _enabled:
        return _NOOP
    return _Stage(name)


def burst_stage(name: str):
    """``stage(name)`` inside a burst's context, else a no-op."""
    if not _enabled or _local.burst is None:
        return _NOOP
    return _Stage(name)


def add(name: str, seconds: float, burst: Optional[_Burst] = None) -> None:
    """Record ``seconds`` as one call of stage ``name``, whose start was
    taken on another thread: no parent, no range, under ``burst`` (the
    calling thread's burst by default)."""
    if not _enabled:
        return
    _record(name, seconds, seconds, None,
            _local.burst if burst is None else burst)


def open_burst(name: str) -> Optional[_Burst]:
    """A new burst whose span ``name`` starts now; None while tracing is
    disabled."""
    if not _enabled:
        return None
    return _Burst(name)


def burst(b: Optional[_Burst]):
    """Context: the stages of the calling thread count under ``b`` too."""
    if b is None:
        return _NOOP
    return _Within(b)


def since(b: Optional[_Burst], name: str) -> None:
    """Record stage ``name`` from ``b``'s open to now, under ``b``."""
    if b is None:
        return
    add(name, time.perf_counter() - b.t0, b)


def close_burst(b: Optional[_Burst]) -> None:
    """End ``b``'s span: record it as stage ``b.name`` and keep its row
    (while tracing is enabled)."""
    if b is None or not _enabled:
        return
    dt = time.perf_counter() - b.t0
    _record(b.name, dt, dt, None, b)
    with _lock:
        stages, b.stages = b.stages, None
        if stages is not None:
            _bursts.append((dt, stages))


def get_stats() -> Dict[str, dict]:
    """{stage: {'seconds', 'calls', 'ms_per_call', 'self_seconds',
    'parents', 'burst_seconds'[, 'tail_seconds']}}."""
    with _lock:
        items = [(k, v[0], v[1], v[2], sorted(v[3]))
                 for k, v in list(_stats.items())]
        rows = list(_bursts)
    tail = None
    if len(rows) >= TAIL_MIN_BURSTS:
        cut = np.percentile([d for d, _ in rows], TAIL_PERCENTILE)
        tail = [st for d, st in rows if d >= cut]
    out = {}
    for k, sec, calls, self_s, parents in items:
        e = {'seconds': sec, 'calls': calls,
             'ms_per_call': 1e3 * sec / max(calls, 1),
             'self_seconds': self_s, 'parents': parents,
             'burst_seconds': sum(st.get(k, 0.0) for _, st in rows)}
        if tail:
            e['tail_seconds'] = sum(st.get(k, 0.0) for st in tail) / len(tail)
        out[k] = e
    return out


def report(stream: Optional[TextIO] = None) -> str:
    """Human-readable stage table; also returned as a string."""
    rows = sorted(get_stats().items(), key=lambda kv: -kv[1]['seconds'])
    w = max([len(k) for k, _ in rows], default=5)
    lines = [f'{"stage".ljust(w)}  {"total_s":>9}  {"self_s":>9}  '
             f'{"calls":>7}  {"ms/call":>9}']
    for k, v in rows:
        lines.append(f'{k.ljust(w)}  {v["seconds"]:9.4f}  '
                     f'{v["self_seconds"]:9.4f}  {v["calls"]:7d}  '
                     f'{v["ms_per_call"]:9.3f}')
    out = '\n'.join(lines)
    if stream is not None:
        stream.write(out + '\n')
    return out


@contextlib.contextmanager
def torch_trace(log_dir: str, device='cuda', name: str = 'trace'):
    """Profile the region with ``torch.profiler``: host ops of every
    thread (the video coders' workers too), and on a CUDA ``device`` the
    card's kernels, copies and sets.  Writes the Chrome trace
    ``<log_dir>/<name>.json`` on exit and yields the profiler
    (``key_averages()``, ``events()``).  Device work the region enqueues
    but does not wait for may fall outside the trace: end the region
    with a synchronise."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # an experimental option of torch.profiler (private module): without
    # it only the calling thread's host ops are recorded
    from torch._C._profiler import _ExperimentalConfig
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=cfg) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f'{name}.json'))
