"""Per-stage timers and the device profiler hook.

- ``stage('name')``: context manager accumulating wall time and a call
  count per pipeline stage, under the JAX package's stage names
  (``decode.plan``, ``encode.t2``, ...; PERF.md section 3 lists them).
  When tracing is disabled a stage is one branch; when it is enabled a
  stage is also a ``torch.profiler.record_function`` range, so a
  profile shows the stages on the host's timeline.  Stats are safe
  across threads via a lock (the video coders time stages from their
  workers); stages may nest.
- ``enable()/disable()/reset()/get_stats()/report()``: collector
  control.
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
import os
import threading
import time
from typing import Dict, Optional, TextIO

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_lock = threading.Lock()
_enabled = False
_stats: Dict[str, list] = {}  # name -> [total_seconds, calls]


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _stats.clear()


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage.  Cheap no-op unless tracing is enabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats.setdefault(name, [0.0, 0])
            s[0] += dt
            s[1] += 1


def get_stats() -> Dict[str, dict]:
    """{stage: {'seconds': float, 'calls': int, 'ms_per_call': float}}."""
    with _lock:
        return {k: {'seconds': v[0], 'calls': v[1],
                    'ms_per_call': 1e3 * v[0] / max(v[1], 1)}
                for k, v in _stats.items()}


def report(stream: Optional[TextIO] = None) -> str:
    """Human-readable stage table; also returned as a string."""
    rows = sorted(get_stats().items(), key=lambda kv: -kv[1]['seconds'])
    w = max([len(k) for k, _ in rows], default=5)
    lines = [f'{"stage".ljust(w)}  {"total_s":>9}  {"calls":>7}  '
             f'{"ms/call":>9}']
    for k, v in rows:
        lines.append(f'{k.ljust(w)}  {v["seconds"]:9.4f}  '
                     f'{v["calls"]:7d}  {v["ms_per_call"]:9.3f}')
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
