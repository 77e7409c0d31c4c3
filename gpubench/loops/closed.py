"""The closed loop: bursts of ``burst`` ring slots, in turn over the
ring, with up to ``in_flight`` submitted and not yet collected.  The
next burst is submitted once the oldest is collected, so a slow system
receives less load.  Submission stops when ``seconds`` have passed;
the bursts in flight are collected, the coder finishes (error flags
drained, the device synchronised) and the window closes.

Traffic keys: ``burst``, ``in_flight``, ``ring`` (distinct inputs),
``sync_each`` (wait for the device after each collect: each frame's
latency then runs to its frame being complete), ``checked_bursts`` (the
size of the seeded sample of collected bursts kept for the check).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List


@dataclass
class LoopRecord:
    window_s: float = 0.0
    attempted: int = 0       # frames submitted in the window
    frames: int = 0          # frames collected
    failed: int = 0          # frames of bursts that raised
    latencies_s: List[float] = field(default_factory=list)  # per frame
    kept: List[tuple] = field(default_factory=list)  # (slots, outputs)
    done_at_s: List[float] = field(default_factory=list)  # per burst
    errors: List[str] = field(default_factory=list)


def bursts_of(traffic: dict) -> List[List[int]]:
    b, n = traffic['burst'], traffic['ring']
    if n % b:
        raise ValueError(f'a ring of {n} is not whole bursts of {b}')
    return [list(range(i, i + b)) for i in range(0, n, b)]


def run(coder, traffic: dict, seconds: float, rng, stretch=None):
    """Drive ``coder`` for ``seconds``; returns a LoopRecord.  ``rng``
    draws the kept sample (reservoir sampling over collected bursts);
    ``stretch`` (traced runs) ticks after each collect."""
    bursts = bursts_of(traffic)
    depth = traffic['in_flight']
    sync = bool(traffic.get('sync_each', False))
    keep_n = traffic['checked_bursts']
    rec = LoopRecord()
    inflight = deque()
    seen = 0
    nxt = 0
    clock = time.perf_counter
    t0 = clock()
    deadline = t0 + seconds
    while True:
        while len(inflight) < depth and clock() < deadline:
            slots = bursts[nxt % len(bursts)]
            nxt += 1
            inflight.append((slots, clock()))
            coder.submit(slots)
            rec.attempted += len(slots)
        if not inflight:
            break
        slots, ts = inflight.popleft()
        try:
            outs = coder.collect(sync)
        except Exception as exc:  # a burst that raises counts as failed
            rec.failed += len(slots)
            rec.errors.append(f'{type(exc).__name__}: {exc}'[:300])
            continue
        now = clock()
        rec.frames += len(slots)
        rec.latencies_s.extend([now - ts] * len(slots))
        rec.done_at_s.append(now - t0)
        # reservoir sampling: every collected burst equally likely kept
        if len(rec.kept) < keep_n:
            rec.kept.append((slots, outs))
        else:
            j = int(rng.integers(0, seen + 1))
            if j < keep_n:
                rec.kept[j] = (slots, outs)
        seen += 1
        if stretch is not None:
            stretch.tick(now, rec.frames)
    try:
        coder.finish()
    except Exception as exc:  # a pending error flag of a collected burst
        rec.errors.append(f'{type(exc).__name__}: {exc}'[:300])
        rec.failed += 1
    rec.window_s = clock() - t0
    if stretch is not None:
        stretch.close(rec.frames)
    return rec
