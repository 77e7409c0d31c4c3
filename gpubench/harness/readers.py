"""What the metric readers (``metrics/<name>.py``) share: a stage of the
port's timers per frame, the device time of a group of kernels per
frame, a kernel's roofline share and the device's idle share, each from
the run's record (``cell.Record``), or None where the run has nothing
to read."""
from __future__ import annotations

from typing import Callable, Optional

from .roofline import least_seconds

COPIES_AND_SETS = ('gpu_memcpy', 'gpu_memset')


def stage_ms_per_frame(rec, stage: str) -> Optional[float]:
    """A stage's seconds over the window, over the frames of its calls
    (a call handles one burst), in ms."""
    s = (rec.stages or {}).get(stage)
    if not s or not s['calls']:
        return None
    return s['seconds'] * 1e3 / (s['calls'] * rec.traffic['burst'])


def kernel_s_per_frame(rec, match: Callable[[str], bool]
                       ) -> Optional[float]:
    """Device seconds of the kernels ``match`` accepts in the profiled
    stretch, over the frames collected in it (in a steady loop the
    device finishes frames as fast as they are collected)."""
    w = rec.window
    if w is None or w.frames <= 0:
        return None
    t = w.seconds(match)
    return t / w.frames if t > 0 else None


def roofline_pct(rec, match: Callable[[str], bool],
                 bytes_per_frame: Callable[[], float]) -> Optional[float]:
    """Least time at the card's HBM bandwidth for the workload's bytes,
    over the kernels' device time, per frame, in %."""
    t = kernel_s_per_frame(rec, match)
    if t is None or rec.workload is None:
        return None
    return 100.0 * least_seconds(bytes_per_frame()) / t


def idle_pct(rec) -> Optional[float]:
    """Share of the profiled stretch in which no kernel, copy or set ran
    on the device, in %."""
    w = rec.window
    if w is None or w.span_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.span_s)
