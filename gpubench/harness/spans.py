"""What the readers of the port's burst spans share: stages of the
decode path per frame, and their share of the slowest bursts, from
``trace.get_stats()`` of the window (``cell.Record.stages``).

A program that records bursts closes one ``decode.burst`` span a burst
collected, so a traced window of it always has that stage.  Where it
does, a stage that never ran reads 0.0 (a cache that never missed);
where it does not (an untraced run, or a program without burst spans),
the readers return None and the harness leaves the metric out."""
from __future__ import annotations

from typing import Optional

BURST = 'decode.burst'


def span_ms_per_frame(rec, *stages: str,
                      key: str = 'seconds') -> Optional[float]:
    """The ``stages``' seconds over the window (``key='burst_seconds'``:
    only those under the bursts it closed), summed, over the frames
    collected in it, in ms."""
    st = rec.stages
    if not st or BURST not in st or rec.loop.frames <= 0:
        return None
    return 1e3 * sum(st[s][key] for s in stages if s in st) \
        / rec.loop.frames


def tail_ms(rec, stage: str) -> Optional[float]:
    """``stage``'s mean ms a burst over the bursts at or above the 95th
    percentile of ``decode.burst`` (the program's ``tail_seconds``;
    absent below its least count of bursts)."""
    st = rec.stages
    if not st or 'tail_seconds' not in st.get(BURST, {}):
        return None
    return 1e3 * st.get(stage, {}).get('tail_seconds', 0.0)
