"""encode.t2_ms: the port's stage `encode.t2` (host clock, on the thread that
runs it) in milliseconds a frame over the traced window."""
from gpubench.harness.readers import stage_ms_per_frame


def read(rec, metric):
    return stage_ms_per_frame(rec, 'encode.t2')
