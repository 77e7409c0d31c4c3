"""decode.host_prep_ms: the port's stage `decode.host_prep` (host clock, on the thread that
runs it) in milliseconds a frame over the traced window."""
from gpubench.harness.readers import stage_ms_per_frame


def read(rec, metric):
    return stage_ms_per_frame(rec, 'decode.host_prep')
