"""decode.collect_wait_ms: the port's stage `decode.collect_wait`, the
caller's thread blocked in `collect` / `collect_on_device` on the
oldest burst's prep and dispatch, in milliseconds a frame collected in
the traced window."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'decode.collect_wait')
