"""host.gc_pause_ms: the port's stage `host.gc`, the collections of
Python's cyclic collector that ran under a decode burst (inside its
host prep, dispatch, fetch or collect, on any thread) and closed in the
traced window (its `burst_seconds`), in milliseconds a frame collected
in the window.  Collections outside every burst, as the harness's own
before the window, are not counted."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'host.gc', key='burst_seconds')
