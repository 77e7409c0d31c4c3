"""decode.rest_launch_ms: the port's stage `decode.dispatch.rest`, the host's
enqueue of the eager rest of graph (`_Runner.rest`: placement,
dequantization, inverse DWT, RCT/ICT, conversion), in milliseconds a
frame collected in the traced window."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'decode.dispatch.rest')
