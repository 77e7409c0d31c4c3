"""decode.queue_wait_ms: the port's recorded wait `decode.queue_wait`, from a
burst's submit to the start of its host prep on the prep worker, in
milliseconds a frame collected in the traced window."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'decode.queue_wait')
