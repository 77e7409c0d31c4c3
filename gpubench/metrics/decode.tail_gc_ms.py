"""decode.tail_gc_ms: the port's stage `host.gc`, mean milliseconds a burst
over the slowest 5% of the window's bursts (its `tail_seconds`:
bursts whose `decode.burst` span, submit to collect, is at or above
its 95th percentile): collections run under a burst, on any thread."""
from gpubench.harness.spans import tail_ms


def read(rec, metric):
    return tail_ms(rec, 'host.gc')
