"""decode.tail_dispatch_ms: the port's stage `decode.dispatch`, mean
milliseconds a burst over the slowest 5% of the window's bursts (its
`tail_seconds`: bursts whose `decode.burst` span, submit to collect,
is at or above its 95th percentile)."""
from gpubench.harness.spans import tail_ms


def read(rec, metric):
    return tail_ms(rec, 'decode.dispatch')
