"""decode.t2_ms: the port's stage `decode.host_prep.t2`, the burst's Tier-2
(its decoders built from the codestreams) inside the host prep, in
milliseconds a frame collected in the traced window.  A program whose
host prep records no such stage has nothing to read."""
from gpubench.harness.spans import span_ms_per_frame

STAGE = 'decode.host_prep.t2'


def read(rec, metric):
    if STAGE not in (rec.stages or {}):
        return None
    return span_ms_per_frame(rec, STAGE)
