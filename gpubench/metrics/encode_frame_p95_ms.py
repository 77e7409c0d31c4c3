"""encode_frame_p95_ms: the 95th percentile, over every frame of the
window, of the time from its submit to its result (a burst's latency
counts for each of its frames)."""
import numpy as np


def read(rec, metric):
    lat = rec.loop.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
