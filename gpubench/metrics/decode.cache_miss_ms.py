"""decode.cache_miss_ms: the port's stages `decode.compile` (a burst runner
built on a cache miss) and `decode.staging_alloc` (a pinned staging
buffer allocated), in milliseconds a frame collected in the traced
window: 0 when the decode is steady."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'decode.compile', 'decode.staging_alloc')
