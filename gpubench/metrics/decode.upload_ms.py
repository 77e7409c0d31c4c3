"""decode.upload_ms: the port's stage `decode.dispatch.upload`, the staged
upload inside the dispatch (its host block on a staging slot,
`decode.upload.slot_wait`, inside), in milliseconds a frame collected
in the traced window."""
from gpubench.harness.spans import span_ms_per_frame


def read(rec, metric):
    return span_ms_per_frame(rec, 'decode.dispatch.upload')
