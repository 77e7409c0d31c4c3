"""decode.rest_device_ms: device time a frame of the decode's kernels
other than Tier-1 (K1/K2, namespace ojk::; K4, ojr::) and other than
copies and sets: the rest of graph (_Runner.rest: placement,
dequantization, inverse DWT, RCT/ICT, conversion) and the masking."""
from gpubench.harness.readers import kernel_s_per_frame

TIER1 = ('ojk::', 'ojr::')


def read(rec, metric):
    t = kernel_s_per_frame(rec, lambda n: not any(k in n for k in TIER1))
    return None if t is None else t * 1e3
