"""encode.graph_device_ms: device time a frame of the encode's kernels
other than Tier-1 (K3, namespace oje::; K5, ojre::) and other than
copies and sets: the device graph (_EncRunner.graph: widening,
conversion, RCT/ICT, forward DWT, quantization, strip gather, zero-block
flags) and the compaction of the coded words."""
from gpubench.harness.readers import kernel_s_per_frame

TIER1 = ('oje::', 'ojre::')


def read(rec, metric):
    t = kernel_s_per_frame(rec, lambda n: not any(k in n for k in TIER1))
    return None if t is None else t * 1e3
