"""encode.k3_roofline: the HT cleanup encode kernel K3
(openjph_tpu_torch/gpu/csrc/ht_cleanup_encode.cu) as a share of its
roofline: the least time at 3.35 TB/s for the workload's bytes
(roofline.k3_bytes: 4 bytes read a sample, segments written) over K3's
device time, per frame, in the profiled stretch."""
from gpubench.harness.readers import roofline_pct

K3_NAMES = ('oje::ht_cleanup_encode_kernel<',)


def read(rec, metric):
    return roofline_pct(rec, lambda n: any(k in n for k in K3_NAMES),
                        lambda: rec.workload.k3_bytes_per_frame())
