"""decode.k2_roofline: the HT cleanup decode kernel K2 (raw readers;
openjph_tpu_torch/gpu/csrc/ht_cleanup_decode.cu) as a share of its
roofline: the least time at 3.35 TB/s for the workload's bytes
(roofline.k2_bytes: segments read, 4 bytes written a sample) over K2's
device time, per frame, in the profiled stretch."""
from gpubench.harness.readers import roofline_pct

# K2's names in the device trace: the raw-reader instantiations
K2_NAMES = ('ojk::ht_cleanup_kernel<true, 32>',
            'ojk::ht_cleanup_kernel<true, 64>')


def read(rec, metric):
    return roofline_pct(rec, lambda n: any(k in n for k in K2_NAMES),
                        lambda: rec.workload.k2_bytes_per_frame())
