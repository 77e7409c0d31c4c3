"""encode.idle_share: the share of the profiled stretch in which no kernel,
copy or set ran on the device (a frozen copy of chip_smoke.py's
window_report arithmetic, harness/profiling.py), in %."""
from gpubench.harness.readers import idle_pct


def read(rec, metric):
    return idle_pct(rec)
