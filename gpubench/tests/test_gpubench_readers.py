"""The profiled stretch's parsing (a frozen copy of chip_smoke.py's
window arithmetic) and the metric readers, on a constructed trace and
record."""
import gzip
import json

import pytest

from gpubench.harness import metrics, profiling
from gpubench.harness.cell import Record
from gpubench.loops.closed import LoopRecord


def _trace(tmp_path):
    ev = [{'name': 'window', 'ph': 'X', 'cat': 'user_annotation',
           'ts': 1000.0, 'dur': 10000.0, 'tid': 1},
          # K2 4 ms (2 clipped off by the window's start), rest 1 ms,
          # a copy 1 ms; busy 1000..4000 and 6000..8000
          {'name': 'void ojk::ht_cleanup_kernel<true, 32>(ojk::Args)',
           'ph': 'X', 'cat': 'kernel', 'ts': 0.0, 'dur': 3000.0},
          {'name': 'void at::native::add_kernel', 'ph': 'X',
           'cat': 'kernel', 'ts': 3000.0, 'dur': 1000.0},
          {'name': 'Memcpy HtoD (Pinned -> Device)', 'ph': 'X',
           'cat': 'gpu_memcpy', 'ts': 6000.0, 'dur': 1000.0},
          {'name': 'void ojk::ht_cleanup_kernel<true, 32>(ojk::Args)',
           'ph': 'X', 'cat': 'kernel', 'ts': 7000.0, 'dur': 1000.0},
          {'name': 'decode.host_prep', 'ph': 'X', 'cat': 'user_annotation',
           'ts': 3500.0, 'dur': 3000.0, 'tid': 2},
          {'name': 'aten::copy_', 'ph': 'X', 'cat': 'cpu_op',
           'ts': 3900.0, 'dur': 500.0, 'tid': 3}]
    path = tmp_path / 't.json.gz'
    with gzip.open(path, 'wt') as f:
        json.dump({'traceEvents': ev}, f)
    return str(path)


def test_window_report(tmp_path):
    w = profiling.window_report(_trace(tmp_path), frames=4)
    assert w.span_s == pytest.approx(0.010)
    assert w.busy_s == pytest.approx(0.005)
    assert w.seconds(lambda n: 'ojk::' in n) == pytest.approx(0.003)
    assert w.seconds(lambda n: True, ('gpu_memcpy',)) == pytest.approx(
        0.001)
    assert w.top_ops[0][0].startswith('void ojk::')
    # gaps: 8000..11000 (3 ms), 4000..6000 (2 ms)
    assert [g for _, g in w.idle_gaps] == pytest.approx([0.003, 0.002])
    assert w.idle_gaps[1][0] == 'decode.host_prep | aten::copy_'


class _Workload:
    def k2_bytes_per_frame(self):
        return 3.35e12 * 1e-4     # a least time of 0.1 ms a frame


def test_readers(tmp_path):
    loop = LoopRecord(window_s=2.0, frames=100,
                      latencies_s=[i / 1000 for i in range(1, 101)])
    rec = Record(config={}, traffic={'burst': 8}, seconds=2.0, setup_s=9.5,
                 loop=loop, mpix=2.2,
                 stages={'decode.host_prep': {'seconds': 1.6, 'calls': 25,
                                              'ms_per_call': 64.0}},
                 window=profiling.window_report(_trace(tmp_path), frames=4),
                 workload=_Workload())

    def read(name):
        return metrics.reader(name)(rec, {'name': name})

    assert read('decode_mpix_s') == pytest.approx(110.0)
    assert read('decode_frame_p95_ms') == pytest.approx(95.05)
    assert read('setup_s') == 9.5
    assert read('decode.host_prep_ms.stream') == pytest.approx(8.0)
    assert read('decode.dispatch_ms.stream') is None
    # K2: 3 ms over 4 frames; least 0.1 ms a frame
    assert read('decode.k2_roofline.stream') == pytest.approx(
        100 * 0.1 / 0.75)
    assert read('decode.rest_device_ms.frame') == pytest.approx(0.25)
    assert read('decode.idle_share.stream') == pytest.approx(50.0)
    assert read('encode.k3_roofline.stream') is None
    assert metrics.reader_path('decode.k2_roofline.frame').endswith(
        'decode.k2_roofline.py')
    with pytest.raises(FileNotFoundError):
        metrics.reader_path('no_such_metric')
