"""The control (the reference with one precision or guarantee broken,
reference/control.py) put in the program's place fails the check of
each cell, here at a small size; gpubench/control.py runs it at a
cell's own size."""
import pytest

from gpubench import control
from gpubench.harness import manifest
from gpubench.harness.result import checks_pass

# every cell of BENCHMARK.json, and the two encode cells whose mixes are
# kept for their return (PERF.md)
CELLS = sorted({f"{w['config']}.{w['traffic']}"
                for w in manifest.load()['workloads']}
               | {'gray8_2k_rev53.encode_stream',
                  'rgb8_2k_97ict.encode_frame'})


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name):
    c = manifest.pair(*name.split('.'))
    c.config = dict(c.config, width=256, height=128, num_decomps=3)
    c.traffic = dict(c.traffic, ring=2 * c.traffic['burst'])
    for seed in (1, 2**31 + 5, 98765432109):
        checks = control.control_numbers(c, seed)
        assert not checks_pass(checks), checks
        key = ('mismatch_share' if c.traffic['direction'] == 'decode'
               else 'coef_mismatch_share')
        assert checks[key]['value'] > checks[key]['limit']
