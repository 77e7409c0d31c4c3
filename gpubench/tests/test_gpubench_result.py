"""The result line, the check lines and the import guard."""
import json
import math

import pytest

from gpubench.harness import guard
from gpubench.harness.result import check_lines, checks_pass, result_line

CHECKS = {'max_abs_err': {'value': 1, 'limit': 1},
          'mismatch_share': {'value': 2.5e-05, 'limit': 0.001}}


def test_result_line_keys_and_checks_last():
    line = result_line(True, 40, 0, {'decode_mpix_s': {
        'value': 612.123456789012, 'unit': 'MP/s'}},
        {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1,
         'memory_peak_bytes': 123}, CHECKS,
        breakdown={'device_ops': [['k', 0.5]], 'idle_gaps': []},
        notes={'power_limit_w': 700.0})
    obj = json.loads(line)
    assert list(obj) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'notes', 'checks']
    assert obj['metrics']['decode_mpix_s']['value'] == 612.123456789012
    assert obj['checks'] == CHECKS
    assert '\n' not in line


def test_result_line_refuses_nan():
    with pytest.raises(ValueError):
        result_line(True, 1, 0, {'x': {'value': math.nan, 'unit': 'ms'}},
                    {}, CHECKS)


def test_check_lines_and_pass():
    assert check_lines(CHECKS) == [
        'check max_abs_err: 1 limit 1 ok',
        'check mismatch_share: 2.5e-05 limit 0.001 ok']
    assert checks_pass(CHECKS)
    bad = dict(CHECKS, frames_missing={'value': 4, 'limit': 0})
    assert not checks_pass(bad)
    assert check_lines(bad)[-1].endswith('FAIL')


def test_guard_compares_whole_top_level_names():
    names = ['openjph_tpu_torch', 'openjph_tpu_torch.gpu.pipeline',
             'jaxtyping', 'numpy', 'jax', 'jax.numpy', 'jaxlib.xla_client',
             'flax', 'openjph_tpu', 'openjph_tpu.codec']
    assert guard.banned_in(names) == sorted(
        ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax', 'openjph_tpu',
         'openjph_tpu.codec'])
    assert guard.loaded_banned({'numpy': None, 'torch': None}) == []
