"""BENCHMARK.json against the benchmark's contract and its own files."""
import json
import os
import re

import pytest

from gpubench.harness import manifest, metrics

ROOT = manifest.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


@pytest.fixture(scope='module')
def bench():
    path = os.path.join(ROOT, 'BENCHMARK.json')
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
    assert 1 <= len(bench['command']) <= 32
    assert all(_line(w) for w in bench['command'])
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51


def test_run_seconds_fit_a_full_check(bench):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s
    spare, within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (bench['run_seconds'] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries(bench):
    names = []
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) \
            and _line(c['why'])
        assert all(NAME.match(k) for k in c['reduced'])
        assert len(c['reduced']) <= 16
        names.append(c['name'])
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['config']) \
            and NAME.match(w['traffic'])
        assert _line(w['why'])
        assert w['chips'] == 1
        names.append(w['name'])
    for kind in ('end_to_end', 'per_layer'):
        for m in bench[kind]:
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
            names.append(m['name'])
    assert len(names) == len(set(names))
    assert len({(w['config'], w['traffic'])
                for w in bench['workloads']}) == len(bench['workloads'])


def test_every_config_has_a_cell_and_a_file(bench):
    used = {w['config'] for w in bench['workloads']}
    files = set()
    for c in bench['configs']:
        assert c['name'] in used
        assert c['file'].startswith(tuple(p + '/' for p in bench['paths']))
        assert c['file'] not in files
        files.add(c['file'])
        with open(os.path.join(ROOT, c['file'])) as f:
            conf = json.load(f)
        assert conf['name'] == c['name'] and conf['source'] == c['source']
        assert conf['reduced'] == c['reduced']
        assert set(conf['limits']) == {'decode', 'encode'}


def test_end_to_end(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
    for m in e2e.values():
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25


def test_per_layer_moves_what_its_cells_report(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer'])
        moved = e2e[m['moves']]
        for cell in m.get('workloads', sorted(cells)):
            assert cell in cells
            assert 'workloads' not in moved or cell in moved['workloads']
        if m['name'].endswith('_roofline') or '_roofline.' in m['name']:
            assert m['unit'] == '%'


def test_every_cell_reports_enough(bench):
    for w in bench['workloads']:
        cell = manifest.cell(w['name'])
        assert [m['name'] for m in cell.end_to_end if
                m['name'] != 'setup_s']
        assert any(m['name'] == 'setup_s' for m in cell.end_to_end)
        assert cell.per_layer
        assert cell.traffic['direction'] in ('decode', 'encode')


def test_every_metric_has_a_reader(bench):
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(metrics.reader(m['name']))


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench['paths']:
        for dirpath, _, files in os.walk(os.path.join(ROOT, p)):
            if '__pycache__' in dirpath:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
