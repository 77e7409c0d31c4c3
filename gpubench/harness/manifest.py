"""One cell of BENCHMARK.json and the files that belong to it, found by
name: ``configs`` entries name their file, a cell's traffic is
``traffic/<traffic>.json``, a metric's reader is ``metrics/<name>.py``
(see metrics.py)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]   # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name``; ValueError if BENCHMARK.json has none."""
    m = load(root)
    work = {w['name']: w for w in m['workloads']}
    if name not in work:
        raise ValueError(f'no workload {name!r} in BENCHMARK.json '
                         f'(it has {sorted(work)})')
    w = work[name]
    return pair(w['config'], w['traffic'], int(w['chips']), root, m, name)


def pair(config: str, traffic: str, chips: int = 1, root: str = ROOT,
         m: dict = None, name: str = None) -> Cell:
    """Configuration ``config`` (a BENCHMARK.json entry) under the mix
    ``traffic/<traffic>.json``, named ``<config>.<traffic>`` unless
    ``name`` is given, whether or not BENCHMARK.json lists it as a cell
    (a mix kept for a later cell, say): it then reports no metric."""
    m = m or load(root)
    name = name or f'{config}.{traffic}'
    conf = {c['name']: c for c in m['configs']}[config]
    with open(os.path.join(root, conf['file'])) as f:
        config_data = json.load(f)
    with open(os.path.join(BENCH_DIR, 'traffic', traffic + '.json')) as f:
        traffic_data = json.load(f)
    listed = any(w['name'] == name for w in m['workloads'])
    return Cell(name=name, chips=chips, config=config_data,
                traffic=traffic_data,
                end_to_end=[e for e in m['end_to_end']
                            if listed and _reports(e, name)],
                per_layer=[e for e in m['per_layer']
                           if listed and _reports(e, name)])
