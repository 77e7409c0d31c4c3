"""Metric readers, one file each: ``metrics/<name>.py`` defines
``read(rec, metric) -> float | None``, which takes the metric from the
run's record (``cell.Record``) and returns None where it finds nothing
to read; the harness then leaves the metric out of the result line.
Where no file carries the whole name, the name without its last dotted
part is tried, so that ``decode.host_prep_ms.stream`` and
``decode.host_prep_ms.frame`` share ``metrics/decode.host_prep_ms.py``
(the suffix names the traffic and the end-to-end metric it moves)."""
from __future__ import annotations

import importlib.util
import math
import os
from typing import Callable, Dict, List

from .manifest import BENCH_DIR

_READERS: Dict[str, Callable] = {}


def reader_path(name: str) -> str:
    """The file that reads metric ``name``; FileNotFoundError if none."""
    for cand in (name, name.rsplit('.', 1)[0]):
        path = os.path.join(BENCH_DIR, 'metrics', cand + '.py')
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f'no reader for metric {name!r} under '
                            f'{os.path.join(BENCH_DIR, "metrics")}')


def reader(name: str) -> Callable:
    path = reader_path(name)
    if path not in _READERS:
        mod_name = 'gpubench_metric_' + os.path.basename(path)[:-3] \
            .replace('.', '_')
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[path] = mod.read
    return _READERS[path]


def compute(entries: List[dict], rec) -> dict:
    """{name: {'value', 'unit'}} of every entry whose reader finds a
    finite number."""
    out = {}
    for e in entries:
        v = reader(e['name'])(rec, e)
        if v is None:
            continue
        v = float(v)
        if math.isfinite(v):
            out[e['name']] = {'value': v, 'unit': e['unit']}
    return out
