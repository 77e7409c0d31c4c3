"""The run's last line on standard output (one JSON object) and the
check lines that end standard error."""
from __future__ import annotations

import json
from typing import Dict, List, Optional


def checks_pass(checks: Dict[str, dict]) -> bool:
    return all(c['value'] <= c['limit'] for c in checks.values())


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """One line a compared number: its value beside its limit."""
    return [f'check {name}: {c["value"]!r} limit {c["limit"]!r} '
            f'{"ok" if c["value"] <= c["limit"] else "FAIL"}'
            for name, c in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Dict[str, dict],
                breakdown: Optional[dict] = None,
                notes: Optional[dict] = None) -> str:
    """The contract's keys, then ``breakdown`` (traced runs), ``notes``
    (what a metric's number rests on, e.g. a roofline's bytes and the
    card's power limit) and, last, the compared numbers beside their
    limits."""
    obj = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        obj['breakdown'] = breakdown
    if notes:
        obj['notes'] = notes
    obj['checks'] = {k: {'value': v['value'], 'limit': v['limit']}
                     for k, v in checks.items()}
    return json.dumps(obj, allow_nan=False)
