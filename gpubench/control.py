"""The correctness check's control, at a cell's own size: for each seed,
the cell's inputs as a run makes them, the control (reference/control.py:
the reference with one precision or guarantee broken) put in the
program's place for every burst of the ring, and the run's comparison
against the reference.  Prints one JSON line a seed with each number,
its limit, and whether the run would be correct (it must not be).  It
runs on the host alone (no GPU); the benchmark's runs do not run it.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(cell, seed: int) -> dict:
    """The numbers a run would compare, with the control as the
    program."""
    from gpubench.inputs.streams import ring_inputs
    from gpubench.loops.closed import bursts_of
    from gpubench.reference import compare, control
    cfg, trf = cell.config, cell.traffic
    direction = trf['direction']
    ring = ring_inputs(cfg, seed, trf['ring'], direction)
    answer = compare.expected_fn(direction, cfg, ring, control)
    kept = [(slots, [answer(s) for s in slots]) for slots in bursts_of(trf)]
    expected = compare.expected_fn(direction, cfg, ring)
    return compare.check(direction, cfg['limits'][direction], expected,
                         kept, failed=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    from gpubench.harness import manifest
    from gpubench.harness.result import checks_pass
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_numbers(cell, seed)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'control_correct': checks_pass(checks),
                          'seconds': time.perf_counter() - t0,
                          'checks': checks}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
