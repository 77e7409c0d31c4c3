"""CPU tests of the benchmark: ``python -m pytest gpubench/tests -q``.
Tests that need the card are marked ``cuda`` and skip inside the test
where there is none."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
